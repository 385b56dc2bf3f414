"""Cohort executors (PyTorch port of the flat forward arms of
``repro/core/executors.py``): HOW a round runs its cohort.  Each yields the
uniform :class:`FlatAggregate` handle the fused engine consumes.

  * ``vmap`` — every client's flat gradient in a ``(cohort, rows, 128)``
    stack, reduced by the aggregate kernel, which also gives ||G||^2;
  * ``scan`` — one client alive at a time, streamed into the accumulators
    by the accumulate kernel.

The ``chunked`` and ``sharded`` executors, the tree handle of the
``legacy_tree`` engine and the reweightable forms of
``meta_mode='through_aggregation'`` are ROADMAP Queue 1 item 1 and 7.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Tuple

import torch

from repro_torch.core.aggregate import (cohort_gradient_stacked,
                                        scan_cohort_gradient_flat)
from repro_torch.core.flat import FlatSpec, make_flat_spec
from repro_torch.core.registry import Registry
from repro_torch.kernels.fused_update.ops import flat_weighted_aggregate

__all__ = ["FlatAggregate", "CohortExecutor", "register_executor",
           "get_executor", "resolve_executor"]


@dataclasses.dataclass
class FlatAggregate:
    """Eq. (14) weighted mean in the fused engine's flat layout."""
    groups: List[torch.Tensor]         # per-dtype-group (rows, 128) fp32
    spec: FlatSpec
    sq_norm: Optional[torch.Tensor] = None   # ||G||^2 if pass 1 reduced it


class CohortExecutor:
    """Protocol.  Subclass and register a factory ``factory(fed)``."""
    name: str = "?"

    def run(self, client_update: Callable, params, cohort_batch,
            client_weights: torch.Tensor, lr
            ) -> Tuple[FlatAggregate, torch.Tensor]:
        """Run every client and aggregate; returns (handle, client_loss)."""
        raise NotImplementedError


_EXECUTORS = Registry("cohort executor",
                      "repro_torch.core.executors.register_executor")


def register_executor(name: str):
    def deco(factory: Callable) -> Callable:
        _EXECUTORS.register(name, factory)
        return factory
    return deco


def get_executor(name: str) -> Callable:
    return _EXECUTORS.get(name)


def resolve_executor(fed) -> CohortExecutor:
    return get_executor(fed.cohort_strategy)(fed)


@register_executor("vmap")
class VmapExecutor(CohortExecutor):
    """Client-parallel: the whole cohort's gradients stacked, then one
    aggregate-kernel sweep that also reduces ||G||^2 for the clip."""
    name = "vmap"

    def __init__(self, fed: Any):
        del fed

    def run(self, client_update, params, cohort_batch, client_weights, lr):
        spec = make_flat_spec(params)
        stacks, loss = cohort_gradient_stacked(
            client_update, params, cohort_batch, client_weights, lr,
            spec=spec)
        Gs, ssq = flat_weighted_aggregate(spec, stacks, client_weights)
        return FlatAggregate(Gs, spec, sq_norm=ssq), loss


@register_executor("scan")
class ScanExecutor(CohortExecutor):
    """Client-sequential: one trajectory alive at a time, each client's
    flat gradient streamed into the accumulators (chunk = 1)."""
    name = "scan"

    def __init__(self, fed: Any):
        del fed

    def run(self, client_update, params, cohort_batch, client_weights, lr):
        spec = make_flat_spec(params)
        Gs, loss = scan_cohort_gradient_flat(
            client_update, params, cohort_batch, client_weights, lr,
            spec=spec)
        return FlatAggregate(Gs, spec, sq_norm=None), loss
