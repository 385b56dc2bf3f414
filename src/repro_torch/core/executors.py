"""Cohort executors (PyTorch port of the flat forward arms of
``repro/core/executors.py``): HOW a round runs its cohort.  Each yields the
uniform :class:`FlatAggregate` handle the fused engine consumes.

  * ``vmap`` — every client's flat gradient in a ``(cohort, rows, 128)``
    stack, reduced by the aggregate kernel, which also gives ||G||^2;
  * ``scan`` — one client alive at a time, streamed into the accumulators
    by the accumulate kernel.

Both run a lossy uplink codec too (``run_coded``, ``codec_capabilities``
``{"none", "lossy"}``): vmap fills its stack and runs each client's
encode/decode over it in cohort order (no aggregate kernel), scan streams
each client through the codec as its gradient arrives (no accumulate
kernel); the decode is the accumulation.

Both also give a :class:`ReweightableCohort` (``reweightable()``), the
differentiable form ``meta_mode='through_aggregation'`` takes its
hypergradients through: vmap runs the clients once and keeps the stack;
scan keeps nothing and re-streams the clients under the new weights.

``buffered_async`` is the buffered-async runtime's cohort stage: it runs
the clients on a vmap or scan base and hands each client's flat delta to
the delta pool instead of aggregating (``run_deltas``,
``run_deltas_coded``).

Every method takes ``rngs``, the cohort's per-slot dropout masks, or
None (:mod:`repro_torch.core.dropout`).

The ``chunked`` and ``sharded`` executors and the tree handle of the
``legacy_tree`` engine are ROADMAP Queue 1 items 9 and 7.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Tuple

import torch

from repro_torch.comm.transport import (client_coded_decode,
                                        coded_decode_stacked)
from repro_torch.core.aggregate import (cohort_gradient_stacked,
                                        cohort_gradient_stacked_coded,
                                        scan_cohort_deltas_flat,
                                        scan_cohort_gradient_coded,
                                        scan_cohort_gradient_flat)
from repro_torch.core.flat import FlatSpec, make_flat_spec
from repro_torch.core.registry import Registry
from repro_torch.kernels.fused_update.ops import flat_weighted_aggregate

__all__ = ["FlatAggregate", "ReweightableCohort", "CohortExecutor",
           "BufferedAsyncExecutor", "register_executor", "get_executor",
           "resolve_executor"]


@dataclasses.dataclass
class FlatAggregate:
    """Eq. (14) weighted mean in the fused engine's flat layout."""
    groups: List[torch.Tensor]         # per-dtype-group (rows, 128) fp32
    spec: FlatSpec
    sq_norm: Optional[torch.Tensor] = None   # ||G||^2 if pass 1 reduced it


@dataclasses.dataclass
class ReweightableCohort:
    """A cohort whose aggregation can be re-run under other weights.

    ``aggregate(weights)`` is differentiable w.r.t. ``weights`` and returns
    ``(handle, client_loss)``; the loss is weighted by the raw n_k the
    cohort was made with, so it reports the same number whatever weights
    the controllable state chose."""
    aggregate: Callable      # (weights,) -> (handle, client_loss)


class CohortExecutor:
    """Protocol.  Subclass and register a factory ``factory(fed)``."""
    name: str = "?"
    supports_reweight: bool = False
    # the codecs this executor runs: {"none"} is the plain path only;
    # {"none", "lossy"} adds run_coded, a per-client uplink (repro_torch.comm)
    codec_capabilities: frozenset = frozenset({"none"})
    # the coded cohort run_coded streams through: (client_update, params,
    # cohort_batch, client_weights, lr, *, spec, codec, residuals, rngs) ->
    # (G_groups, client_loss, residuals)
    coded_cohort: Optional[Callable] = None

    def run(self, client_update: Callable, params, cohort_batch,
            client_weights: torch.Tensor, lr, rngs=None
            ) -> Tuple[FlatAggregate, torch.Tensor]:
        """Run every client and aggregate; returns (handle, client_loss).
        By default the reweightable form aggregated under the n_k."""
        return self.reweightable(client_update, params, cohort_batch,
                                 client_weights, lr, rngs
                                 ).aggregate(client_weights)

    def run_coded(self, client_update: Callable, params, cohort_batch,
                  client_weights: torch.Tensor, lr, *, codec, comm,
                  rngs=None
                  ) -> Tuple[FlatAggregate, torch.Tensor, Optional[dict]]:
        """Run every client, pass each gradient through ``codec``'s encode
        and decode (the uplink) and aggregate the decoded gradients.
        ``comm`` is the error-feedback state (``state["comm"]``, updated in
        place) or None.  Returns (handle, client_loss, new_comm)."""
        if "lossy" not in self.codec_capabilities:
            raise NotImplementedError(
                f"cohort executor {self.name!r} does not support lossy "
                "gradient codecs (declares codec_capabilities="
                f"{sorted(self.codec_capabilities)})")
        spec = make_flat_spec(params)
        Gs, loss, res = self.coded_cohort(
            client_update, params, cohort_batch, client_weights, lr,
            spec=spec, codec=codec,
            residuals=None if comm is None else comm["residual"], rngs=rngs)
        return (FlatAggregate(Gs, spec, sq_norm=None), loss,
                None if comm is None else {"residual": res})

    def reweightable(self, client_update: Callable, params, cohort_batch,
                     client_weights: torch.Tensor, lr, rngs=None
                     ) -> ReweightableCohort:
        """Run (or prepare) the cohort so its aggregation can be repeated
        under other weights; ``client_weights`` (n_k) weight the loss."""
        raise NotImplementedError(
            f"cohort executor {self.name!r} has no reweightable form")


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
    supports_reweight = True
    codec_capabilities = frozenset({"none", "lossy"})
    coded_cohort = staticmethod(cohort_gradient_stacked_coded)

    def __init__(self, fed: Any):
        del fed

    def reweightable(self, client_update, params, cohort_batch,
                     client_weights, lr, rngs=None):
        # the clients run once here (the loss is already n_k-weighted);
        # aggregate() only re-reduces the kept stack under new weights,
        # differentiably through the aggregate kernel's backward
        spec = make_flat_spec(params)
        stacks, loss = cohort_gradient_stacked(
            client_update, params, cohort_batch, client_weights, lr,
            spec=spec, rngs=rngs)

        def aggregate(weights):
            Gs, ssq = flat_weighted_aggregate(spec, stacks, weights)
            return FlatAggregate(Gs, spec, sq_norm=ssq), loss

        return ReweightableCohort(aggregate=aggregate)


@register_executor("scan")
class ScanExecutor(CohortExecutor):
    """Client-sequential: one trajectory alive at a time, each client's
    flat gradient streamed into the accumulators (chunk = 1)."""
    name = "scan"
    supports_reweight = True
    codec_capabilities = frozenset({"none", "lossy"})
    coded_cohort = staticmethod(scan_cohort_gradient_coded)

    def __init__(self, fed: Any):
        del fed

    def reweightable(self, client_update, params, cohort_batch,
                     client_weights, lr, rngs=None):
        # nothing is kept: each aggregate() re-streams the clients, and its
        # backward re-runs them once more (scan_cohort_gradient_flat)
        spec = make_flat_spec(params)

        def aggregate(weights):
            Gs, loss = scan_cohort_gradient_flat(
                client_update, params, cohort_batch, weights, lr, spec=spec,
                loss_weights=client_weights, rngs=rngs)
            return FlatAggregate(Gs, spec, sq_norm=None), loss

        return ReweightableCohort(aggregate=aggregate)


@register_executor("buffered_async")
class BufferedAsyncExecutor(CohortExecutor):
    """The buffered-async runtime's cohort stage: the local updates run on
    the base strategy ``fed.cohort_strategy`` (vmap or scan), and each
    client's flat delta goes to the delta pool
    (:mod:`repro_torch.core.async_round`) instead of into an aggregate.
    Not a synchronous executor: :meth:`run` raises.

    ``out(k)`` names where client k's delta goes: per-group ``(rows, 128)``
    buffers (a pool slot), or None for a delta the pool does not keep.
    The vmap base fills its ``(cohort, rows, 128)`` stack as the
    synchronous vmap cohort does and copies each kept delta into its
    slot; the scan base writes each delta straight into its slot as the
    client finishes."""
    name = "buffered_async"
    supports_reweight = False
    codec_capabilities = frozenset({"none", "lossy"})

    def __init__(self, fed: Any, *, grad_shardings=None):
        if grad_shardings is not None:
            raise ValueError(
                "the buffered_async executor keeps a replicated delta pool "
                "(per-client staleness slots), so per-leaf grad_shardings "
                "cannot apply; drop grad_shardings or use a synchronous "
                "engine")
        if getattr(fed, "cohort_chunk", None) is not None:
            raise ValueError(
                "cohort_chunk streams clients through an aggregate "
                "accumulator, but the buffered_async executor must keep "
                "every client's delta individually for the staleness pool "
                "— there is nothing to chunk. Drop cohort_chunk or use a "
                "synchronous engine.")
        if fed.cohort_strategy not in ("vmap", "scan"):
            raise ValueError(
                "the buffered_async executor wraps a base cohort_strategy "
                f"of 'vmap' or 'scan', got {fed.cohort_strategy!r}")
        self._base = fed.cohort_strategy

    def run(self, *args, **kwargs):
        raise NotImplementedError(
            "the buffered_async executor produces per-client deltas for the "
            "async tick (repro_torch.core.async_round), not a synchronous "
            "aggregate; select engine='buffered_async' so the round "
            "builder routes through it")

    def run_deltas(self, client_update, params, cohort_batch,
                   client_weights, lr, *, spec, out: Callable, rngs=None
                   ) -> torch.Tensor:
        """Run every client, each delta to ``out(k)``; returns the client
        loss weighted by ``client_weights`` (aggregation weights are the
        pool's, at flush time)."""
        if self._base == "scan":
            return scan_cohort_deltas_flat(
                client_update, params, cohort_batch, client_weights, lr,
                spec=spec, out=out, rngs=rngs)
        stacks, loss = cohort_gradient_stacked(
            client_update, params, cohort_batch, client_weights, lr,
            spec=spec, rngs=rngs)
        _deliver(stacks, out)
        return loss

    def run_deltas_coded(self, client_update, params, cohort_batch,
                         client_weights, lr, *, spec, codec, comm,
                         out: Callable, rngs=None
                         ) -> Tuple[torch.Tensor, Optional[dict]]:
        """:meth:`run_deltas` with the lossy uplink: each delta is encoded
        (against its ``state["comm"]`` residual, updated in place) and
        decoded before it is pooled — the pool keeps what the server
        received.  Returns (client loss, new comm state)."""
        res = None if comm is None else comm["residual"]
        new_comm = None if comm is None else {"residual": tuple(res)}
        if self._base == "vmap":
            stacks, loss = cohort_gradient_stacked(
                client_update, params, cohort_batch, client_weights, lr,
                spec=spec, rngs=rngs)
            coded_decode_stacked(codec, spec, stacks, client_weights, res)
            _deliver(stacks, out)
            return loss, new_comm
        w32 = client_weights.to(torch.float32)

        def finish(k, bufs):
            client_coded_decode(codec, spec, bufs, w32[k],
                                None if res is None else [r[k] for r in res])

        loss = scan_cohort_deltas_flat(
            client_update, params, cohort_batch, client_weights, lr,
            spec=spec, out=out, finish=finish, rngs=rngs)
        return loss, new_comm


def _deliver(stacks, out: Callable) -> None:
    """Copy client k's slot of the ``(cohort, rows, 128)`` stacks into
    ``out(k)`` where the pool keeps it."""
    for k in range(stacks[0].shape[0]):
        dest = out(k)
        if dest is not None:
            for d, st in zip(dest, stacks):
                d.copy_(st[k])
