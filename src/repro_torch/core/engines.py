"""Server engines (PyTorch port of ``repro/core/engines.py``): WHAT the
server does with an aggregate.  The port has the ``fused_flat`` engine —
clip + optimizer + parameter write in one CUDA sweep per dtype group
(``kernels/fused_update``) — and ``buffered_async``, which applies each
flush of the buffered-async delta pool through the same sweep
(``core/async_round.py``).  ``legacy_tree`` (the kernel-free tree-map
oracle) is ROADMAP Queue 1 item 9."""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from repro_torch.core.executors import FlatAggregate
from repro_torch.core.flat import make_flat_spec
from repro_torch.core.registry import Registry
from repro_torch.kernels.fused_update.ops import (flat_apply_groups,
                                                  fused_apply_flat,
                                                  init_flat_opt_state)

__all__ = ["ServerEngine", "FusedFlatEngine", "BufferedAsyncEngine",
           "register_engine", "get_engine", "resolve_engine"]


class ServerEngine:
    """Protocol: ``init_state(params)`` and ``apply(params, handle,
    opt_state, lr=) -> (new_params, new_opt_state, grad_norm_after_clip)``.
    ``meta_capabilities`` names the FedMeta modes the engine supports;
    ``through_aggregation`` needs ``apply`` differentiable in the handle's
    weights and in ``lr``.  ``codec_capabilities`` names the uplink codecs
    it consumes: ``lossy`` needs it to take the decoded flat buffers.
    ``is_async`` makes the round builder run the buffered-async tick
    instead of the synchronous round."""
    name: str = "?"
    is_async: bool = False
    meta_capabilities: frozenset = frozenset({"post"})
    codec_capabilities: frozenset = frozenset({"none"})

    def init_state(self, params):
        raise NotImplementedError

    def apply(self, params, handle, opt_state, *, lr) -> Tuple:
        raise NotImplementedError


_ENGINES = Registry("server engine",
                    "repro_torch.core.engines.register_engine")


def register_engine(name: str):
    def deco(factory: Callable) -> Callable:
        _ENGINES.register(name, factory)
        return factory
    return deco


def get_engine(name: str) -> Callable:
    return _ENGINES.get(name)


def resolve_engine(fed) -> ServerEngine:
    """``fed.engine``, else ``fused_flat`` (FedConfig refuses the unported
    ``legacy_tree``)."""
    return get_engine(fed.engine or "fused_flat")(fed)


@register_engine("fused_flat")
class FusedFlatEngine(ServerEngine):
    """Flat-buffer engine: clip + sgd/sgdm/adam/yogi + param write in one
    update-kernel sweep per dtype group, differentiable through the
    backward kernels — so it declares ``through_aggregation``; it consumes
    flat buffers, so lossy codecs' decoded aggregates too."""
    name = "fused_flat"
    meta_capabilities = frozenset({"post", "through_aggregation"})
    codec_capabilities = frozenset({"none", "lossy"})

    def __init__(self, fed):
        self._opt = fed.server_opt
        self._clip = fed.clip_norm
        self._momentum = fed.server_momentum

    def init_state(self, params):
        device = next(iter(params.values())).device
        return init_flat_opt_state(self._opt, make_flat_spec(params), device)

    def apply(self, params, handle: FlatAggregate, opt_state, *, lr):
        if not isinstance(handle, FlatAggregate):
            raise TypeError(f"fused_flat consumes a FlatAggregate, got "
                            f"{type(handle).__name__}")
        kw = dict(opt=self._opt, lr=lr, clip_norm=self._clip,
                  momentum=self._momentum)
        if handle.sq_norm is None:          # scan cohort: no pass-1 ssq
            return fused_apply_flat(params, handle.groups, opt_state,
                                    spec=handle.spec, **kw)
        return flat_apply_groups(handle.spec, handle.groups,
                                 torch.sqrt(handle.sq_norm), params,
                                 opt_state, **kw)


@register_engine("buffered_async")
class BufferedAsyncEngine(FusedFlatEngine):
    """Buffered-asynchronous server engine (FedBuff-style).  Each flush's
    apply — the staleness-weighted mean already streamed into flat
    buffers, then clip, optimizer and parameter write — is
    :class:`FusedFlatEngine`'s; ``is_async`` changes the round's shape:
    the round builder runs the tick of :mod:`repro_torch.core.async_round`
    with its delta pool (``state["async"]``).  ``meta_mode='post'`` only:
    whether a tick flushes depends on its arrivals, so there is no fixed
    aggregation for a hypergradient to flow through."""
    name = "buffered_async"
    is_async = True
    meta_capabilities = frozenset({"post"})
    codec_capabilities = frozenset({"none", "lossy"})
