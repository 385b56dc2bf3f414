"""Server-engine registry (PyTorch port of ``repro/core/engines.py``):
WHAT the server does with an aggregate.

An engine declares the aggregate-handle kinds it consumes (``accepts``,
``preferred`` first), so the round asks the cohort executor for a kind
both share, and the FedMeta modes (``meta_capabilities``) and uplink
codecs (``codec_capabilities``) it supports.  Built-ins:

  * ``legacy_tree`` — the tree-map stages with no kernel (the weighted
    mean as a dict of tensors -> clip-norm scale -> fp32 cast ->
    :func:`repro_torch.core.server_opt.apply`), the fused engine's
    oracle; ``meta_mode='post'`` and ``codec='none'`` only;
  * ``fused_flat`` — clip + optimizer + parameter write in one CUDA sweep
    per dtype group (``kernels/fused_update``), differentiable through the
    backward kernels;
  * ``buffered_async`` — applies each flush of the buffered-async delta
    pool through the same sweep (``core/async_round.py``).

Register others with :func:`register_engine` and select them by name
(``FedConfig.engine``, ``make_federated_round(..., engine=)``).
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from repro_torch.core import server_opt
from repro_torch.core.executors import FlatAggregate, TreeAggregate
from repro_torch.core.flat import leaf_order, make_flat_spec
from repro_torch.core.registry import Registry
from repro_torch.kernels.fused_update.ops import (flat_apply_groups,
                                                  fused_apply_flat,
                                                  fused_server_update,
                                                  init_flat_opt_state)

__all__ = ["ServerEngine", "LegacyTreeEngine", "FusedFlatEngine",
           "BufferedAsyncEngine", "register_engine", "get_engine",
           "available_engines", "resolve_engine", "tree_global_norm"]


def tree_global_norm(g) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares, in fp32, the leaves
    summed in the JAX tree's order."""
    return torch.sqrt(sum(torch.sum(torch.square(g[k].to(torch.float32)))
                          for k in leaf_order(g)))


class ServerEngine:
    """Protocol: ``init_state(params)`` and ``apply(params, handle,
    opt_state, lr=) -> (new_params, new_opt_state, grad_norm_after_clip)``.
    ``meta_capabilities`` names the FedMeta modes the engine supports;
    ``through_aggregation`` needs ``apply`` differentiable in the handle's
    weights and in ``lr``.  ``codec_capabilities`` names the uplink codecs
    it consumes: ``lossy`` needs it to take the decoded flat buffers.
    ``is_async`` makes the round builder run the buffered-async tick
    instead of the synchronous round.  ``accepts`` names the handle kinds
    ``apply`` consumes (``"flat"``, ``"tree"``), ``preferred`` the one the
    round asks the executor for when it can produce it."""
    name: str = "?"
    accepts: frozenset = frozenset()
    preferred: str = "tree"
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


def available_engines() -> tuple:
    return _ENGINES.names()


def resolve_engine(fed, *, engine: Optional[str] = None) -> ServerEngine:
    """An explicit registry name wins, then ``fed.engine``, then
    ``fed.fused_update`` selects fused_flat / legacy_tree."""
    if engine is None:
        engine = fed.engine
    if engine is None:
        engine = "fused_flat" if fed.fused_update else "legacy_tree"
    return get_engine(engine)(fed)


@register_engine("legacy_tree")
class LegacyTreeEngine(ServerEngine):
    """Tree-map engine with no kernel: the clip-norm scale over the
    aggregate's dict, an fp32 cast, then :func:`server_opt.apply` — several
    sweeps over the model where the fused engine makes one, and no
    backward, so only ``meta_mode='post'``."""
    name = "legacy_tree"
    accepts = frozenset({"tree"})
    preferred = "tree"
    meta_capabilities = frozenset({"post"})

    def __init__(self, fed):
        self._opt = fed.server_opt
        self._clip = fed.clip_norm
        self._momentum = fed.server_momentum

    def init_state(self, params):
        return server_opt.init_state(self._opt, params)

    def apply(self, params, handle, opt_state, *, lr):
        if not isinstance(handle, TreeAggregate):
            raise TypeError(f"legacy_tree consumes a TreeAggregate, got "
                            f"{type(handle).__name__}")
        G = handle.tree
        if self._clip > 0:
            gn = tree_global_norm(G)
            scale = torch.clamp(self._clip / torch.clamp(gn, min=1e-9),
                                max=1.0)
            G = {k: (g.to(torch.float32) * scale).to(g.dtype)
                 for k, g in G.items()}
        new_params, new_opt = server_opt.apply(
            self._opt, opt_state, params, G, lr, momentum=self._momentum)
        return new_params, new_opt, tree_global_norm(G)


@register_engine("fused_flat")
class FusedFlatEngine(ServerEngine):
    """Flat-buffer engine: clip + sgd/sgdm/adam/yogi + param write in one
    update-kernel sweep per dtype group, differentiable through the
    backward kernels — so it declares ``through_aggregation``; it consumes
    flat buffers, so lossy codecs' decoded aggregates too."""
    name = "fused_flat"
    accepts = frozenset({"flat", "tree"})
    preferred = "flat"
    meta_capabilities = frozenset({"post", "through_aggregation"})
    codec_capabilities = frozenset({"none", "lossy"})

    def __init__(self, fed):
        self._opt = fed.server_opt
        self._clip = fed.clip_norm
        self._momentum = fed.server_momentum

    def init_state(self, params):
        device = next(iter(params.values())).device
        return init_flat_opt_state(self._opt, make_flat_spec(params), device)

    def apply(self, params, handle, opt_state, *, lr):
        kw = dict(opt=self._opt, lr=lr, clip_norm=self._clip,
                  momentum=self._momentum)
        if isinstance(handle, TreeAggregate):
            # a pre-aggregated tree (a custom executor's): the engine over
            # a one-client stack, so the flat layout need not re-express it
            g_stack = {k: g[None] for k, g in handle.tree.items()}
            w = torch.ones((1,), dtype=torch.float32,
                           device=next(iter(g_stack.values())).device)
            return fused_server_update(params, g_stack, w, opt_state, **kw)
        if not isinstance(handle, FlatAggregate):
            raise TypeError(f"fused_flat consumes a FlatAggregate or a "
                            f"TreeAggregate, got {type(handle).__name__}")
        if handle.sq_norm is None:          # scan cohort: no pass-1 ssq
            return fused_apply_flat(params, handle.groups, opt_state,
                                    spec=handle.spec, mesh=handle.mesh, **kw)
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
    accepts = frozenset({"flat"})
    preferred = "flat"
    meta_capabilities = frozenset({"post"})
    codec_capabilities = frozenset({"none", "lossy"})
