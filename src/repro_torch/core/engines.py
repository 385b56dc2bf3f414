"""Server engines (PyTorch port of ``repro/core/engines.py``): WHAT the
server does with an aggregate.  The port has the ``fused_flat`` engine —
clip + optimizer + parameter write in one CUDA sweep per dtype group
(``kernels/fused_update``).  ``legacy_tree`` (the kernel-free tree-map
oracle) is ROADMAP Queue 1 item 1."""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from repro_torch.core.executors import FlatAggregate
from repro_torch.core.flat import make_flat_spec
from repro_torch.core.registry import Registry
from repro_torch.kernels.fused_update.ops import (flat_apply_groups,
                                                  fused_apply_flat,
                                                  init_flat_opt_state)

__all__ = ["ServerEngine", "FusedFlatEngine", "register_engine",
           "get_engine", "resolve_engine"]


class ServerEngine:
    """Protocol: ``init_state(params)`` and ``apply(params, handle,
    opt_state, lr=) -> (new_params, new_opt_state, grad_norm_after_clip)``."""
    name: str = "?"

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
    ``legacy_tree`` and ``buffered_async``)."""
    return get_engine(fed.engine or "fused_flat")(fed)


@register_engine("fused_flat")
class FusedFlatEngine(ServerEngine):
    """Flat-buffer engine: clip + sgd/sgdm/adam/yogi + param write in one
    update-kernel sweep per dtype group."""
    name = "fused_flat"

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
