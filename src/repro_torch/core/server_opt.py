"""Server-side optimizers, the FedOpt family (PyTorch port of
``repro/core/server_opt.py``): the tree-map server step of the
``legacy_tree`` engine, over the port's dicts of tensors.

The aggregated quantity G is gradient-like: for UGA it is the unbiased
gradient of Eq. (14); for FedAvg / FedProx it is the pseudo-gradient
``w_t - mean_k w_k``, so that plain SGD with lr = 1 is FedAvg's parameter
average.  The math runs in fp32 and parameters keep their dtype.  The
state is ``{}`` (sgd), ``{"m"}`` (sgdm) or ``{"m", "v", "t"}`` (adam,
yogi): fp32 slots named as the parameters, and the step count ``t`` an
int32 scalar tensor, as the JAX package keeps it, so the state saves and
restores through :mod:`repro_torch.checkpoint` in the JAX blob format.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

Params = Dict[str, torch.Tensor]

__all__ = ["init_state", "apply"]


def init_state(name: str, params: Params) -> dict:
    def zeros():
        return {k: torch.zeros_like(p, dtype=torch.float32)
                for k, p in params.items()}

    if name == "sgd":
        return {}
    if name == "sgdm":
        return {"m": zeros()}
    if name in ("adam", "yogi"):
        device = next(iter(params.values())).device
        return {"m": zeros(), "v": zeros(),
                "t": torch.zeros((), dtype=torch.int32, device=device)}
    raise ValueError(name)


def apply(name: str, state: dict, params: Params, grad: Params, lr, *,
          momentum: float = 0.9, b1: float = 0.9, b2: float = 0.99,
          eps: float = 1e-8) -> Tuple[Params, dict]:
    """Returns (new_params, new_state).  Math in fp32; params keep their
    dtype."""
    g32 = {k: g.to(torch.float32) for k, g in grad.items()}

    def upd(d):
        return {k: (p.to(torch.float32) - lr * d[k]).to(p.dtype)
                for k, p in params.items()}

    if name == "sgd":
        return upd(g32), state
    if name == "sgdm":
        m = {k: momentum * state["m"][k] + g for k, g in g32.items()}
        return upd(m), {"m": m}
    if name in ("adam", "yogi"):
        t = state["t"] + 1
        tf = t.to(torch.float32)
        m = {k: b1 * state["m"][k] + (1 - b1) * g for k, g in g32.items()}
        if name == "adam":
            v = {k: b2 * state["v"][k] + (1 - b2) * g * g
                 for k, g in g32.items()}
        else:  # yogi
            v = {k: state["v"][k] - (1 - b2) * torch.sign(
                state["v"][k] - g * g) * g * g for k, g in g32.items()}
        c1, c2 = 1 - b1 ** tf, 1 - b2 ** tf
        step = {k: (m[k] / c1) / (torch.sqrt(v[k] / c2) + eps) for k in m}
        return upd(step), {"m": m, "v": v, "t": t}
    raise ValueError(name)
