"""Public engine for the fused server-side update (PyTorch port of
``repro/kernels/fused_update/ops.py``, forward surface).

Two sweeps over flat per-dtype-group fp32 buffers (:mod:`repro_torch.core.
flat`) per round:

  pass 1  kernel.aggregate_pass   cohort-weighted mean + ||G||^2
          (or, for the client-sequential scan cohort, one
          kernel.accumulate_pass per client: acc + w_k g_k)
  pass 2  kernel.update_pass      clip scale + sgd/sgdm/adam/yogi + write

Everything between the passes — weight normalization, ||G||, the clip
scale, bias corrections — stays on the device as 0-d tensors, so a round
never waits on the host for them.  The backward (custom-VJP) half waits
for ``meta_mode='through_aggregation'`` (ROADMAP Queue 1 item 1).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core import flat as flat_mod
from repro_torch.core.flat import FlatSpec, Params
from repro_torch.kernels.fused_update import kernel as K


def init_flat_opt_state(opt: str, spec: FlatSpec, device=None) -> Dict:
    """Optimizer state in the flat layout (one fp32 buffer per group)."""
    zeros = lambda: tuple(flat_mod.zeros_flat(spec, device))
    if opt == "sgd":
        return {}
    if opt == "sgdm":
        return {"m": zeros()}
    if opt in ("adam", "yogi"):
        return {"m": zeros(), "v": zeros(),
                "t": torch.zeros((), dtype=torch.int32, device=device)}
    raise ValueError(opt)


def normalize_weights(client_weights: torch.Tensor) -> torch.Tensor:
    w = client_weights.to(torch.float32)
    return w / torch.clamp(torch.sum(w), min=1e-30)


def flat_weighted_aggregate(spec: FlatSpec, g_stacks: Sequence[torch.Tensor],
                            client_weights: torch.Tensor
                            ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Pass 1: normalize ``client_weights`` and reduce each group's
    ``(cohort, rows, 128)`` gradient stack.  Returns (G_groups, ssq) with
    ``ssq = ||G||^2`` summed over groups."""
    assert len(g_stacks) == len(spec.groups)
    w = normalize_weights(client_weights)
    Gs, ssq = [], None
    for g_stack in g_stacks:
        G, s = K.aggregate_pass(g_stack, w)
        Gs.append(G)
        ssq = s if ssq is None else ssq + s
    return Gs, ssq


def flat_accumulate(acc: torch.Tensor, g: torch.Tensor, w: torch.Tensor, *,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Streaming Eq. (14) term ``acc + w * g`` over one group buffer."""
    return K.accumulate_pass(acc, g, w, out=out)


def _scalar(x, device) -> torch.Tensor:
    """A 0-d fp32 tensor on ``device``; a host number becomes a fill
    kernel's argument, not a host-to-device copy."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.full((), x, dtype=torch.float32, device=device)


def flat_apply_groups(spec: FlatSpec, G_groups, gn: torch.Tensor,
                      params: Params, opt_state: Dict, *, opt: str, lr,
                      clip_norm: float = 0.0, momentum: float = 0.9,
                      b1: float = 0.9, b2: float = 0.99, eps: float = 1e-8
                      ) -> Tuple[Params, Dict, torch.Tensor]:
    """Pass 2: clip scale + optimizer + param write over aggregated flat
    buffers, with the pre-clip global norm ``gn`` (a device scalar) from
    the caller.  Returns (new_params, new_opt_state, gn_after_clip)."""
    device = gn.device
    p_groups = flat_mod.flatten_tree(spec, params)
    if clip_norm > 0:
        scale = torch.clamp(clip_norm / torch.clamp(gn, min=1e-9), max=1.0)
    else:
        scale = _scalar(1.0, device)
    if opt in ("adam", "yogi"):
        t = opt_state["t"] + 1
        tf = t.to(torch.float32)
        bc1 = 1.0 / (1.0 - torch.pow(_scalar(b1, device), tf))
        bc2 = 1.0 / (1.0 - torch.pow(_scalar(b2, device), tf))
    else:
        t = None
        bc1 = bc2 = _scalar(1.0, device)
    scalars = torch.stack([scale, _scalar(lr, device), bc1, bc2])

    ms = opt_state.get("m", (None,) * len(spec.groups))
    vs = opt_state.get("v", (None,) * len(spec.groups))
    new_p, new_m, new_v = [], [], []
    for G, p, m, v in zip(G_groups, p_groups, ms, vs):
        np_, nm, nv = K.update_pass(G, p, m, v, scalars, opt=opt,
                                    momentum=momentum, b1=b1, b2=b2, eps=eps)
        new_p.append(np_)
        new_m.append(nm)
        new_v.append(nv)
    new_params = flat_mod.unflatten_tree(spec, new_p)
    if opt == "sgd":
        new_state: Dict = {}
    elif opt == "sgdm":
        new_state = {"m": tuple(new_m)}
    else:
        new_state = {"m": tuple(new_m), "v": tuple(new_v), "t": t}
    return new_params, new_state, gn * scale


def fused_apply_flat(params: Params, G_groups, opt_state: Dict, *,
                     opt: str = "sgd", lr, clip_norm: float = 0.0,
                     momentum: float = 0.9, b1: float = 0.9,
                     b2: float = 0.99, eps: float = 1e-8,
                     spec: Optional[FlatSpec] = None
                     ) -> Tuple[Params, Dict, torch.Tensor]:
    """Pass 2 over ALREADY-aggregated buffers (the scan cohort's entry
    point): ||G||^2 is reduced here with plain PyTorch, as the JAX package
    reduces it with plain jnp."""
    if spec is None:
        spec = flat_mod.make_flat_spec(params)
    gn = torch.sqrt(flat_mod.flat_sq_norm(G_groups))
    return flat_apply_groups(spec, G_groups, gn, params, opt_state, opt=opt,
                             lr=lr, clip_norm=clip_norm, momentum=momentum,
                             b1=b1, b2=b2, eps=eps)
