"""Plain PyTorch version of the flash-attention kernel (the counterpart of
``repro/kernels/flash_attention/ref.py``), in the kernel's folded
``(B*H, S, D)`` layout: k and v repeated over the group, then einsum,
mask, softmax, einsum.  The CPU path and the tests run it; on the card it
is only the yardstick the kernel is held to.  Values may be narrower than
keys (MLA: Dk 192, Dv 128); scores are scaled by 1 / sqrt(Dk), as JAX's
``simple_attention`` scales them."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (BH, Sq, Dk); k: (BHkv, Skv, Dk); v: (BHkv, Skv, Dv); kv head = q
    head // group (heads ordered (b, h)); returns (BH, Sq, Dv).  Query i and key j are positions i and j of the
    same sequence: causal keeps j <= i, ``window > 0`` keeps i - j <
    window."""
    BH, Sq, D = q.shape
    BHkv, Skv, _ = k.shape
    group = BH // BHkv
    k = k.repeat_interleave(group, dim=0)
    v = v.repeat_interleave(group, dim=0)
    s = torch.einsum("bqd,bkd->bqk", q, k).to(torch.float32) / math.sqrt(D)
    rel = (torch.arange(Sq, device=q.device)[:, None]
           - torch.arange(Skv, device=q.device)[None, :])
    if causal:
        s = torch.where(rel >= 0, s, NEG_INF)
    if window > 0:
        s = torch.where(rel < window, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p.to(v.dtype), v).to(v.dtype)
