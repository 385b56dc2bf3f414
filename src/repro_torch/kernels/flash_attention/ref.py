"""Plain PyTorch version of the flash-attention kernel (the counterpart of
``repro/kernels/flash_attention/ref.py``), in the kernel's folded
``(B*H, S, D)`` layout: k and v repeated over the group, then einsum,
mask, softmax, einsum.  The CPU path and the tests run it; on the card it
is only the yardstick the kernel is held to.  Values may be narrower than
keys (MLA: Dk 192, Dv 128); scores are scaled by 1 / sqrt(Dk), as JAX's
``simple_attention`` scales them.

At bf16 it makes the kernel's roundings: q.k of the bf16 operands taken
in fp32 (their products are exact there), the softmax in fp32 with its
sum of the unrounded exponentials, the exponentials rounded to bf16
before p.v (in fp32), o divided by the sum and rounded to bf16, as JAX's
kernel does at bf16."""
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
    half = v.dtype != torch.float32
    if half:
        q, k = q.float(), k.float()
    s = torch.einsum("bqd,bkd->bqk", q, k).to(torch.float32) / math.sqrt(D)
    rel = (torch.arange(Sq, device=q.device)[:, None]
           - torch.arange(Skv, device=q.device)[None, :])
    if causal:
        s = torch.where(rel >= 0, s, NEG_INF)
    if window > 0:
        s = torch.where(rel < window, s, NEG_INF)
    if half:
        e = torch.exp(s - s.amax(dim=-1, keepdim=True))
        o = torch.einsum("bqk,bkd->bqd", e.to(v.dtype).float(), v.float())
        return (o / e.sum(dim=-1, keepdim=True)).to(v.dtype)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p.to(v.dtype), v).to(v.dtype)
