"""Shared building blocks of the dense LM (PyTorch port of
``repro/models/layers.py``): pure tensor functions, no in-place ops, so
``torch.func`` can take forward- and reverse-mode derivatives through
them."""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# Initializers (explicit generators, no global state)
# ---------------------------------------------------------------------------
def dense_init(gen: torch.Generator, d_in: int, d_out: int, *,
               lead=(), dtype=torch.float32, scale: Optional[float] = None
               ) -> torch.Tensor:
    """Normal(0, 1/d_in) weights of shape ``lead + (d_in, d_out)``, used as
    ``x @ w`` like the JAX layout."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn(tuple(lead) + (d_in, d_out), generator=gen,
                    device=gen.device, dtype=torch.float32)
    return (w * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype=torch.float32) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32)).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings (interleaved lane pairs, as the JAX package)
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies, shape (head_dim//2,)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., S, H, D) or (..., S, D); positions: (..., S) int.  Pairs
    lanes (0, 1), (2, 3), ... — ``x[..., ::2]`` with ``x[..., 1::2]`` —
    not the half-split layout."""
    if theta <= 0:
        return x
    d = x.shape[-1]
    inv = rope_freqs(d, theta, x.device)
    ang = positions[..., None].to(torch.float32) * inv
    if x.dim() == ang.dim() + 1:
        ang = ang[..., None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x32 = x.to(torch.float32)
    x1, x2 = x32[..., ::2], x32[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------
def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down
