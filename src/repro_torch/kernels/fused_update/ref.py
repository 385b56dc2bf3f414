"""Plain PyTorch versions of the fused server-update kernels.

The same functions as the CUDA kernels in ``csrc/fused_update.cu`` and as
the JAX package's ``repro/kernels/fused_update/ref.py``, over the flat
layout of :mod:`repro_torch.core.flat`:

  aggregate   G = sum_k w_k g_k   and   ssq = ||G||^2
  accumulate  acc + w g           (one client at a time, scan strategy)
  update      d = optimizer(G * scale);  p <- p - lr * d

The CPU path of each kernel wrapper runs these, and the card's tests hold
each kernel against them.  The per-optimizer arithmetic follows the JAX
kernel term for term, fp32 throughout; bias corrections arrive as
bc1 = 1/(1-b1^t), bc2 = 1/(1-b2^t) in ``scalars = [scale, lr, bc1, bc2]``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def aggregate_ref(g_stack: torch.Tensor, w_norm: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """g_stack: (cohort, rows, lanes) fp32; w_norm: (cohort,) normalized.
    Returns (G (rows, lanes), ssq ())."""
    G = torch.sum(g_stack * w_norm.to(torch.float32)[:, None, None], dim=0)
    return G, torch.sum(G * G)


def accumulate_ref(acc: torch.Tensor, g: torch.Tensor, w) -> torch.Tensor:
    """``acc + w * g`` over one client's flat fp32 gradient buffer."""
    return acc + w * g


def update_ref(G: torch.Tensor, p: torch.Tensor, m: Optional[torch.Tensor],
               v: Optional[torch.Tensor], scalars: torch.Tensor, *, opt: str,
               momentum: float = 0.9, b1: float = 0.9, b2: float = 0.99,
               eps: float = 1e-8):
    """One flat-buffer optimizer step; ``scalars`` is the (4,)
    [scale, lr, bc1, bc2] operand the kernel takes.  Returns (new_p,
    new_m, new_v) with None slots matching the optimizer's arity."""
    scale, lr, bc1, bc2 = scalars[0], scalars[1], scalars[2], scalars[3]
    g = G * scale
    if opt == "sgd":
        return p - lr * g, None, None
    if opt == "sgdm":
        m_new = momentum * m + g
        return p - lr * m_new, m_new, None
    if opt in ("adam", "yogi"):
        m_new = b1 * m + (1.0 - b1) * g
        if opt == "adam":
            v_new = b2 * v + (1.0 - b2) * g * g
        else:
            v_new = v - (1.0 - b2) * torch.sign(v - g * g) * g * g
        step = (m_new * bc1) / (torch.sqrt(v_new * bc2) + eps)
        return p - lr * step, m_new, v_new
    raise ValueError(opt)
