"""Plain PyTorch versions of the fused server-update kernels.

The same functions as the CUDA kernels in ``csrc/fused_update.cu`` and as
the JAX package's ``repro/kernels/fused_update/ref.py``, over the flat
layout of :mod:`repro_torch.core.flat`:

  aggregate   G = sum_k w_k g_k   and   ssq = ||G||^2
  accumulate  acc + w g           (one client at a time, scan strategy)
  update      d = optimizer(G * scale);  p <- p - lr * d

and their hand-derived VJPs (``*_bwd_ref``), the plain versions of the
three backward kernels.  The CPU path of each kernel wrapper runs these,
and the card's tests hold each kernel against them.  The per-optimizer
arithmetic follows the JAX kernel term for term, fp32 throughout; bias
corrections arrive as bc1 = 1/(1-b1^t), bc2 = 1/(1-b2^t) in
``scalars = [scale, lr, bc1, bc2]``.

The backward conventions are the JAX package's: yogi's ``sign`` is held
constant, and the adam/yogi factor ``1/(2 sqrt(v' bc2))`` is zero-guarded,
so zero-padded rows give back exact zeros, not NaN.  One difference: the
backward's sums over a buffer (the weight and scalar cotangents) add fp32
products in fp64, as the kernels do.  An fp32 sum of a cancelling dot
product over the 361 M elements of a full-width model keeps about five
digits; in fp64 the kernel and its plain version agree to fp32 rounding.
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


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """<a, b> over every element: fp32 products summed in fp64, returned
    as an fp32 0-d tensor."""
    return torch.sum(a * b, dtype=torch.float64).to(torch.float32)


def accumulate_bwd_ref(g: torch.Tensor, w, d_out: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """VJP of :func:`accumulate_ref` w.r.t. (g, w); the accumulator's
    cotangent is ``d_out`` itself and handled by the caller.
    Returns (dg = w d_out, dw = <g, d_out>)."""
    return w * d_out, _dot(g, d_out)


def aggregate_bwd_ref(g_stack: torch.Tensor, w_norm: torch.Tensor,
                      G: torch.Tensor, dG: torch.Tensor, dssq
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """VJP of :func:`aggregate_ref`: with dGt = dG + 2 dssq G,
    dg_k = w_k dGt and dw_k = <g_k, dGt>.  Returns (dg_stack, dw (cohort,))."""
    dGt = dG + 2.0 * dssq * G
    dg = w_norm.to(torch.float32)[:, None, None] * dGt[None]
    dw = torch.stack([_dot(g_stack[k], dGt)
                      for k in range(g_stack.shape[0])])
    return dg, dw


def update_bwd_ref(G: torch.Tensor, m: Optional[torch.Tensor],
                   v: Optional[torch.Tensor], scalars: torch.Tensor,
                   d_new_p: torch.Tensor, d_new_m: Optional[torch.Tensor],
                   d_new_v: Optional[torch.Tensor], *, opt: str,
                   momentum: float = 0.9, b1: float = 0.9, b2: float = 0.99,
                   eps: float = 1e-8):
    """VJP of :func:`update_ref` w.r.t. (G, m, v, scalars); the parameter's
    cotangent is ``d_new_p`` itself (p' = p - lr * step) and handled by the
    caller.  The recurrence is replayed from the forward's (G, m, v)
    residuals.  Returns (dG, dm, dv, dscalars (4,)) with None slots
    matching the optimizer's arity."""
    s, lr = scalars[0], scalars[1]
    g = G * s
    zero = torch.zeros((), dtype=torch.float32, device=G.device)
    dbc1 = dbc2 = zero
    dm = dv = None
    if opt == "sgd":
        dg = -lr * d_new_p
        dlr = -_dot(g, d_new_p)
    elif opt == "sgdm":
        m_new = momentum * m + g
        dmn = d_new_m - lr * d_new_p
        dlr = -_dot(m_new, d_new_p)
        dg = dmn
        dm = momentum * dmn
    elif opt in ("adam", "yogi"):
        bc1, bc2 = scalars[2], scalars[3]
        m_new = b1 * m + (1.0 - b1) * g
        if opt == "adam":
            v_new = b2 * v + (1.0 - b2) * g * g
        else:
            sgn = torch.sign(v - g * g)
            v_new = v - (1.0 - b2) * sgn * g * g
        rs = torch.sqrt(v_new * bc2)
        denom = rs + eps
        step = m_new * bc1 / denom
        dstep = -lr * d_new_p
        dlr = -_dot(step, d_new_p)
        dmn = d_new_m + dstep * (bc1 / denom)
        dbc1 = torch.sum(dstep * m_new / denom,
                         dtype=torch.float64).to(torch.float32)
        ddenom = -dstep * step / denom
        inv2rs = torch.where(rs > 0.0, 0.5 / torch.clamp(rs, min=1e-30),
                             zero)
        dvn = d_new_v + ddenom * bc2 * inv2rs
        dbc2 = _dot(ddenom * v_new, inv2rs)
        dm = b1 * dmn
        if opt == "adam":
            dv = b2 * dvn
            dg = (1.0 - b1) * dmn + 2.0 * (1.0 - b2) * g * dvn
        else:
            dv = dvn
            dg = (1.0 - b1) * dmn - 2.0 * (1.0 - b2) * sgn * g * dvn
    else:
        raise ValueError(opt)
    dscal = torch.stack([_dot(G, dg), dlr, dbc1, dbc2])
    return s * dg, dm, dv, dscal
