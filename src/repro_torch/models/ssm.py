"""Mamba2 (SSD — state-space duality) block of the port (PyTorch port of
``repro/models/ssm.py``).

The chunked SSD scan (JAX's ``ssd_chunked``) is the kernel's wrapper
``kernels/ssd_scan/kernel.py::ssd_scan_fwd``: the CUDA kernel for CUDA
tensors, its plain version for CPU tensors.  The
single-token decode step, the depthwise causal convolution and the block
around the scan are plain PyTorch, as the JAX block leaves them to XLA.

Block layout (mamba2):
  in_proj -> [z | x | B | C | dt]; causal depthwise conv over [x|B|C];
  dt = softplus(dt + bias); a = dt * A (A = -exp(A_log) per head);
  y = SSD(x, a, dt, B, C) + D * x;  out = out_proj(y * silu(z)).

Unlike the JAX block, B and C reach the scan by group, (B, S, G, N),
and the kernel reads head h's group h // (H / G) in place: the JAX
block's ``jnp.repeat`` to heads is the same function, without the copy.
The functions are pure (no in-place writes); the decode cache's storage
is updated by :func:`repro_torch.models.transformer.decode_step`.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.kernels.ssd_scan.kernel import ssd_scan_fwd
from repro_torch.models.layers import dense_init

LEAVES = ("A_log", "D", "conv_w", "dt_bias", "in_proj", "out_proj")


def dims(d_model: int, cfg: SSMConfig) -> Tuple[int, int, int]:
    """(d_inner, heads, conv channels) of a block of width ``d_model``."""
    d_in = cfg.expand * d_model
    return d_in, d_in // cfg.d_head, d_in + 2 * cfg.n_groups * cfg.d_state


# ---------------------------------------------------------------------------
# The SSD scan's one-token step (the scan itself: ``ssd_scan_fwd``)
# ---------------------------------------------------------------------------
def ssd_decode_step(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    Bm: torch.Tensor, Cm: torch.Tensor, h: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token SSD update.  x: (B, H, P); dt: (B, H); Bm/Cm: (B, H,
    N); h: (B, H, N, P).  Returns (y: (B, H, P), h_new)."""
    a = torch.exp((dt * A[None, :]).float())
    xdt = x.float() * dt[..., None]
    h_new = (a[..., None, None] * h
             + torch.einsum("bhn,bhp->bhnp", Bm.float(), xdt))
    y = torch.einsum("bhn,bhnp->bhp", Cm.float(), h_new)
    return y.to(x.dtype), h_new


# ---------------------------------------------------------------------------
# Depthwise causal conv (width d_conv) over the channel-last layout
# ---------------------------------------------------------------------------
def causal_conv(x: torch.Tensor, w: torch.Tensor,
                cache: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, C); w: (d_conv, C); cache: (B, d_conv-1, C) past inputs.
    Returns (y: (B, S, C), new_cache)."""
    dconv, S = w.shape[0], x.shape[1]
    if cache is None:
        cache = x.new_zeros((x.shape[0], dconv - 1, x.shape[-1]))
    ext = torch.cat([cache, x], dim=1)                      # (B, S+dc-1, C)
    y = sum(ext[:, i:i + S] * w[i][None, None] for i in range(dconv))
    new_cache = ext[:, -(dconv - 1):] if dconv > 1 else cache
    return y, new_cache


def causal_conv_step(x: torch.Tensor, w: torch.Tensor, cache: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One token: x (B, C); cache (B, d_conv-1, C)."""
    ext = torch.cat([cache, x[:, None]], dim=1)             # (B, dc, C)
    y = torch.einsum("bkc,kc->bc", ext, w)
    return y, ext[:, 1:]


# ---------------------------------------------------------------------------
# Full mamba2 mixer block
# ---------------------------------------------------------------------------
def mamba_init(gen: torch.Generator, d_model: int, cfg: SSMConfig, *,
               lead=(), dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """The JAX initializers' distributions (not their numbers), each leaf
    with the leading shape ``lead`` (the stack over layers)."""
    d_in, H, conv_dim = dims(d_model, cfg)
    GN = cfg.n_groups * cfg.d_state
    dev, lead = gen.device, tuple(lead)
    conv = torch.randn(lead + (cfg.d_conv, conv_dim), generator=gen,
                       device=dev) / math.sqrt(cfg.d_conv)
    a_log = torch.log(torch.linspace(1.0, 16.0, H, device=dev))
    return {
        "A_log": a_log.expand(lead + (H,)).clone(),
        "D": torch.ones(lead + (H,), device=dev),
        "conv_w": conv.to(dtype),
        "dt_bias": torch.zeros(lead + (H,), device=dev),
        "in_proj": dense_init(gen, d_model, 2 * d_in + 2 * GN + H,
                              lead=lead, dtype=dtype),
        "out_proj": dense_init(gen, d_in, d_model, lead=lead, dtype=dtype),
    }


def _split_proj(zxbcdt: torch.Tensor, d_in: int, G: int, N: int, H: int):
    z = zxbcdt[..., :d_in]
    x = zxbcdt[..., d_in:2 * d_in]
    Bm = zxbcdt[..., 2 * d_in:2 * d_in + G * N]
    Cm = zxbcdt[..., 2 * d_in + G * N:2 * d_in + 2 * G * N]
    dt = zxbcdt[..., 2 * d_in + 2 * G * N:]
    return z, x, Bm, Cm, dt


def mamba_block(u: torch.Tensor, p: Dict[str, torch.Tensor], cfg: SSMConfig,
                *, collect_cache: bool = False):
    """u: (B, S, d_model) -> (B, S, d_model), the full sequence.  With
    ``collect_cache`` (the prefill) also the end-of-sequence decode cache
    ``{"ssm": h_final, "conv": the last d_conv - 1 conv inputs}``, as the
    JAX ``_mamba_prefill`` returns it."""
    B_, S, d_model = u.shape
    d_in, H, _ = dims(d_model, cfg)
    G, N, P = cfg.n_groups, cfg.d_state, cfg.d_head
    z, xr, Bm, Cm, dt = _split_proj(u @ p["in_proj"], d_in, G, N, H)
    xbc_in = torch.cat([xr, Bm, Cm], dim=-1)
    xbc, _ = causal_conv(xbc_in, p["conv_w"])
    xbc = F.silu(xbc)
    xr, Bm, Cm = (xbc[..., :d_in], xbc[..., d_in:d_in + G * N],
                  xbc[..., d_in + G * N:])
    dt = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    x_h = xr.reshape(B_, S, H, P)
    y, h_final = ssd_scan_fwd(x_h, dt, A, Bm.reshape(B_, S, G, N),
                              Cm.reshape(B_, S, G, N), chunk=cfg.chunk)
    y = y + x_h * p["D"][None, None, :, None].to(y.dtype)
    out = (y.reshape(B_, S, d_in) * F.silu(z)) @ p["out_proj"]
    if not collect_cache:
        return out
    # a copy: a view of the slice would keep the layer's whole (B, S, C)
    # projection alive for as long as the cache lives
    conv_cache = (xbc_in[:, -(cfg.d_conv - 1):].clone() if cfg.d_conv > 1
                  else xbc_in.new_zeros((B_, 0, xbc_in.shape[-1])))
    return out, {"ssm": h_final, "conv": conv_cache}


def mamba_make_cache(batch: int, d_model: int, cfg: SSMConfig, dtype, *,
                     lead=(), device=None) -> Dict[str, torch.Tensor]:
    _, H, conv_dim = dims(d_model, cfg)
    lead = tuple(lead)
    return {
        "ssm": torch.zeros(lead + (batch, H, cfg.d_state, cfg.d_head),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros(lead + (batch, cfg.d_conv - 1, conv_dim),
                            dtype=dtype, device=device),
    }


def mamba_block_decode(u: torch.Tensor, p: Dict[str, torch.Tensor],
                       cfg: SSMConfig, cache: Dict[str, torch.Tensor]):
    """u: (B, d_model) one token; cache: {'ssm', 'conv'}.  Returns (y,
    the new cache entry); the given cache is not modified."""
    B_, d_model = u.shape
    d_in, H, _ = dims(d_model, cfg)
    G, N, P = cfg.n_groups, cfg.d_state, cfg.d_head
    z, xr, Bm, Cm, dt = _split_proj(u @ p["in_proj"], d_in, G, N, H)
    xbc, conv_cache = causal_conv_step(torch.cat([xr, Bm, Cm], dim=-1),
                                       p["conv_w"], cache["conv"])
    xbc = F.silu(xbc)
    xr, Bm, Cm = (xbc[..., :d_in], xbc[..., d_in:d_in + G * N],
                  xbc[..., d_in + G * N:])
    dt = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    rep = H // G
    x_h = xr.reshape(B_, H, P)
    B_h = Bm.reshape(B_, G, N).repeat_interleave(rep, dim=1)
    C_h = Cm.reshape(B_, G, N).repeat_interleave(rep, dim=1)
    y, ssm = ssd_decode_step(x_h, dt, A, B_h, C_h, cache["ssm"])
    y = y + x_h * p["D"][None, :, None].to(y.dtype)
    y = y.reshape(B_, d_in) * F.silu(z)
    return y @ p["out_proj"], {"ssm": ssm, "conv": conv_cache}
