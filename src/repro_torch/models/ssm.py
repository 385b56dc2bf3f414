"""Mamba2 (SSD — state-space duality) block of the port (PyTorch port of
``repro/models/ssm.py``).

Two forms of the chunked SSD scan.  Training (the loss, and every
derivative UGA takes of it, forward mode included) runs
:func:`ssd_chunked`, the port of JAX's function in plain, differentiable
PyTorch, as JAX trains through its jnp ``ssd_chunked``.  The prefill runs
the kernel's wrapper ``kernels/ssd_scan/kernel.py::ssd_scan_fwd``: the
CUDA kernel for CUDA tensors, its plain version for CPU tensors.  The
single-token decode step, the depthwise causal convolution and the block
around the scan are plain PyTorch, as the JAX block leaves them to XLA.

Block layout (mamba2):
  in_proj -> [z | x | B | C | dt]; causal depthwise conv over [x|B|C];
  dt = softplus(dt + bias); a = dt * A (A = -exp(A_log) per head);
  y = SSD(x, a, dt, B, C) + D * x;  out = out_proj(y * silu(z)).

In the prefill B and C reach the kernel by group, (B, S, G, N), and it
reads head h's group h // (H / G) in place: the JAX block's
``jnp.repeat`` to heads is the same function, without the copy.  The
training path repeats them to heads as JAX does.
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
from repro_torch.models.layers import (column_products, dense_init,
                                       row_parallel)

LEAVES = ("A_log", "D", "conv_w", "dt_bias", "in_proj", "out_proj")


def dims(d_model: int, cfg: SSMConfig) -> Tuple[int, int, int]:
    """(d_inner, heads, conv channels) of a block of width ``d_model``."""
    d_in = cfg.expand * d_model
    return d_in, d_in // cfg.d_head, d_in + 2 * cfg.n_groups * cfg.d_state


# ---------------------------------------------------------------------------
# Chunked SSD scan, the differentiable form (training)
# ---------------------------------------------------------------------------
def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, H, P); dt: (B, S, H) (already softplus'ed); A: (H,)
    negative; Bm/Cm: (B, S, H, N) (groups already broadcast to heads).
    Returns (y: (B, S, H, P), h_final: (B, H, N, P)), from a zero state.

    S is zero-padded to a multiple of ``L = min(chunk, S)``; within a
    chunk the recurrence is a masked quadratic form, across chunks the
    state is carried (JAX's ``lax.scan``, here a loop).  The mask goes in
    before the exponential, ``exp(where(tri, seg, -inf))``, as in JAX:
    above the diagonal ``seg`` is positive and reaches thousands at the
    init's decay range, so masking after ``exp`` would multiply an inf by
    0 and turn every tangent and cotangent through it into NaN."""
    B_, S, H, P = x.shape
    N = Bm.shape[-1]
    L = min(chunk, S)
    pad = (-S) % L
    if pad:
        zf = lambda t: F.pad(t, [0, 0] * (t.dim() - 2) + [0, pad])
        x, dt, Bm, Cm = zf(x), zf(dt), zf(Bm), zf(Cm)
    nc = x.shape[1] // L
    a = dt * A[None, None, :]                                # (B, S, H) <= 0
    rs = lambda t: t.reshape((B_, nc, L) + tuple(t.shape[2:])).transpose(0, 1)
    idx = torch.arange(L, device=x.device)
    tri = (idx[:, None] >= idx[None, :])[None, :, :, None]
    h = torch.zeros((B_, H, N, P), dtype=torch.float32, device=x.device)
    ys = []
    for xk, dtk, ak, Bk, Ck in zip(rs(x), rs(dt), rs(a), rs(Bm), rs(Cm)):
        acum = torch.cumsum(ak.float(), dim=1)               # (B, L, H)
        # ---- intra-chunk (quadratic) ----
        seg = acum[:, :, None, :] - acum[:, None, :, :]      # (B, t, s, H)
        decay = torch.exp(torch.where(tri, seg, -torch.inf))
        scores = torch.einsum("blhn,bmhn->blmh", Ck.float(), Bk.float())
        xdt = xk.float() * dtk[..., None]
        y_intra = torch.einsum("blmh,bmhp->blhp", scores * decay, xdt)
        # ---- contribution of the incoming state ----
        y_inter = torch.einsum("blhn,bhnp->blhp",
                               Ck.float() * torch.exp(acum)[..., None], h)
        # ---- state update ----
        decay_to_end = torch.exp(acum[:, -1:, :] - acum)     # (B, L, H)
        h = (torch.exp(acum[:, -1])[:, :, None, None] * h
             + torch.einsum("blhn,blhp->bhnp",
                            Bk.float() * decay_to_end[..., None], xdt))
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(B_, nc * L, H, P)
    return y[:, :S].to(x.dtype), h


# ---------------------------------------------------------------------------
# The SSD scan's one-token step
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
                *, collect_cache: bool = False, tp=None):
    """u: (B, S, d_model) -> (B, S, d_model), the full sequence, through
    :func:`ssd_chunked` (training).  With ``collect_cache`` (the prefill)
    the scan is the kernel's, and the block also returns the
    end-of-sequence decode cache ``{"ssm": h_final, "conv": the last
    d_conv - 1 conv inputs}``, as the JAX ``_mamba_prefill`` returns it.

    Over the model axis ``tp`` (training): ``in_proj``'s split columns and
    ``conv_w``'s split channels cut through the x segment, so the
    projection is gathered whole and the conv weight too.  Where the axis
    divides the heads, each process then convolves, scans and gates its
    own heads' channels of x / z / dt, with B and C whole (the gathered
    tensors enter its heads through ``tp.copy``; ``A_log``, ``D`` and
    ``dt_bias``, whole leaves, through ``tp.split``, so their gradients
    come back whole on every process), multiplies its rows of
    ``out_proj`` and the partial outputs are summed over the axis.  Else
    the mixer runs whole on every process and ``out_proj`` goes through
    ``row_parallel``."""
    B_, S, d_model = u.shape
    d_in, H, conv_dim = dims(d_model, cfg)
    G, N, P = cfg.n_groups, cfg.d_state, cfg.d_head
    (zxbcdt,) = column_products(u, (p["in_proj"],),
                                (2 * d_in + 2 * G * N + H,), tp)
    conv_w = p["conv_w"]
    if tp is not None and tp.is_split(conv_w.shape[-1], conv_dim):
        conv_w = tp.gather(conv_w, -1)
    heads = tp is not None and H % tp.size == 0
    if heads:
        zxbcdt, conv_w = tp.copy(zxbcdt), tp.copy(conv_w)
    z, xr, Bm, Cm, dt = _split_proj(zxbcdt, d_in, G, N, H)
    A_log, D, dt_bias = p["A_log"], p["D"], p["dt_bias"]
    if heads:
        n, h = d_in // tp.size, H // tp.size
        z, xr = z.narrow(-1, tp.coord * n, n), xr.narrow(-1, tp.coord * n, n)
        dt = dt.narrow(-1, tp.coord * h, h)
        conv_w = torch.cat([conv_w.narrow(-1, tp.coord * n, n),
                            conv_w[..., d_in:]], dim=-1)
        A_log, D, dt_bias = (tp.split(t, -1) for t in (A_log, D, dt_bias))
        d_in, H = n, h
    xbc_in = torch.cat([xr, Bm, Cm], dim=-1)
    xbc, _ = causal_conv(xbc_in, conv_w)
    xbc = F.silu(xbc)
    xr, Bm, Cm = (xbc[..., :d_in], xbc[..., d_in:d_in + G * N],
                  xbc[..., d_in + G * N:])
    dt = F.softplus(dt.float() + dt_bias)
    A = -torch.exp(A_log)
    x_h = xr.reshape(B_, S, H, P)
    if collect_cache:
        y, h_final = ssd_scan_fwd(x_h, dt, A, Bm.reshape(B_, S, G, N),
                                  Cm.reshape(B_, S, G, N), chunk=cfg.chunk)
    else:
        rep = H // G
        B_h = Bm.reshape(B_, S, G, N).repeat_interleave(rep, dim=2)
        C_h = Cm.reshape(B_, S, G, N).repeat_interleave(rep, dim=2)
        y, _ = ssd_chunked(x_h, dt, A, B_h, C_h, cfg.chunk)
    y = y + x_h * D[None, None, :, None].to(y.dtype)
    y = y.reshape(B_, S, d_in) * F.silu(z)
    out = tp.reduce(y @ p["out_proj"]) if heads else row_parallel(
        y, p["out_proj"], tp)
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
