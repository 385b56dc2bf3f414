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
    ``x @ w`` like the JAX layout.  Scaled in place, so a full-width init
    holds one copy of each leaf at a time."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn(tuple(lead) + (d_in, d_out), generator=gen,
                    device=gen.device, dtype=torch.float32)
    return w.mul_(scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype=torch.float32) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return w.mul_(0.02).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32)).to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with the population variance, as ``jnp.var`` takes it."""
    x32 = x.to(torch.float32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x32 - mu), dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32)
            + bias.to(torch.float32)).to(x.dtype)


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


def sinusoidal_positions(positions: torch.Tensor, d: int,
                         dtype=torch.float32) -> torch.Tensor:
    """The classic sinusoidal table's rows at ``positions`` (any shape):
    (..., d), sin in the even lanes and cos in the odd ones.  JAX's
    ``sinusoidal_positions(length, d)`` is ``positions = arange(length)``;
    its decode step computes the row at the cache index the same way."""
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32,
                                 device=positions.device)
                    * (-math.log(10000.0) / d))
    ang = positions.to(torch.float32)[..., None] * div
    tab = torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1)
    return tab.reshape(*positions.shape, d).to(dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------
def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def swiglu_parallel(x: torch.Tensor, w_gate: torch.Tensor,
                    w_up: torch.Tensor, w_down: torch.Tensor, tp
                    ) -> torch.Tensor:
    """:func:`swiglu` over the model axis ``tp``
    (:class:`repro_torch.sharding.tensor_parallel.ModelAxis`): ``w_gate``
    and ``w_up`` column-split, ``w_down`` row-split, so each process
    computes its columns of the hidden layer whole and its partial sum of
    the output; x enters replicated, the sum leaves through ``tp.leave``
    (replicated, or a row-split stream's rows)."""
    return tp.leave(swiglu(tp.copy(x), w_gate, w_up, w_down))


def column_products(x: torch.Tensor, ws, fulls, tp=None, xs=None) -> list:
    """``[x @ w for w in ws]``, each whole on every process of the model
    axis ``tp``: a column-split ``w`` (``tp.is_split(w.shape[-1], full)``
    for its entry of ``fulls``) multiplies ``tp.copy(x)`` (or ``xs``, a
    copy the caller made) and the split products are gathered in one
    all-gather (a column split can cut through a head); a whole ``w``
    multiplies ``x`` as it is.  The results are replicated compute whose
    cotangents must be whole on every process: where they feed a
    process's own part of the work (its heads, its experts), they enter
    it through ``tp.copy``."""
    split = [tp is not None and tp.is_split(w.shape[-1], f)
             for w, f in zip(ws, fulls)]
    outs = [None if s else x @ w for w, s in zip(ws, split)]
    if any(split):
        xs = tp.copy(x) if xs is None else xs
        loc = [xs @ w for w, s in zip(ws, split) if s]
        widths = [t.shape[-1] for t in loc]
        lead = loc[0].shape[:-1]
        whole = tp.gather(torch.cat(loc, -1), -1).reshape(
            *lead, tp.size, sum(widths))
        parts = iter(torch.split(whole, widths, dim=-1))
        outs = [next(parts).reshape(*lead, -1) if s else o
                for o, s in zip(outs, split)]
    return outs


def row_parallel(a: torch.Tensor, w: torch.Tensor, tp=None) -> torch.Tensor:
    """``a @ w`` for a replicated ``a``; where ``tp`` splits ``w``'s rows,
    each process multiplies its part of ``a``'s columns and the partial
    sums are added over the axis (``tp.leave``: a sublayer's exit)."""
    if tp is None or not tp.is_split(w.shape[0], a.shape[-1]):
        return a @ w
    return tp.leave(tp.split(a, -1) @ w)


def gelu_mlp_init(gen: torch.Generator, d: int, d_ff: int, *, lead=(),
                  dtype=torch.float32) -> dict:
    lead, dev = tuple(lead), gen.device
    return {"w_in": dense_init(gen, d, d_ff, lead=lead, dtype=dtype),
            "b_in": torch.zeros(lead + (d_ff,), dtype=dtype, device=dev),
            "w_out": dense_init(gen, d_ff, d, lead=lead, dtype=dtype),
            "b_out": torch.zeros(lead + (d,), dtype=dtype, device=dev)}


def gelu_mlp(x: torch.Tensor, p, tp=None) -> torch.Tensor:
    """``jax.nn.gelu`` defaults to the tanh approximation, so this does.
    Over the model axis ``tp`` where it splits ``w_in``'s columns and
    ``w_out``'s rows: each process adds its part of the whole ``b_in``
    (through ``tp.split``, whose backward gathers the bias's gradient
    whole on every process) and its partial sum of the output is reduced
    before ``b_out``, added once."""
    if tp is None or not tp.is_split(p["w_in"].shape[-1],
                                     p["b_in"].shape[-1]):
        h = F.gelu(x @ p["w_in"] + p["b_in"], approximate="tanh")
        return h @ p["w_out"] + p["b_out"]
    h = F.gelu(tp.copy(x) @ p["w_in"] + tp.split(p["b_in"], -1),
               approximate="tanh")
    return tp.leave(h @ p["w_out"]) + p["b_out"]


# ---------------------------------------------------------------------------
# Losses (the paper models'; the LM's is ``transformer.lm_loss_chunked``)
# ---------------------------------------------------------------------------
def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean cross-entropy; logits (..., V), labels (...) integer.  The
    logsumexp minus the gold logit in fp32, then the mean, as JAX's
    ``softmax_xent`` computes it (``F.cross_entropy`` rounds otherwise).
    ``mask`` (...) in {0, 1} excludes positions (padding)."""
    logits32 = logits.to(torch.float32)
    logz = torch.logsumexp(logits32, dim=-1)
    gold = torch.gather(logits32, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.to(torch.float32)
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def accuracy(logits: torch.Tensor, labels: torch.Tensor,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Share of positions whose argmax (the first index on ties, as
    ``jnp.argmax``) is the label."""
    hit = (torch.argmax(logits, dim=-1) == labels.long()).to(torch.float32)
    if mask is not None:
        mask = mask.to(torch.float32)
        return torch.sum(hit * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(hit)
