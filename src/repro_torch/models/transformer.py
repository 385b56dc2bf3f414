"""Decoder-only LM of the port (PyTorch port of the dense and SSM subsets
of ``repro/models/transformer.py``): GQA attention with RoPE, SwiGLU MLP
and RMSNorm (the dense family), or Mamba2 SSD blocks with no MLP (the SSM
family); tied or untied head.  Training, prefill and decode.

Parameter layout is the JAX package's, so :mod:`repro_torch.bridge` is a
copy: every block leaf is stacked over layers, ``(num_layers, ...)``, and
dense weights are ``(in, out)``, used as ``x @ w``.  The module holds its
parameters on the ``meta`` device only; a forward always runs through
:func:`torch.func.functional_call` with a dict of real tensors
(``{"blocks.0.attn.wq": ..., "embed": ..., ...}``), which is what the
federated runtime differentiates with ``torch.func``.  No remat:
activation checkpointing does not compose with ``torch.func`` transforms.

Serving: ``forward(..., collect_cache=True)`` is the prefill — attention
through the flash-attention kernel, the mamba blocks' SSD scan through
its kernel — and returns the decode cache in the JAX tree, ``{"layers":
(entry,), "index": int32}``, each entry's tensors stacked over layers
(``{"k", "v"}`` (L, B, S, Hkv, hd) or ``{"ssm"}`` (L, B, H, N, P) and
``{"conv"}`` (L, B, d_conv - 1, C)).  :func:`decode_step` takes one
token per sequence against it.  The port's architectures have one layer
kind each (a period of 1), so ``blocks`` has one entry.
"""
from __future__ import annotations

from operator import attrgetter
from typing import Dict, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.func import functional_call

from repro_torch.configs.base import MAMBA, ArchConfig
from repro_torch.core.flat import leaf_order
from repro_torch.models import ssm
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.attention import (attend, decode_attention, gqa_init,
                                          gqa_project_qkv)
from repro_torch.models.layers import (apply_rope, dense_init, embed_init,
                                       rmsnorm, swiglu)

Params = Dict[str, torch.Tensor]
ATTN_LEAVES = ("wq", "wk", "wv", "wo")
MLP_LEAVES = ("w_gate", "w_up", "w_down")


def _meta(*shape) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device="meta"))


def is_ssm(cfg: ArchConfig) -> bool:
    return cfg.layer_kinds()[0] == MAMBA


class Attention(nn.Module):
    def __init__(self, L: int, d: int, h: int, hkv: int, hd: int):
        super().__init__()
        self.wq, self.wk = _meta(L, d, h * hd), _meta(L, d, hkv * hd)
        self.wv, self.wo = _meta(L, d, hkv * hd), _meta(L, h * hd, d)


class MLP(nn.Module):
    def __init__(self, L: int, d: int, d_ff: int):
        super().__init__()
        self.w_gate, self.w_up = _meta(L, d, d_ff), _meta(L, d, d_ff)
        self.w_down = _meta(L, d_ff, d)


class Mamba(nn.Module):
    def __init__(self, L: int, d: int, cfg: ArchConfig):
        super().__init__()
        s = cfg.ssm
        d_in, H, conv_dim = ssm.dims(d, s)
        GN = s.n_groups * s.d_state
        self.A_log, self.D, self.dt_bias = (_meta(L, H) for _ in range(3))
        self.conv_w = _meta(L, s.d_conv, conv_dim)
        self.in_proj = _meta(L, d, 2 * d_in + 2 * GN + H)
        self.out_proj = _meta(L, d_in, d)


class Block(nn.Module):
    """All ``L`` layers of one position in the period, stacked."""

    def __init__(self, cfg: ArchConfig):
        super().__init__()
        L, d = cfg.num_layers, cfg.d_model
        if is_ssm(cfg):
            self.mamba = Mamba(L, d, cfg)
        else:
            self.attn = Attention(L, d, cfg.num_heads, cfg.num_kv_heads,
                                  cfg.resolved_head_dim)
        if cfg.d_ff > 0:
            self.mlp = MLP(L, d, cfg.d_ff)
            self.norm2 = _meta(L, d)
        self.norm1 = _meta(L, d)


def _layers(get, cfg: ArchConfig):
    """The per-layer parameter trees (the JAX per-layer layout), from the
    stacked leaves; ``get(path)`` returns the leaf ``blocks.0.<path>``.
    Each stacked leaf is unbound once, so its gradient is one stack of
    the layers' gradients."""
    groups = [("", ("norm1",))]
    groups.append(("mamba.", ssm.LEAVES) if is_ssm(cfg)
                  else ("attn.", ATTN_LEAVES))
    if cfg.d_ff > 0:
        groups += [("", ("norm2",)), ("mlp.", MLP_LEAVES)]
    per_layer = [dict() for _ in range(cfg.num_layers)]
    for prefix, names in groups:
        for n in names:
            for lp, t in zip(per_layer, get(prefix + n).unbind(0)):
                (lp.setdefault(prefix[:-1], {}) if prefix else lp)[n] = t
    return per_layer


def _mlp(h: torch.Tensor, lp, cfg: ArchConfig) -> torch.Tensor:
    if cfg.d_ff <= 0:
        return h
    m = lp["mlp"]
    x2 = rmsnorm(h, lp["norm2"], cfg.norm_eps)
    return h + swiglu(x2, m["w_gate"], m["w_up"], m["w_down"])


def _apply_layer(h: torch.Tensor, lp, cfg: ArchConfig,
                 positions: torch.Tensor, collect_cache: bool):
    """One layer over the full sequence.  Returns (h, cache_entry)."""
    B, S, _ = h.shape
    x = rmsnorm(h, lp["norm1"], cfg.norm_eps)
    ce = None
    if is_ssm(cfg):
        y = ssm.mamba_block(x, lp["mamba"], cfg.ssm,
                            collect_cache=collect_cache)
        if collect_cache:
            y, ce = y
    else:
        a_p = lp["attn"]
        hd = cfg.resolved_head_dim
        q, k, v = gqa_project_qkv(x, a_p["wq"], a_p["wk"], a_p["wv"],
                                  cfg.num_heads, cfg.num_kv_heads, hd)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        a = (flash_attention(q, k, v, causal=True) if collect_cache
             else attend(q, k, v, causal=True))
        y = a.reshape(B, S, -1) @ a_p["wo"]
        if collect_cache:
            ce = {"k": k, "v": v}
    return _mlp(h + y, lp, cfg), ce


class Transformer(nn.Module):
    def __init__(self, cfg: ArchConfig):
        super().__init__()
        self.cfg = cfg
        self.embed = _meta(cfg.vocab_size, cfg.d_model)
        self.final_norm = _meta(cfg.d_model)
        if not cfg.tie_embeddings:
            self.head = _meta(cfg.d_model, cfg.vocab_size)
        self.blocks = nn.ModuleList([Block(cfg)])

    def forward(self, tokens: torch.Tensor, collect_cache: bool = False):
        """tokens: (B, S) int -> pre-head hidden state (B, S, d), and with
        ``collect_cache`` (the prefill) also the decode cache."""
        cfg = self.cfg
        B, S = tokens.shape
        blk = self.blocks[0]
        h = self.embed[tokens]
        positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
        entries = []
        for lp in _layers(lambda path: attrgetter(path)(blk), cfg):
            h, ce = _apply_layer(h, lp, cfg, positions, collect_cache)
            entries.append(ce)
        h = rmsnorm(h, self.final_norm, cfg.norm_eps)
        if not collect_cache:
            return h
        stacked = {k: torch.stack([e[k] for e in entries])
                   for k in entries[0]}
        index = torch.tensor(S, dtype=torch.int32, device=tokens.device)
        return h, {"layers": (stacked,), "index": index}


def init_transformer(cfg: ArchConfig, gen: torch.Generator,
                     dtype=torch.float32) -> Params:
    """Random parameters from ``gen`` on ``gen.device``: the JAX
    initializers' distributions (not their numbers — the two frameworks'
    generators differ; tests pass JAX parameters through the bridge)."""
    L, d = cfg.num_layers, cfg.d_model
    dev = gen.device
    # the draw order (block, embed, MLP, head) fixes what a seed gives
    if is_ssm(cfg):
        block = {f"mamba.{k}": v for k, v in ssm.mamba_init(
            gen, d, cfg.ssm, lead=(L,), dtype=dtype).items()}
    else:
        block = {f"attn.{k}": v for k, v in gqa_init(
            gen, d, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim,
            lead=(L,), dtype=dtype).items()}
    p: Params = {
        "embed": embed_init(gen, cfg.vocab_size, d, dtype),
        "final_norm": torch.ones((d,), dtype=torch.float32, device=dev),
        "blocks.0.norm1": torch.ones((L, d), dtype=torch.float32, device=dev),
    }
    if cfg.d_ff > 0:
        p.update({
            "blocks.0.norm2": torch.ones((L, d), dtype=torch.float32,
                                         device=dev),
            "blocks.0.mlp.w_gate": dense_init(gen, d, cfg.d_ff, lead=(L,),
                                              dtype=dtype),
            "blocks.0.mlp.w_up": dense_init(gen, d, cfg.d_ff, lead=(L,),
                                            dtype=dtype),
            "blocks.0.mlp.w_down": dense_init(gen, cfg.d_ff, d, lead=(L,),
                                              dtype=dtype),
        })
    p.update({f"blocks.0.{k}": v for k, v in block.items()})
    if not cfg.tie_embeddings:
        p["head"] = dense_init(gen, d, cfg.vocab_size, dtype=dtype)
    return {k: p[k] for k in leaf_order(p)}


def head_of(cfg: ArchConfig, params: Params) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["head"]


def lm_loss_chunked(module: Transformer, params: Params, tokens: torch.Tensor,
                    *, chunk: int = 2048
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token loss with the vocab projection and cross-entropy taken
    over sequence chunks, so the (B, S, V) logits never exist at once.
    Returns (loss, {"xent", "aux", "acc"})."""
    cfg = module.cfg
    inputs, labels = tokens[:, :-1], tokens[:, 1:]
    h = functional_call(module, params, (inputs,))
    head = head_of(cfg, params)
    S = h.shape[1]
    C = min(chunk, S)
    nll = hit = None
    for s0 in range(0, S, C):
        logits = (h[:, s0:s0 + C] @ head).to(torch.float32)
        lc = labels[:, s0:s0 + C]
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lc[..., None])[..., 0]
        n = torch.sum(logz - gold)
        c = torch.sum((torch.argmax(logits, dim=-1) == lc).to(torch.float32))
        nll = n if nll is None else nll + n
        hit = c if hit is None else hit + c
    cnt = float(max(labels.numel(), 1))
    xent = nll / cnt
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return xent + aux, {"xent": xent, "aux": aux, "acc": hit / cnt}


# ---------------------------------------------------------------------------
# Decode (one token against the stacked cache)
# ---------------------------------------------------------------------------
def pad_cache(cache, cfg: ArchConfig, cache_len: int):
    """Grow a prefill cache's attention sequence axis to ``cache_len`` (zero
    slots) so decode steps can write into it; mamba entries carry constant
    state and pass through."""
    if is_ssm(cfg):
        return cache
    (ce,) = cache["layers"]
    S = ce["k"].shape[2]
    if S >= cache_len:
        return cache
    pad = [0, 0, 0, 0, 0, cache_len - S]            # axis 2 of (L, B, S, ...)
    return {"layers": ({k: F.pad(t, pad) for k, t in ce.items()},),
            "index": cache["index"]}


def make_cache(cfg: ArchConfig, batch: int, cache_len: int,
               dtype=torch.float32, *, window: int = 0, device=None):
    """Zero-initialized decode cache.  ``cache_len`` is the attention cache
    length (the window instead when a sliding-window decode is used);
    mamba layers carry constant-size state."""
    L = cfg.num_layers
    if is_ssm(cfg):
        ce = ssm.mamba_make_cache(batch, cfg.d_model, cfg.ssm, dtype,
                                  lead=(L,), device=device)
    else:
        S = window if window > 0 else cache_len
        shape = (L, batch, S, cfg.num_kv_heads, cfg.resolved_head_dim)
        ce = {"k": torch.zeros(shape, dtype=dtype, device=device),
              "v": torch.zeros(shape, dtype=dtype, device=device)}
    return {"layers": (ce,),
            "index": torch.zeros((), dtype=torch.int32, device=device)}


def decode_step(params: Params, tokens: torch.Tensor, cache,
                cfg: ArchConfig, *, window: int = 0):
    """tokens: (B,) or (B, 1) int — one new token per sequence.  Returns
    (logits (B, V), cache with ``index + 1``).  The cache's tensors are
    updated in place (the JAX step returns new arrays; the serving loop
    never reads an old cache again), so the step allocates no cache."""
    tokens = tokens.reshape(tokens.shape[0])
    B = tokens.shape[0]
    index = cache["index"]
    (ce,) = cache["layers"]
    layers = _layers(lambda path: params[f"blocks.0.{path}"], cfg)
    h = params["embed"][tokens]
    for i, lp in enumerate(layers):
        x = rmsnorm(h, lp["norm1"], cfg.norm_eps)
        if is_ssm(cfg):
            y, new = ssm.mamba_block_decode(
                x, lp["mamba"], cfg.ssm,
                {"ssm": ce["ssm"][i], "conv": ce["conv"][i]})
            ce["ssm"][i].copy_(new["ssm"])
            ce["conv"][i].copy_(new["conv"])
        else:
            a_p, hd = lp["attn"], cfg.resolved_head_dim
            pos = index.reshape(1, 1).expand(B, 1)
            q = (x @ a_p["wq"]).reshape(B, 1, cfg.num_heads, hd)
            k = (x @ a_p["wk"]).reshape(B, 1, cfg.num_kv_heads, hd)
            v = (x @ a_p["wv"]).reshape(B, 1, cfg.num_kv_heads, hd)
            q = apply_rope(q, pos, cfg.rope_theta)[:, 0]
            k = apply_rope(k, pos, cfg.rope_theta)
            k_cache, v_cache = ce["k"][i], ce["v"][i]
            slot = (index % k_cache.shape[1] if window > 0 else index)
            slot = slot.reshape(1).long()
            k_cache.index_copy_(1, slot, k.to(k_cache.dtype))
            v_cache.index_copy_(1, slot, v.to(v_cache.dtype))
            a = decode_attention(q, k_cache, v_cache, index, window=window)
            y = a.reshape(B, -1) @ a_p["wo"]
        h = _mlp(h + y, lp, cfg)
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    logits = h @ head_of(cfg, params)
    return logits, {"layers": cache["layers"], "index": index + 1}
