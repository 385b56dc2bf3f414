"""The LM stack of the port (PyTorch port of ``repro/models/transformer.py``):
every architecture family of the JAX package.  Decoder layers are GQA
self-attention with RoPE (or sinusoidal absolute positions where
``rope_theta <= 0``, whisper) or DeepSeek's MLA, cross-attention to an
encoder's output (whisper, llama-3.2-vision), or Mamba2 SSD blocks (the
SSM family, and jamba's hybrid period); each followed by a SwiGLU MLP or a
capacity-routed MoE FFN where the config gives one, RMSNorm before each;
tied or untied head.  An encoder (pre-LN LayerNorm layers, non-causal
attention at ``enc_heads``, a GELU MLP; then a projection where its width
differs) turns the batch's precomputed ``enc_embeds`` into the keys and
values of the cross layers.  Training, prefill and decode.

The stack is organized in periods, as JAX's: the layer pattern repeats
with period ``P = lcm(attn_period, cross_every, moe.every)``, layer ``i``
is position ``i % P`` of period ``i // P`` and its kind is
``cfg.layer_kinds()[i % P]`` (jamba: mamba everywhere but position
``attn_period // 2``; whisper: cross-attention at odd positions).
Parameter layout is the JAX package's, so :mod:`repro_torch.bridge` is a
copy: ``blocks`` holds one entry per position in the period, every leaf
stacked over the ``num_layers // P`` periods, ``(num_layers // P, ...)``;
``encoder.layers`` is stacked over ``enc_layers``; dense weights are
``(in, out)``, used as ``x @ w``.  An encoder without layers and at the
model's width (llama-3.2-vision's stub) has no parameters at all, as
JAX's empty ``params["encoder"]`` has no leaves.  The module holds its
parameters on the ``meta`` device only; a forward always runs through
:func:`torch.func.functional_call` with a dict of real tensors
(``{"blocks.0.attn.wq": ..., "embed": ..., ...}``), which is what the
federated runtime differentiates with ``torch.func``.  No remat:
activation checkpointing does not compose with ``torch.func`` transforms.

Serving: ``forward(..., collect_cache=True)`` is the prefill — attention
through the flash-attention kernel (GQA at the config's head dim, MLA at
Dk 192 / Dv 128; the encoder's and the cross layers' non-causal), the
mamba blocks' SSD scan through its kernel — and returns the decode cache
in the JAX tree, ``{"layers": (entry, ...), "index": int32}`` and, with
an encoder, ``"enc_out"`` (B, L, d).  One entry per position in the
period, its tensors stacked over periods: ``{"k", "v"}`` (n, B, S, Hkv,
hd) (a cross layer's of the encoder's length L), MLA's ``{"ckv"}`` (n, B,
S, r) and ``{"krope"}`` (n, B, S, rd), or ``{"ssm"}`` (n, B, H, N, P) and
``{"conv"}`` (n, B, d_conv - 1, C).  :func:`decode_step` takes one token
per sequence against it.
"""
from __future__ import annotations

import math
from functools import partial
from operator import attrgetter
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.func import functional_call

from repro_torch.configs.base import ATTN, CROSS, MAMBA, ArchConfig
from repro_torch.core.flat import leaf_order
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.attention import (MLA_LEAVES, attend,
                                          decode_attention, gqa_attention,
                                          gqa_init, mla_attention,
                                          mla_decode_absorbed, mla_init)
from repro_torch.sharding.tensor_parallel import (ITEM_7C, vocab_embed,
                                                  vocab_xent)
from repro_torch.models.layers import (apply_rope, column_products,
                                       dense_init, embed_init, gelu_mlp,
                                       gelu_mlp_init, layernorm, rmsnorm,
                                       sinusoidal_positions, swiglu,
                                       swiglu_parallel)

Params = Dict[str, torch.Tensor]
ATTN_LEAVES = ("wq", "wk", "wv", "wo")
MLP_LEAVES = ("w_gate", "w_up", "w_down")
ENC_LAYER_LEAVES = ("attn.wk", "attn.wo", "attn.wq", "attn.wv", "ln1_b",
                    "ln1_s", "ln2_b", "ln2_s", "mlp.b_in", "mlp.b_out",
                    "mlp.w_in", "mlp.w_out")


def _meta(*shape) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device="meta"))


def _lcm(*xs) -> int:
    out = 1
    for x in xs:
        x = max(int(x), 1)
        out = out * x // math.gcd(out, x)
    return out


def period_of(cfg: ArchConfig) -> int:
    p = _lcm(cfg.attn_period, cfg.cross_every or 1,
             cfg.moe.every if cfg.moe else 1)
    assert cfg.num_layers % p == 0, (cfg.name, cfg.num_layers, p)
    return p


def period_kinds(cfg: ArchConfig) -> Tuple[str, ...]:
    """The kind (ATTN, CROSS or MAMBA) of each position in the period."""
    return cfg.layer_kinds()[:period_of(cfg)]


def _is_mla(cfg: ArchConfig, kind: str) -> bool:
    # a cross layer attends with plain GQA projections, MLA or not (JAX)
    return cfg.mla is not None and kind == ATTN


def _has_moe(cfg: ArchConfig, j: int) -> bool:
    return cfg.moe is not None and (j % cfg.moe.every == cfg.moe.every - 1)


def _has_mlp(cfg: ArchConfig, j: int) -> bool:
    return _has_moe(cfg, j) or cfg.d_ff > 0


class Attention(nn.Module):
    def __init__(self, L: int, d: int, h: int, hkv: int, hd: int):
        super().__init__()
        self.wq, self.wk = _meta(L, d, h * hd), _meta(L, d, hkv * hd)
        self.wv, self.wo = _meta(L, d, hkv * hd), _meta(L, h * hd, d)


class MLA(nn.Module):
    def __init__(self, L: int, d: int, h: int, hd: int, r: int, rd: int):
        super().__init__()
        self.w_dkv, self.w_kr = _meta(L, d, r), _meta(L, d, rd)
        self.w_uk, self.w_uv = _meta(L, r, h, hd), _meta(L, r, h, hd)
        self.wq, self.wo = _meta(L, d, h * (hd + rd)), _meta(L, h * hd, d)


class MLP(nn.Module):
    def __init__(self, L: int, d: int, d_ff: int):
        super().__init__()
        self.w_gate, self.w_up = _meta(L, d, d_ff), _meta(L, d, d_ff)
        self.w_down = _meta(L, d_ff, d)


class MoE(nn.Module):
    def __init__(self, L: int, d: int, cfg: ArchConfig):
        super().__init__()
        m = cfg.moe
        E, de = m.num_experts, m.d_expert or cfg.d_ff
        self.router = _meta(L, d, E)
        self.w_gate, self.w_up = _meta(L, E, d, de), _meta(L, E, d, de)
        self.w_down = _meta(L, E, de, d)
        if m.num_shared:
            self.shared = MLP(L, d, de * m.num_shared)


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
    """Position ``j`` of the period: its layers of every period, stacked."""

    def __init__(self, cfg: ArchConfig, j: int):
        super().__init__()
        L, d = cfg.num_layers // period_of(cfg), cfg.d_model
        hd = cfg.resolved_head_dim
        kind = cfg.layer_kinds()[j]
        if kind == MAMBA:
            self.mamba = Mamba(L, d, cfg)
        elif _is_mla(cfg, kind):
            self.attn = MLA(L, d, cfg.num_heads, hd, cfg.mla.kv_lora_rank,
                            cfg.mla.rope_head_dim)
        else:
            self.attn = Attention(L, d, cfg.num_heads, cfg.num_kv_heads, hd)
        if _has_mlp(cfg, j):
            self.mlp = (MoE(L, d, cfg) if _has_moe(cfg, j)
                        else MLP(L, d, cfg.d_ff))
            self.norm2 = _meta(L, d)
        self.norm1 = _meta(L, d)


class GeluMLP(nn.Module):
    def __init__(self, L: int, d: int, d_ff: int):
        super().__init__()
        self.w_in, self.b_in = _meta(L, d, d_ff), _meta(L, d_ff)
        self.w_out, self.b_out = _meta(L, d_ff, d), _meta(L, d)


class EncoderLayers(nn.Module):
    """The encoder's pre-LN layers, every leaf stacked over ``enc_layers``."""

    def __init__(self, cfg: ArchConfig):
        super().__init__()
        e = cfg.encoder
        L, d = e.enc_layers, e.enc_dim
        self.attn = Attention(L, d, e.enc_heads, e.enc_heads,
                              d // e.enc_heads)
        self.mlp = GeluMLP(L, d, e.enc_ff or 4 * d)
        self.ln1_s, self.ln1_b = _meta(L, d), _meta(L, d)
        self.ln2_s, self.ln2_b = _meta(L, d), _meta(L, d)


class Encoder(nn.Module):
    def __init__(self, cfg: ArchConfig):
        super().__init__()
        e = cfg.encoder
        if e.enc_dim != cfg.d_model:
            self.proj = _meta(e.enc_dim, cfg.d_model)
        if e.enc_layers > 0:
            self.layers = EncoderLayers(cfg)
            self.ln_f_s, self.ln_f_b = _meta(e.enc_dim), _meta(e.enc_dim)


def block_leaves(cfg: ArchConfig, j: int) -> List[str]:
    """The leaf paths of position ``j``'s block, relative to it."""
    names = ["norm1"]
    kind = cfg.layer_kinds()[j]
    if kind == MAMBA:
        names += [f"mamba.{n}" for n in ssm.LEAVES]
    else:
        leaves = MLA_LEAVES if _is_mla(cfg, kind) else ATTN_LEAVES
        names += [f"attn.{n}" for n in leaves]
    if _has_mlp(cfg, j):
        names.append("norm2")
        if _has_moe(cfg, j):
            names += [f"mlp.{n}" for n in moe_lib.LEAVES]
            if cfg.moe.num_shared:
                names += [f"mlp.shared.{n}" for n in MLP_LEAVES]
        else:
            names += [f"mlp.{n}" for n in MLP_LEAVES]
    return names


def _unstack(get, paths, n: int) -> List[dict]:
    """``n`` nested per-layer trees from the stacked leaves ``get(path)``,
    each ``(n, ...)``.  Each leaf is unbound once, so its gradient is one
    stack of the layers' gradients."""
    trees = [dict() for _ in range(n)]
    for path in paths:
        *parents, last = path.split(".")
        for tree, t in zip(trees, get(path).unbind(0)):
            for part in parents:
                tree = tree.setdefault(part, {})
            tree[last] = t
    return trees


def _layers(get, cfg: ArchConfig) -> List[dict]:
    """The per-layer parameter trees (the JAX per-layer layout) in layer
    order, from the stacked leaves; ``get(path)`` returns the leaf
    ``blocks.<path>`` (``path`` starts with the position in the period)."""
    P = period_of(cfg)
    per_layer = [None] * cfg.num_layers
    for j in range(P):
        trees = _unstack(lambda path: get(f"{j}.{path}"),
                         block_leaves(cfg, j), cfg.num_layers // P)
        for n, tree in enumerate(trees):
            per_layer[n * P + j] = tree
    return per_layer


def encode(get, enc_embeds: torch.Tensor, cfg: ArchConfig, attn_fn,
           tp=None) -> torch.Tensor:
    """enc_embeds: (B, L, enc_dim), the precomputed frame or patch
    embeddings (the modality frontend is a stub, as in JAX) -> (B, L,
    d_model).  ``get(path)`` returns the leaf ``encoder.<path>``;
    ``attn_fn(q, k, v, causal=False)`` is ``attend`` in training and the
    flash kernel's op in the prefill.  ``tp``: the model axis whose
    shards the leaves are (attention on each process's heads where the
    axis divides them, the GELU MLP split, the projection's columns
    gathered); the output comes back whole on every process."""
    e = cfg.encoder
    h = enc_embeds
    if e.enc_layers > 0:
        L = h.shape[1]
        hd = e.enc_dim // e.enc_heads
        h = h + sinusoidal_positions(torch.arange(L, device=h.device),
                                     e.enc_dim, h.dtype)[None]
        for lp in _unstack(lambda path: get(f"layers.{path}"),
                           ENC_LAYER_LEAVES, e.enc_layers):
            x = layernorm(h, lp["ln1_s"], lp["ln1_b"], cfg.norm_eps)
            y, _, _ = gqa_attention(x, lp["attn"], num_heads=e.enc_heads,
                                    num_kv_heads=e.enc_heads, head_dim=hd,
                                    causal=False, attn_fn=attn_fn, tp=tp)
            h = h + y
            x = layernorm(h, lp["ln2_s"], lp["ln2_b"], cfg.norm_eps)
            h = h + gelu_mlp(x, lp["mlp"], tp)
        h = layernorm(h, get("ln_f_s"), get("ln_f_b"), cfg.norm_eps)
    if e.enc_dim != cfg.d_model:
        (h,) = column_products(h, (get("proj"),), (cfg.d_model,), tp)
    return h


def _ffn(h: torch.Tensor, lp, cfg: ArchConfig, j: int, tp=None):
    """The layer's MLP or MoE on the residual stream; returns (h, aux).
    ``tp``: the model axis the MLP's or the MoE's weights are split over,
    or None."""
    if "mlp" not in lp:
        return h, None
    x2 = rmsnorm(h, lp["norm2"], cfg.norm_eps)
    if _has_moe(cfg, j):
        y2, aux = moe_lib.moe_ffn(x2, lp["mlp"], cfg.moe, tp)
        return h + y2, aux
    m = lp["mlp"]
    if tp is not None and tp.is_split(m["w_gate"].shape[-1], cfg.d_ff):
        return h + swiglu_parallel(x2, m["w_gate"], m["w_up"], m["w_down"],
                                   tp), None
    return h + swiglu(x2, m["w_gate"], m["w_up"], m["w_down"]), None


def _apply_layer(h: torch.Tensor, lp, cfg: ArchConfig, j: int,
                 positions: torch.Tensor, enc_out: Optional[torch.Tensor],
                 collect_cache: bool, tp=None):
    """One layer over the full sequence.  Returns (h, aux, cache_entry).
    ``tp``: the model axis (:class:`repro_torch.sharding.tensor_parallel.
    ModelAxis`) whose shards ``lp`` holds, in training (the prefill over
    the axis raises)."""
    x = rmsnorm(h, lp["norm1"], cfg.norm_eps)
    ce = None
    hd = cfg.resolved_head_dim
    kind = cfg.layer_kinds()[j]
    if tp is not None and collect_cache:
        raise NotImplementedError(
            f"{cfg.name}: the prefill over a model axis above 1 is not yet "
            f"ported to repro_torch ({ITEM_7C})")
    attn_fn = flash_attention if collect_cache else attend
    if kind == MAMBA:
        y = ssm.mamba_block(x, lp["mamba"], cfg.ssm,
                            collect_cache=collect_cache, tp=tp)
        if collect_cache:
            y, ce = y
    elif _is_mla(cfg, kind):
        y, ckv, krope = mla_attention(
            x, lp["attn"], positions, num_heads=cfg.num_heads, head_dim=hd,
            rope_head_dim=cfg.mla.rope_head_dim, rope_theta=cfg.rope_theta,
            attn_fn=partial(attn_fn, causal=True), tp=tp)
        if collect_cache:
            ce = {"ckv": ckv, "krope": krope}
    else:
        cross = kind == CROSS
        y, k, v = gqa_attention(
            x, lp["attn"], num_heads=cfg.num_heads,
            num_kv_heads=cfg.num_kv_heads, head_dim=hd, causal=not cross,
            attn_fn=attn_fn, positions=None if cross else positions,
            rope_theta=cfg.rope_theta, kv_x=enc_out if cross else None,
            tp=tp)
        if collect_cache:
            ce = {"k": k, "v": v}
    h, aux = _ffn(h + y, lp, cfg, j, tp)
    return h, aux, ce


class Transformer(nn.Module):
    def __init__(self, cfg: ArchConfig):
        super().__init__()
        self.cfg = cfg
        self.embed = _meta(cfg.vocab_size, cfg.d_model)
        self.final_norm = _meta(cfg.d_model)
        if not cfg.tie_embeddings:
            self.head = _meta(cfg.d_model, cfg.vocab_size)
        self.blocks = nn.ModuleList([Block(cfg, j)
                                     for j in range(period_of(cfg))])
        if cfg.encoder is not None:
            self.encoder = Encoder(cfg)

    def forward(self, tokens: torch.Tensor,
                enc_embeds: Optional[torch.Tensor] = None,
                collect_cache: bool = False, tp=None):
        """tokens: (B, S) int; ``enc_embeds`` (B, L, enc_dim) where the
        config has an encoder -> (pre-head hidden state (B, S, d), the MoE
        aux loss summed over layers (0 without MoE)), and with
        ``collect_cache`` (the prefill) also the decode cache.  ``tp``:
        the model axis whose shards the parameters are (tensor-parallel
        client compute, :mod:`repro_torch.sharding.tensor_parallel`); the
        hidden state comes back whole on every process."""
        cfg = self.cfg
        B, S = tokens.shape
        P = period_of(cfg)
        if tp is not None and tp.is_split(self.embed.shape[0],
                                          cfg.vocab_size):
            h = vocab_embed(tokens, self.embed, tp)
        else:
            h = F.embedding(tokens, self.embed)
        positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
        if cfg.rope_theta <= 0:          # whisper: absolute sinusoidal
            h = h + sinusoidal_positions(positions[0], cfg.d_model,
                                         h.dtype)[None]
        enc_out = None
        if cfg.encoder is not None:
            if enc_embeds is None:
                raise ValueError(f"{cfg.name} has an encoder: the batch "
                                 "needs 'enc_embeds'")
            enc_out = encode(lambda path: attrgetter(path)(self.encoder),
                             enc_embeds, cfg,
                             flash_attention if collect_cache else attend, tp)
        aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
        entries = [[] for _ in range(P)]
        for i, lp in enumerate(_layers(
                lambda path: attrgetter(path)(self.blocks), cfg)):
            h, a, ce = _apply_layer(h, lp, cfg, i % P, positions, enc_out,
                                    collect_cache, tp)
            if a is not None:
                aux = aux + a
            entries[i % P].append(ce)
        h = rmsnorm(h, self.final_norm, cfg.norm_eps)
        if not collect_cache:
            return h, aux
        layers = tuple({k: torch.stack([e[k] for e in es]) for k in es[0]}
                       for es in entries)
        index = torch.tensor(S, dtype=torch.int32, device=tokens.device)
        cache = {"layers": layers, "index": index}
        if enc_out is not None:
            cache["enc_out"] = enc_out
        return h, aux, cache


def _flatten(prefix: str, tree: dict, out: Params) -> None:
    for k, v in tree.items():
        if isinstance(v, dict):
            _flatten(f"{prefix}{k}.", v, out)
        else:
            out[prefix + k] = v


def init_transformer(cfg: ArchConfig, gen: torch.Generator,
                     dtype=torch.float32) -> Params:
    """Random parameters from ``gen`` on ``gen.device``: the JAX
    initializers' distributions (not their numbers — the two frameworks'
    generators differ; tests pass JAX parameters through the bridge)."""
    P, d = period_of(cfg), cfg.d_model
    n = cfg.num_layers // P
    dev = gen.device
    hd = cfg.resolved_head_dim
    ones = partial(torch.ones, dtype=torch.float32, device=dev)
    p: Params = {}
    # the draw order (mixers, embed, MLPs, head, encoder) fixes what a seed
    # gives
    for j, kind in enumerate(period_kinds(cfg)):
        if kind == MAMBA:
            mixer = {"mamba": ssm.mamba_init(gen, d, cfg.ssm, lead=(n,),
                                             dtype=dtype)}
        elif _is_mla(cfg, kind):
            mixer = {"attn": mla_init(gen, d, cfg.num_heads, hd,
                                      cfg.mla.kv_lora_rank,
                                      cfg.mla.rope_head_dim, lead=(n,),
                                      dtype=dtype)}
        else:
            mixer = {"attn": gqa_init(gen, d, cfg.num_heads,
                                      cfg.num_kv_heads, hd, lead=(n,),
                                      dtype=dtype)}
        _flatten(f"blocks.{j}.", mixer, p)
        p[f"blocks.{j}.norm1"] = ones((n, d))
    p["embed"] = embed_init(gen, cfg.vocab_size, d, dtype)
    p["final_norm"] = ones((d,))
    for j in range(P):
        if not _has_mlp(cfg, j):
            continue
        p[f"blocks.{j}.norm2"] = ones((n, d))
        if _has_moe(cfg, j):
            mlp = moe_lib.moe_init(gen, d, cfg.moe, cfg.d_ff, lead=(n,),
                                   dtype=dtype)
        else:
            mlp = {k: dense_init(gen, a, b, lead=(n,), dtype=dtype)
                   for k, (a, b) in (("w_gate", (d, cfg.d_ff)),
                                     ("w_up", (d, cfg.d_ff)),
                                     ("w_down", (cfg.d_ff, d)))}
        _flatten(f"blocks.{j}.mlp.", mlp, p)
    if not cfg.tie_embeddings:
        p["head"] = dense_init(gen, d, cfg.vocab_size, dtype=dtype)
    e = cfg.encoder
    if e is not None:
        if e.enc_dim != d:
            p["encoder.proj"] = dense_init(gen, e.enc_dim, d, dtype=dtype)
        if e.enc_layers > 0:
            L, de = e.enc_layers, e.enc_dim
            zeros = partial(torch.zeros, dtype=torch.float32, device=dev)
            _flatten("encoder.layers.", {
                "ln1_s": ones((L, de)), "ln1_b": zeros((L, de)),
                "attn": gqa_init(gen, de, e.enc_heads, e.enc_heads,
                                 de // e.enc_heads, lead=(L,), dtype=dtype),
                "ln2_s": ones((L, de)), "ln2_b": zeros((L, de)),
                "mlp": gelu_mlp_init(gen, de, e.enc_ff or 4 * de,
                                     lead=(L,), dtype=dtype)}, p)
            p["encoder.ln_f_s"], p["encoder.ln_f_b"] = ones((de,)), zeros(
                (de,))
    return {k: p[k] for k in leaf_order(p)}


def head_of(cfg: ArchConfig, params: Params) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["head"]


def lm_loss_chunked(module: Transformer, params: Params, tokens: torch.Tensor,
                    *, enc_embeds: Optional[torch.Tensor] = None,
                    mask: Optional[torch.Tensor] = None, chunk: int = 2048,
                    tp=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token loss with the vocab projection and cross-entropy taken
    over sequence chunks (the last one ragged), so the (B, S, V) logits
    never exist at once; plus the MoE aux loss.  ``mask`` (B, S) in {0,
    1}, aligned with ``tokens``, drops the positions it zeroes (shifted by
    one with the labels): cross-entropy and accuracy are means over the
    kept labels.  ``tp``: ``params`` are this process's shards over that
    model axis, the head's vocab split across it
    (:func:`repro_torch.sharding.tensor_parallel.vocab_xent`).  Returns
    (xent + aux, {"xent", "aux", "acc"})."""
    cfg = module.cfg
    inputs, labels = tokens[:, :-1], tokens[:, 1:]
    m = (torch.ones(labels.shape, dtype=torch.float32, device=labels.device)
         if mask is None else mask[:, 1:].to(torch.float32))
    h, aux = functional_call(module, params, (inputs,),
                             {"enc_embeds": enc_embeds, "tp": tp})
    head = head_of(cfg, params)
    vocab_split = tp is not None and tp.is_split(head.shape[-1],
                                                 cfg.vocab_size)
    S = h.shape[1]
    C = min(chunk, S)
    nll = hit = None
    for s0 in range(0, S, C):
        lc, mc = labels[:, s0:s0 + C], m[:, s0:s0 + C]
        if vocab_split:
            n, c = vocab_xent(h[:, s0:s0 + C], head, lc, mc, tp)
        else:
            logits = (h[:, s0:s0 + C] @ head).to(torch.float32)
            logz = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1, lc[..., None])[..., 0]
            n = torch.sum((logz - gold) * mc)
            c = torch.sum((torch.argmax(logits, dim=-1) == lc).to(
                torch.float32) * mc)
        nll = n if nll is None else nll + n
        hit = c if hit is None else hit + c
    cnt = torch.clamp(torch.sum(m), min=1.0)
    xent = nll / cnt
    return xent + aux, {"xent": xent, "aux": aux, "acc": hit / cnt}


# ---------------------------------------------------------------------------
# Decode (one token against the stacked cache)
# ---------------------------------------------------------------------------
def pad_cache(cache, cfg: ArchConfig, cache_len: int):
    """Grow a prefill cache's self-attention sequence axis (k / v, or MLA's
    ckv / krope) to ``cache_len`` (zero slots) so decode steps can write
    into it; mamba entries (constant state) and cross entries (the
    encoder's constant length) pass through, as does ``enc_out``."""
    layers = []
    for kind, ce in zip(period_kinds(cfg), cache["layers"]):
        pad = cache_len - next(iter(ce.values())).shape[2]
        layers.append(ce if kind in (MAMBA, CROSS) or pad <= 0 else {
            k: F.pad(t, [0, 0] * (t.dim() - 3) + [0, pad])   # axis 2
            for k, t in ce.items()})
    return {**cache, "layers": tuple(layers)}


def make_cache(cfg: ArchConfig, batch: int, cache_len: int,
               dtype=torch.float32, *, window: int = 0, device=None):
    """Zero-initialized decode cache.  ``cache_len`` is the self-attention
    cache length (the window instead when a sliding-window decode is
    used); mamba layers carry constant-size state and cross layers the
    encoder's keys and values (its ``enc_len``)."""
    n = cfg.num_layers // period_of(cfg)
    S = window if window > 0 else cache_len
    hd = cfg.resolved_head_dim
    layers = []
    for kind in period_kinds(cfg):
        if kind == MAMBA:
            layers.append(ssm.mamba_make_cache(batch, cfg.d_model, cfg.ssm,
                                               dtype, lead=(n,),
                                               device=device))
            continue
        if _is_mla(cfg, kind):
            shapes = {"ckv": (n, batch, S, cfg.mla.kv_lora_rank),
                      "krope": (n, batch, S, cfg.mla.rope_head_dim)}
        else:
            L = cfg.encoder.enc_len if kind == CROSS else S
            kv = (n, batch, L, cfg.num_kv_heads, hd)
            shapes = {"k": kv, "v": kv}
        layers.append({k: torch.zeros(s, dtype=dtype, device=device)
                       for k, s in shapes.items()})
    return {"layers": tuple(layers),
            "index": torch.zeros((), dtype=torch.int32, device=device)}


def decode_step(params: Params, tokens: torch.Tensor, cache,
                cfg: ArchConfig, *, window: int = 0):
    """tokens: (B,) or (B, 1) int — one new token per sequence.  Returns
    (logits (B, V), cache with ``index + 1``).  The cache's tensors are
    updated in place (the JAX step returns new arrays; the serving loop
    never reads an old cache again), so the step allocates no cache."""
    tokens = tokens.reshape(tokens.shape[0])
    B = tokens.shape[0]
    P = period_of(cfg)
    kinds = period_kinds(cfg)
    index = cache["index"]
    layers = _layers(lambda path: params[f"blocks.{path}"], cfg)
    hd = cfg.resolved_head_dim
    h = params["embed"][tokens]
    if cfg.rope_theta <= 0:              # the current token's position
        h = h + sinusoidal_positions(index.reshape(1), cfg.d_model, h.dtype)
    for i, lp in enumerate(layers):
        j, n = i % P, i // P
        ce = cache["layers"][j]
        x = rmsnorm(h, lp["norm1"], cfg.norm_eps)
        if kinds[j] == MAMBA:
            y, new = ssm.mamba_block_decode(
                x, lp["mamba"], cfg.ssm,
                {"ssm": ce["ssm"][n], "conv": ce["conv"][n]})
            ce["ssm"][n].copy_(new["ssm"])
            ce["conv"][n].copy_(new["conv"])
        elif _is_mla(cfg, kinds[j]):
            y = mla_decode_absorbed(
                x, lp["attn"], ce["ckv"][n], ce["krope"][n], index,
                num_heads=cfg.num_heads, head_dim=hd,
                rope_head_dim=cfg.mla.rope_head_dim,
                rope_theta=cfg.rope_theta)
        elif kinds[j] == CROSS:          # every encoder position is valid
            q = (x @ lp["attn"]["wq"]).reshape(B, cfg.num_heads, hd)
            k_cache, v_cache = ce["k"][n], ce["v"][n]
            a = decode_attention(q, k_cache, v_cache,
                                 index.new_tensor(k_cache.shape[1] - 1))
            y = a.reshape(B, -1) @ lp["attn"]["wo"]
        else:
            a_p = lp["attn"]
            pos = index.reshape(1, 1).expand(B, 1)
            q = (x @ a_p["wq"]).reshape(B, 1, cfg.num_heads, hd)
            k = (x @ a_p["wk"]).reshape(B, 1, cfg.num_kv_heads, hd)
            v = (x @ a_p["wv"]).reshape(B, 1, cfg.num_kv_heads, hd)
            q = apply_rope(q, pos, cfg.rope_theta)[:, 0]
            k = apply_rope(k, pos, cfg.rope_theta)
            k_cache, v_cache = ce["k"][n], ce["v"][n]
            slot = (index % k_cache.shape[1] if window > 0 else index)
            slot = slot.reshape(1).long()
            k_cache.index_copy_(1, slot, k.to(k_cache.dtype))
            v_cache.index_copy_(1, slot, v.to(v_cache.dtype))
            a = decode_attention(q, k_cache, v_cache, index, window=window)
            y = a.reshape(B, -1) @ a_p["wo"]
        # as a (B, 1, d) step: a MoE routes every token as its own group
        h = _ffn((h + y)[:, None], lp, cfg, j)[0][:, 0]
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    logits = h @ head_of(cfg, params)
    return logits, {**cache, "index": index + 1}
