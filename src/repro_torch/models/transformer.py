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

Serving over a mesh (``tp`` a :func:`repro_torch.sharding.tensor_parallel.
serve_axis`, whose :class:`~repro_torch.sharding.tensor_parallel.Serving`
names the mesh, the request's global batch and the cache's whole length):
each process holds its rows of the batch, its model-axis shards of the
parameters and its part of the cache, as JAX's ``cache_shardings``
places it.  The prefill runs every layer kind as training does on the
axis (flash attention and the SSD scan on the process's heads where the
axis divides them), then pads each layer's self-attention entry to the
cache's length and keeps the process's part (:func:`place_entry`: the
keys and values of all heads at its positions, one all-gather of the
heads where they were split; the SSM state of its heads, the conv state
of its channels).  :func:`decode_step` runs each layer against those
parts (``models/attention.py``'s sharded decodes, ``ssm.
mamba_block_decode(tp=)``, the MoE on the axis), and the logits come
back whole on every process, gathered over the vocab split.
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
                                          cross_decode_sharded,
                                          decode_attention, gqa_attention,
                                          gqa_decode_sharded, gqa_init,
                                          mla_attention, mla_decode_absorbed,
                                          mla_decode_sharded, mla_init)
from repro_torch.sharding.tensor_parallel import (Serving, vocab_embed,
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


def _ffn(h: torch.Tensor, lp, cfg: ArchConfig, j: int, tp=None,
         rows: Optional[int] = None):
    """The layer's MLP or MoE on the residual stream; returns (h, aux).
    ``tp``: the model axis the MLP's or the MoE's weights are split over,
    or None; ``rows``: the client's batch rows where ``h`` is this
    process's rows of them (:func:`_sublayer`)."""
    if "mlp" not in lp:
        return h, None
    m, aux = lp["mlp"], []

    def ffn(x2):
        if _has_moe(cfg, j):
            y2, a = moe_lib.moe_ffn(x2, m, cfg.moe, tp)
            aux.append(a)
            return y2
        if tp is not None and tp.is_split(m["w_gate"].shape[-1], cfg.d_ff):
            return swiglu_parallel(x2, m["w_gate"], m["w_up"], m["w_down"],
                                   tp)
        return swiglu(x2, m["w_gate"], m["w_up"], m["w_down"])
    y2 = _sublayer(h, lp["norm2"], cfg, ffn, tp, rows)
    return h + y2, (aux[0] if aux else None)


def _sublayer(h: torch.Tensor, scale: torch.Tensor, cfg: ArchConfig, fn,
              tp=None, rows: Optional[int] = None) -> torch.Tensor:
    """``fn(rmsnorm(h))``, the sublayer's output.  Where the residual
    stream is row-split over the model axis (``rows``: the batch rows of
    the client, ``h`` this process's of them), the norm runs on the rows
    (its whole scale entering through ``tp.copy``, so its gradient sums
    every process's rows), the sublayer's input is gathered whole and its
    output comes back as this process's rows
    (:meth:`repro_torch.sharding.tensor_parallel.ModelAxis.row_sublayer`)."""
    if rows is None:
        return fn(rmsnorm(h, scale, cfg.norm_eps))
    return tp.row_sublayer(rmsnorm(h, tp.copy(scale), cfg.norm_eps), rows,
                           fn)


def cache_shapes(cfg: ArchConfig, batch: int, cache_len: int
                 ) -> List[Dict[str, Tuple[int, ...]]]:
    """The whole shape of every decode-cache leaf, one dict per position
    in the period, each leaf stacked over periods: ``cache_len`` is the
    self-attention length (the window under a sliding-window decode)."""
    n = cfg.num_layers // period_of(cfg)
    hd = cfg.resolved_head_dim
    out = []
    for kind in period_kinds(cfg):
        if kind == MAMBA:
            s = cfg.ssm
            _, H, conv_dim = ssm.dims(cfg.d_model, s)
            out.append({"ssm": (n, batch, H, s.d_state, s.d_head),
                        "conv": (n, batch, s.d_conv - 1, conv_dim)})
        elif _is_mla(cfg, kind):
            out.append({"ckv": (n, batch, cache_len, cfg.mla.kv_lora_rank),
                        "krope": (n, batch, cache_len,
                                  cfg.mla.rope_head_dim)})
        else:
            L = cfg.encoder.enc_len if kind == CROSS else cache_len
            kv = (n, batch, L, cfg.num_kv_heads, hd)
            out.append({"k": kv, "v": kv})
    return out


def _serving(tp) -> Serving:
    if tp is None or tp.serving is None:
        raise ValueError("serving on a mesh takes the axis serve_axis "
                         "builds (its mesh, global batch and cache length)")
    return tp.serving


def place_entry(ce: Dict[str, torch.Tensor], cfg: ArchConfig, j: int, tp
                ) -> Dict[str, torch.Tensor]:
    """One layer's prefill cache entry at position ``j`` of the period ->
    this process's part of it (``tp.serving``): the keys and values of
    heads the model axis split gathered whole, a self-attention entry
    padded with zero slots to the cache's length, then every leaf sliced
    as ``cache_shardings`` places it (a dim this process holds its part
    of already, its heads' SSM state, stays)."""
    sv = _serving(tp)
    shapes = cache_shapes(cfg, sv.batch, sv.cache_len)[j]
    kind = period_kinds(cfg)[j]
    out = {}
    for key, t in ce.items():
        whole = shapes[key][1:]
        if key in ("k", "v") and t.shape[2] != whole[2]:
            t = tp.gather(t, 2)
        if kind != MAMBA and kind != CROSS and t.shape[1] != whole[1]:
            if t.shape[1] > whole[1]:
                raise ValueError(f"{cfg.name}: a prompt of {t.shape[1]} "
                                 f"does not fit a cache of {whole[1]}")
            t = F.pad(t, [0, 0] * (t.dim() - 2) + [0, whole[1] - t.shape[1]])
        out[key] = sv.place(key, t, whole)
    return out


def _apply_layer(h: torch.Tensor, lp, cfg: ArchConfig, j: int,
                 positions: torch.Tensor, enc_out: Optional[torch.Tensor],
                 collect_cache: bool, tp=None, rows: Optional[int] = None):
    """One layer over the full sequence.  Returns (h, aux, cache_entry).
    ``tp``: the model axis (:class:`repro_torch.sharding.tensor_parallel.
    ModelAxis`) whose shards ``lp`` holds; in the prefill the one
    ``serve_axis`` builds, and the entry is this process's part of the
    cache (:func:`place_entry`).  ``rows``: the residual stream ``h`` is
    this process's rows of the client's ``rows`` (:func:`_sublayer`)."""
    hd = cfg.resolved_head_dim
    kind = cfg.layer_kinds()[j]
    attn_fn = flash_attention if collect_cache else attend
    cache = []

    def mixer(x):
        if kind == MAMBA:
            y = ssm.mamba_block(x, lp["mamba"], cfg.ssm,
                                collect_cache=collect_cache, tp=tp)
            if collect_cache:
                y, ce = y
                cache.append(ce)
            return y
        if _is_mla(cfg, kind):
            y, ckv, krope = mla_attention(
                x, lp["attn"], positions, num_heads=cfg.num_heads,
                head_dim=hd, rope_head_dim=cfg.mla.rope_head_dim,
                rope_theta=cfg.rope_theta,
                attn_fn=partial(attn_fn, causal=True), tp=tp)
            cache.append({"ckv": ckv, "krope": krope})
            return y
        cross = kind == CROSS
        y, k, v = gqa_attention(
            x, lp["attn"], num_heads=cfg.num_heads,
            num_kv_heads=cfg.num_kv_heads, head_dim=hd, causal=not cross,
            attn_fn=attn_fn, positions=None if cross else positions,
            rope_theta=cfg.rope_theta, kv_x=enc_out if cross else None,
            tp=tp)
        cache.append({"k": k, "v": v})
        return y
    y = _sublayer(h, lp["norm1"], cfg, mixer, tp, rows)
    ce = cache[0] if collect_cache else None
    if collect_cache and tp is not None:
        ce = place_entry(ce, cfg, j, tp)
    h, aux = _ffn(h + y, lp, cfg, j, tp, rows)
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
        hidden state comes back whole on every process, and the prefill's
        cache is this process's part (the module docstring).  Where the
        axis's ``act_rows`` is set (and not in the prefill), the residual
        stream between sublayers is each process's batch rows, gathered
        whole before the final norm (:func:`_sublayer`)."""
        cfg = self.cfg
        B, S = tokens.shape
        rows = (B if tp is not None and tp.act_rows and not collect_cache
                else None)
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
        if rows is not None:
            h = tp.rows(h, rows)
        for i, lp in enumerate(_layers(
                lambda path: attrgetter(path)(self.blocks), cfg)):
            h, a, ce = _apply_layer(h, lp, cfg, i % P, positions, enc_out,
                                    collect_cache, tp, rows)
            if a is not None:
                aux = aux + a
            entries[i % P].append(ce)
        if rows is not None:
            h = tp.gather_rows(h, rows)
        h = rmsnorm(h, self.final_norm, cfg.norm_eps)
        if not collect_cache:
            return h, aux
        layers = tuple({k: torch.stack([e[k] for e in es]) for k in es[0]}
                       for es in entries)
        index = torch.tensor(S, dtype=torch.int32, device=tokens.device)
        cache = {"layers": layers, "index": index}
        if enc_out is not None:
            if tp is not None:
                enc_out = _serving(tp).place(
                    "enc_out", enc_out, (_serving(tp).batch,)
                    + tuple(enc_out.shape[1:]), stacked=False)
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


def logits_of(cfg: ArchConfig, params: Params, h: torch.Tensor, tp=None
              ) -> torch.Tensor:
    """h (..., d) through the vocab projection: whole on every process
    of the model axis ``tp``, gathered where it splits the vocab."""
    head = head_of(cfg, params)
    logits = h @ head
    if tp is not None and tp.is_split(head.shape[-1], cfg.vocab_size):
        logits = tp.gather(logits, -1)
    return logits


def _embed(cfg: ArchConfig, params: Params, tokens: torch.Tensor, tp=None
           ) -> torch.Tensor:
    embed = params["embed"]
    if tp is not None and tp.is_split(embed.shape[0], cfg.vocab_size):
        return vocab_embed(tokens, embed, tp)
    return embed[tokens]


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
               dtype=torch.float32, *, window: int = 0, device=None,
               mesh=None):
    """Zero-initialized decode cache.  ``cache_len`` is the self-attention
    cache length (the window instead when a sliding-window decode is
    used); mamba layers carry constant-size state and cross layers the
    encoder's keys and values (its ``enc_len``).  With ``mesh``, this
    process's part of the cache of a global ``batch``, as
    ``cache_shardings`` places it."""
    S = window if window > 0 else cache_len
    sv = None if mesh is None else Serving(mesh, batch, S)
    layers = []
    for shapes in cache_shapes(cfg, batch, S):
        layers.append({k: torch.zeros(
            shape if sv is None else sv.local_shape(k, shape),
            dtype=torch.float32 if k == "ssm" else dtype, device=device)
            for k, shape in shapes.items()})
    return {"layers": tuple(layers),
            "index": torch.zeros((), dtype=torch.int32, device=device)}


def decode_step(params: Params, tokens: torch.Tensor, cache,
                cfg: ArchConfig, *, window: int = 0, tp=None):
    """tokens: (B,) or (B, 1) int — one new token per sequence.  Returns
    (logits (B, V), cache with ``index + 1``).  The cache's tensors are
    updated in place (the JAX step returns new arrays; the serving loop
    never reads an old cache again), so the step allocates no cache.
    ``tp``: serving on a mesh (``serve_axis``): ``params`` are this
    process's shards, ``tokens`` its rows of the batch and ``cache`` its
    part (the module docstring); the logits come back whole."""
    if tp is not None:
        return _decode_step_sharded(params, tokens, cache, cfg,
                                    window=window, tp=tp)
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


def _decode_step_sharded(params: Params, tokens: torch.Tensor, cache,
                         cfg: ArchConfig, *, window: int, tp):
    """:func:`decode_step` on a mesh (its ``tp``)."""
    sv = _serving(tp)
    tokens = tokens.reshape(tokens.shape[0])
    P = period_of(cfg)
    kinds = period_kinds(cfg)
    index = cache["index"]
    hd = cfg.resolved_head_dim
    seqs = []
    for j, shapes in enumerate(cache_shapes(cfg, sv.batch, sv.cache_len)):
        ce = cache["layers"][j]
        seqs.append({})
        for key, shape in shapes.items():
            if tuple(ce[key].shape[2:]) != sv.local_shape(key, shape)[2:]:
                raise ValueError(
                    f"{cfg.name}: cache leaf {key!r} of position {j} is "
                    f"{tuple(ce[key].shape)}; this process's part of "
                    f"{shape} on the mesh is {sv.local_shape(key, shape)}")
            if kinds[j] != MAMBA:
                seqs[j][key] = sv.seq_split(key, shape)
    h = _embed(cfg, params, tokens, tp)
    if cfg.rope_theta <= 0:              # the current token's position
        h = h + sinusoidal_positions(index.reshape(1), cfg.d_model, h.dtype)
    for i, lp in enumerate(_layers(lambda path: params[f"blocks.{path}"],
                                   cfg)):
        j, n = i % P, i // P
        ce = cache["layers"][j]
        x = rmsnorm(h, lp["norm1"], cfg.norm_eps)
        if kinds[j] == MAMBA:
            y, new = ssm.mamba_block_decode(
                x, lp["mamba"], cfg.ssm,
                {"ssm": ce["ssm"][n], "conv": ce["conv"][n]}, tp=tp)
            ce["ssm"][n].copy_(new["ssm"])
            ce["conv"][n].copy_(new["conv"])
        elif _is_mla(cfg, kinds[j]):
            y = mla_decode_sharded(
                x, lp["attn"], ce["ckv"][n], ce["krope"][n], index,
                num_heads=cfg.num_heads, head_dim=hd,
                rope_head_dim=cfg.mla.rope_head_dim,
                rope_theta=cfg.rope_theta, seq=seqs[j]["ckv"], tp=tp)
        elif kinds[j] == CROSS:          # every encoder position is valid
            y = cross_decode_sharded(
                x, lp["attn"], ce["k"][n], ce["v"][n],
                num_heads=cfg.num_heads, head_dim=hd, seq=seqs[j]["k"],
                tp=tp)
        else:
            y = gqa_decode_sharded(
                x, lp["attn"], ce["k"][n], ce["v"][n], index,
                num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
                head_dim=hd, rope_theta=cfg.rope_theta, window=window,
                seq=seqs[j]["k"], tp=tp)
        h = _ffn((h + y)[:, None], lp, cfg, j, tp)[0][:, 0]
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    return logits_of(cfg, params, h, tp), {**cache, "index": index + 1}
