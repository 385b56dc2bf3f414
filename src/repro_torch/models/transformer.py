"""Decoder-only LM of the port (PyTorch port of the dense, MoE and SSM
subsets of ``repro/models/transformer.py``): GQA attention with RoPE or
DeepSeek's MLA, a SwiGLU MLP or a capacity-routed MoE FFN, and RMSNorm
(the dense and MoE families), or Mamba2 SSD blocks with no MLP (the SSM
family); tied or untied head.  Training, prefill and decode.

The stack is organized in periods, as JAX's: the layer pattern repeats
with period ``P = lcm(attn_period, cross_every, moe.every)`` (in the port,
whose architectures have one attention or mixer kind, that is
``moe.every``), layer ``i`` is position ``i % P`` of period ``i // P``.
Parameter layout is the JAX package's, so :mod:`repro_torch.bridge` is a
copy: ``blocks`` holds one entry per position in the period, every leaf
stacked over the ``num_layers // P`` periods, ``(num_layers // P, ...)``,
and dense weights are ``(in, out)``, used as ``x @ w``.  The module holds
its parameters on the ``meta`` device only; a forward always runs through
:func:`torch.func.functional_call` with a dict of real tensors
(``{"blocks.0.attn.wq": ..., "embed": ..., ...}``), which is what the
federated runtime differentiates with ``torch.func``.  No remat:
activation checkpointing does not compose with ``torch.func`` transforms.

Serving: ``forward(..., collect_cache=True)`` is the prefill — attention
through the flash-attention kernel (GQA at the config's head dim, MLA at
Dk 192 / Dv 128), the mamba blocks' SSD scan through its kernel — and
returns the decode cache in the JAX tree, ``{"layers": (entry, ...),
"index": int32}``, one entry per position in the period, its tensors
stacked over periods (``{"k", "v"}`` (n, B, S, Hkv, hd), MLA's ``{"ckv"}``
(n, B, S, r) and ``{"krope"}`` (n, B, S, rd), or ``{"ssm"}`` (n, B, H, N,
P) and ``{"conv"}`` (n, B, d_conv - 1, C)).  :func:`decode_step` takes
one token per sequence against it.
"""
from __future__ import annotations

import math
from operator import attrgetter
from typing import Dict, List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.func import functional_call

from repro_torch.configs.base import MAMBA, ArchConfig
from repro_torch.core.flat import leaf_order
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.attention import (MLA_LEAVES, attend,
                                          decode_attention, gqa_init,
                                          gqa_project_qkv, mla_attention,
                                          mla_decode_absorbed, mla_init)
from repro_torch.models.layers import (apply_rope, dense_init, embed_init,
                                       rmsnorm, swiglu)

Params = Dict[str, torch.Tensor]
ATTN_LEAVES = ("wq", "wk", "wv", "wo")
MLP_LEAVES = ("w_gate", "w_up", "w_down")


def _meta(*shape) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device="meta"))


def is_ssm(cfg: ArchConfig) -> bool:
    return cfg.layer_kinds()[0] == MAMBA


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
        if is_ssm(cfg):
            self.mamba = Mamba(L, d, cfg)
        elif cfg.mla is not None:
            self.attn = MLA(L, d, cfg.num_heads, hd, cfg.mla.kv_lora_rank,
                            cfg.mla.rope_head_dim)
        else:
            self.attn = Attention(L, d, cfg.num_heads, cfg.num_kv_heads, hd)
        if _has_mlp(cfg, j):
            self.mlp = (MoE(L, d, cfg) if _has_moe(cfg, j)
                        else MLP(L, d, cfg.d_ff))
            self.norm2 = _meta(L, d)
        self.norm1 = _meta(L, d)


def block_leaves(cfg: ArchConfig, j: int) -> List[str]:
    """The leaf paths of position ``j``'s block, relative to it."""
    names = ["norm1"]
    if is_ssm(cfg):
        names += [f"mamba.{n}" for n in ssm.LEAVES]
    else:
        leaves = MLA_LEAVES if cfg.mla is not None else ATTN_LEAVES
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


def _layers(get, cfg: ArchConfig):
    """The per-layer parameter trees (the JAX per-layer layout) in layer
    order, from the stacked leaves; ``get(path)`` returns the leaf
    ``blocks.<path>`` (``path`` starts with the position in the period).
    Each stacked leaf is unbound once, so its gradient is one stack of
    the layers' gradients."""
    P = period_of(cfg)
    per_layer = [dict() for _ in range(cfg.num_layers)]
    for j in range(P):
        for path in block_leaves(cfg, j):
            *parents, last = path.split(".")
            for n, t in enumerate(get(f"{j}.{path}").unbind(0)):
                node = per_layer[n * P + j]
                for part in parents:
                    node = node.setdefault(part, {})
                node[last] = t
    return per_layer


def _ffn(h: torch.Tensor, lp, cfg: ArchConfig, j: int):
    """The layer's MLP or MoE on the residual stream; returns (h, aux)."""
    if "mlp" not in lp:
        return h, None
    x2 = rmsnorm(h, lp["norm2"], cfg.norm_eps)
    if _has_moe(cfg, j):
        y2, aux = moe_lib.moe_ffn(x2, lp["mlp"], cfg.moe)
        return h + y2, aux
    m = lp["mlp"]
    return h + swiglu(x2, m["w_gate"], m["w_up"], m["w_down"]), None


def _apply_layer(h: torch.Tensor, lp, cfg: ArchConfig, j: int,
                 positions: torch.Tensor, collect_cache: bool):
    """One layer over the full sequence.  Returns (h, aux, cache_entry)."""
    B, S, _ = h.shape
    x = rmsnorm(h, lp["norm1"], cfg.norm_eps)
    ce = None
    hd = cfg.resolved_head_dim
    attn_fn = ((lambda q, k, v: flash_attention(q, k, v, causal=True))
               if collect_cache else
               (lambda q, k, v: attend(q, k, v, causal=True)))
    if is_ssm(cfg):
        y = ssm.mamba_block(x, lp["mamba"], cfg.ssm,
                            collect_cache=collect_cache)
        if collect_cache:
            y, ce = y
    elif cfg.mla is not None:
        y, ckv, krope = mla_attention(
            x, lp["attn"], positions, num_heads=cfg.num_heads, head_dim=hd,
            rope_head_dim=cfg.mla.rope_head_dim, rope_theta=cfg.rope_theta,
            attn_fn=attn_fn)
        if collect_cache:
            ce = {"ckv": ckv, "krope": krope}
    else:
        a_p = lp["attn"]
        q, k, v = gqa_project_qkv(x, a_p["wq"], a_p["wk"], a_p["wv"],
                                  cfg.num_heads, cfg.num_kv_heads, hd)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        y = attn_fn(q, k, v).reshape(B, S, -1) @ a_p["wo"]
        if collect_cache:
            ce = {"k": k, "v": v}
    h, aux = _ffn(h + y, lp, cfg, j)
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

    def forward(self, tokens: torch.Tensor, collect_cache: bool = False):
        """tokens: (B, S) int -> (pre-head hidden state (B, S, d), the MoE
        aux loss summed over layers (0 without MoE)), and with
        ``collect_cache`` (the prefill) also the decode cache."""
        cfg = self.cfg
        B, S = tokens.shape
        P = period_of(cfg)
        h = self.embed[tokens]
        positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
        aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
        entries = [[] for _ in range(P)]
        for i, lp in enumerate(_layers(
                lambda path: attrgetter(path)(self.blocks), cfg)):
            h, a, ce = _apply_layer(h, lp, cfg, i % P, positions,
                                    collect_cache)
            if a is not None:
                aux = aux + a
            entries[i % P].append(ce)
        h = rmsnorm(h, self.final_norm, cfg.norm_eps)
        if not collect_cache:
            return h, aux
        layers = tuple({k: torch.stack([e[k] for e in es]) for k in es[0]}
                       for es in entries)
        index = torch.tensor(S, dtype=torch.int32, device=tokens.device)
        return h, aux, {"layers": layers, "index": index}


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
    p: Params = {}
    # the draw order (mixers, embed, MLPs, head) fixes what a seed gives
    for j in range(P):
        if is_ssm(cfg):
            mixer = {"mamba": ssm.mamba_init(gen, d, cfg.ssm, lead=(n,),
                                             dtype=dtype)}
        elif cfg.mla is not None:
            mixer = {"attn": mla_init(gen, d, cfg.num_heads, hd,
                                      cfg.mla.kv_lora_rank,
                                      cfg.mla.rope_head_dim, lead=(n,),
                                      dtype=dtype)}
        else:
            mixer = {"attn": gqa_init(gen, d, cfg.num_heads,
                                      cfg.num_kv_heads, hd, lead=(n,),
                                      dtype=dtype)}
        _flatten(f"blocks.{j}.", mixer, p)
        p[f"blocks.{j}.norm1"] = torch.ones((n, d), dtype=torch.float32,
                                            device=dev)
    p["embed"] = embed_init(gen, cfg.vocab_size, d, dtype)
    p["final_norm"] = torch.ones((d,), dtype=torch.float32, device=dev)
    for j in range(P):
        if not _has_mlp(cfg, j):
            continue
        p[f"blocks.{j}.norm2"] = torch.ones((n, d), dtype=torch.float32,
                                            device=dev)
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
    return {k: p[k] for k in leaf_order(p)}


def head_of(cfg: ArchConfig, params: Params) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["head"]


def lm_loss_chunked(module: Transformer, params: Params, tokens: torch.Tensor,
                    *, chunk: int = 2048
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token loss with the vocab projection and cross-entropy taken
    over sequence chunks (the last one ragged), so the (B, S, V) logits
    never exist at once; plus the MoE aux loss.  Returns (xent + aux,
    {"xent", "aux", "acc"})."""
    cfg = module.cfg
    inputs, labels = tokens[:, :-1], tokens[:, 1:]
    h, aux = functional_call(module, params, (inputs,))
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
    return xent + aux, {"xent": xent, "aux": aux, "acc": hit / cnt}


# ---------------------------------------------------------------------------
# Decode (one token against the stacked cache)
# ---------------------------------------------------------------------------
def pad_cache(cache, cfg: ArchConfig, cache_len: int):
    """Grow a prefill cache's attention sequence axis (k / v, or MLA's ckv
    / krope) to ``cache_len`` (zero slots) so decode steps can write into
    it; mamba entries carry constant state and pass through."""
    if is_ssm(cfg):
        return cache
    layers = []
    for ce in cache["layers"]:
        S = next(iter(ce.values())).shape[2]
        pad = cache_len - S
        layers.append(ce if pad <= 0 else {
            k: F.pad(t, [0, 0] * (t.dim() - 3) + [0, pad])   # axis 2
            for k, t in ce.items()})
    return {"layers": tuple(layers), "index": cache["index"]}


def make_cache(cfg: ArchConfig, batch: int, cache_len: int,
               dtype=torch.float32, *, window: int = 0, device=None):
    """Zero-initialized decode cache.  ``cache_len`` is the attention cache
    length (the window instead when a sliding-window decode is used);
    mamba layers carry constant-size state."""
    P = period_of(cfg)
    n = cfg.num_layers // P
    S = window if window > 0 else cache_len
    if cfg.mla is not None:
        shapes = {"ckv": (n, batch, S, cfg.mla.kv_lora_rank),
                  "krope": (n, batch, S, cfg.mla.rope_head_dim)}
    else:
        kv = (n, batch, S, cfg.num_kv_heads, cfg.resolved_head_dim)
        shapes = {"k": kv, "v": kv}
    layers = []
    for _ in range(P):
        layers.append(
            ssm.mamba_make_cache(batch, cfg.d_model, cfg.ssm, dtype,
                                 lead=(n,), device=device) if is_ssm(cfg)
            else {k: torch.zeros(s, dtype=dtype, device=device)
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
    index = cache["index"]
    layers = _layers(lambda path: params[f"blocks.{path}"], cfg)
    hd = cfg.resolved_head_dim
    h = params["embed"][tokens]
    for i, lp in enumerate(layers):
        j, n = i % P, i // P
        ce = cache["layers"][j]
        x = rmsnorm(h, lp["norm1"], cfg.norm_eps)
        if is_ssm(cfg):
            y, new = ssm.mamba_block_decode(
                x, lp["mamba"], cfg.ssm,
                {"ssm": ce["ssm"][n], "conv": ce["conv"][n]})
            ce["ssm"][n].copy_(new["ssm"])
            ce["conv"][n].copy_(new["conv"])
        elif cfg.mla is not None:
            y = mla_decode_absorbed(
                x, lp["attn"], ce["ckv"][n], ce["krope"][n], index,
                num_heads=cfg.num_heads, head_dim=hd,
                rope_head_dim=cfg.mla.rope_head_dim,
                rope_theta=cfg.rope_theta)
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
    return logits, {"layers": cache["layers"], "index": index + 1}
