"""Dense decoder-only LM (PyTorch port of the dense subset of
``repro/models/transformer.py``): GQA attention with RoPE, SwiGLU MLP,
RMSNorm, tied or untied head.

Parameter layout is the JAX package's, so :mod:`repro_torch.bridge` is a
copy: every block leaf is stacked over layers, ``(num_layers, ...)``, and
dense weights are ``(in, out)``, used as ``x @ w``.  The module holds its
parameters on the ``meta`` device only; a forward always runs through
:func:`torch.func.functional_call` with a dict of real tensors
(``{"blocks.0.attn.wq": ..., "embed": ..., ...}``), which is what the
federated runtime differentiates with ``torch.func``.  No remat: activation
checkpointing does not compose with ``torch.func`` transforms.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn as nn
from torch.func import functional_call

from repro_torch.configs.base import ArchConfig
from repro_torch.core.flat import leaf_order
from repro_torch.models.attention import attend, gqa_init, gqa_project_qkv
from repro_torch.models.layers import (apply_rope, dense_init, embed_init,
                                       rmsnorm, swiglu)

Params = Dict[str, torch.Tensor]


def _meta(*shape) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device="meta"))


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


class Block(nn.Module):
    """All ``L`` layers of one position in the period, stacked."""

    def __init__(self, cfg: ArchConfig):
        super().__init__()
        L, d = cfg.num_layers, cfg.d_model
        self.attn = Attention(L, d, cfg.num_heads, cfg.num_kv_heads,
                              cfg.resolved_head_dim)
        self.mlp = MLP(L, d, cfg.d_ff)
        self.norm1, self.norm2 = _meta(L, d), _meta(L, d)


class Transformer(nn.Module):
    def __init__(self, cfg: ArchConfig):
        super().__init__()
        self.cfg = cfg
        self.embed = _meta(cfg.vocab_size, cfg.d_model)
        self.final_norm = _meta(cfg.d_model)
        if not cfg.tie_embeddings:
            self.head = _meta(cfg.d_model, cfg.vocab_size)
        self.blocks = nn.ModuleList([Block(cfg)])

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens: (B, S) int -> pre-head hidden state (B, S, d)."""
        cfg = self.cfg
        B, S = tokens.shape
        hd = cfg.resolved_head_dim
        blk = self.blocks[0]
        h = self.embed[tokens]
        positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
        layers = zip(blk.norm1.unbind(0), blk.attn.wq.unbind(0),
                     blk.attn.wk.unbind(0), blk.attn.wv.unbind(0),
                     blk.attn.wo.unbind(0), blk.norm2.unbind(0),
                     blk.mlp.w_gate.unbind(0), blk.mlp.w_up.unbind(0),
                     blk.mlp.w_down.unbind(0))
        for n1, wq, wk, wv, wo, n2, wg, wu, wd in layers:
            x = rmsnorm(h, n1, cfg.norm_eps)
            q, k, v = gqa_project_qkv(x, wq, wk, wv, cfg.num_heads,
                                      cfg.num_kv_heads, hd)
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
            a = attend(q, k, v, causal=True)
            h = h + a.reshape(B, S, -1) @ wo
            x2 = rmsnorm(h, n2, cfg.norm_eps)
            h = h + swiglu(x2, wg, wu, wd)
        return rmsnorm(h, self.final_norm, cfg.norm_eps)


def init_transformer(cfg: ArchConfig, gen: torch.Generator,
                     dtype=torch.float32) -> Params:
    """Random parameters from ``gen`` on ``gen.device``: the JAX
    initializers' distributions (not their numbers — the two frameworks'
    generators differ; tests pass JAX parameters through the bridge)."""
    L, d = cfg.num_layers, cfg.d_model
    dev = gen.device
    attn = gqa_init(gen, d, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim, lead=(L,), dtype=dtype)
    p: Params = {
        "embed": embed_init(gen, cfg.vocab_size, d, dtype),
        "final_norm": torch.ones((d,), dtype=torch.float32, device=dev),
        "blocks.0.norm1": torch.ones((L, d), dtype=torch.float32, device=dev),
        "blocks.0.norm2": torch.ones((L, d), dtype=torch.float32, device=dev),
        "blocks.0.mlp.w_gate": dense_init(gen, d, cfg.d_ff, lead=(L,),
                                          dtype=dtype),
        "blocks.0.mlp.w_up": dense_init(gen, d, cfg.d_ff, lead=(L,),
                                        dtype=dtype),
        "blocks.0.mlp.w_down": dense_init(gen, cfg.d_ff, d, lead=(L,),
                                          dtype=dtype),
    }
    p.update({f"blocks.0.attn.{k}": v for k, v in attn.items()})
    if not cfg.tie_embeddings:
        p["head"] = dense_init(gen, d, cfg.vocab_size, dtype=dtype)
    return {k: p[k] for k in leaf_order(p)}


def lm_loss_chunked(module: Transformer, params: Params, tokens: torch.Tensor,
                    *, chunk: int = 2048
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token loss with the vocab projection and cross-entropy taken
    over sequence chunks, so the (B, S, V) logits never exist at once.
    Returns (loss, {"xent", "aux", "acc"})."""
    cfg = module.cfg
    inputs, labels = tokens[:, :-1], tokens[:, 1:]
    h = functional_call(module, params, (inputs,))
    head = params["embed"].T if cfg.tie_embeddings else params["head"]
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
