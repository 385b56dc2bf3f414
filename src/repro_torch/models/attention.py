"""Grouped-query attention of the dense LM (PyTorch port of the GQA parts
of ``repro/models/attention.py``).

``attend`` is plain matmul -> softmax -> matmul: the fused backends of
``scaled_dot_product_attention`` have no forward-mode derivative, and the
UGA client update takes Hessian-vector products as jvp-of-grad.  The JAX
package computes attention outside any Pallas kernel too (its flash
attention kernel is reached by no model path); a hand-written Hopper
kernel for it is ROADMAP Queue 1 item 6.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.layers import dense_init

NEG_INF = -1e30


def gqa_init(gen: torch.Generator, d_model: int, num_heads: int,
             num_kv_heads: int, head_dim: int, *, lead=(),
             dtype=torch.float32) -> dict:
    return {
        "wq": dense_init(gen, d_model, num_heads * head_dim, lead=lead,
                         dtype=dtype),
        "wk": dense_init(gen, d_model, num_kv_heads * head_dim, lead=lead,
                         dtype=dtype),
        "wv": dense_init(gen, d_model, num_kv_heads * head_dim, lead=lead,
                         dtype=dtype),
        "wo": dense_init(gen, num_heads * head_dim, d_model, lead=lead,
                         dtype=dtype,
                         scale=1.0 / math.sqrt(num_heads * head_dim)),
    }


def gqa_project_qkv(x: torch.Tensor, wq, wk, wv, num_heads: int,
                    num_kv_heads: int, head_dim: int):
    B, S, _ = x.shape
    q = (x @ wq).reshape(B, S, num_heads, head_dim)
    k = (x @ wk).reshape(B, S, num_kv_heads, head_dim)
    v = (x @ wv).reshape(B, S, num_kv_heads, head_dim)
    return q, k, v


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool = True) -> torch.Tensor:
    """q: (B, Sq, H, D); k, v: (B, Skv, Hkv, D) with H = G * Hkv.
    Returns (B, Sq, H, D); query head h reads kv head h // G."""
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, Sq, Hkv, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k) / math.sqrt(D)
    if causal:
        mask = torch.ones((Sq, Skv), dtype=torch.bool,
                          device=q.device).tril()
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s.to(torch.float32), dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype), v)
    return out.reshape(B, Sq, H, D)
