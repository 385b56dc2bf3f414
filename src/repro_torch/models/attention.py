"""Grouped-query attention of the dense LM (PyTorch port of the GQA parts
of ``repro/models/attention.py``).

Three forms of one function:

  * ``attend`` — training.  Plain matmul -> softmax -> matmul: the UGA
    client update takes Hessian-vector products as jvp-of-grad, and
    neither the port's flash kernel nor the fused backends of
    ``scaled_dot_product_attention`` have a forward-mode derivative.
  * ``kernels.flash_attention.flash_attention`` — serving prefill, and
    only it (``transformer._apply_layer`` calls it directly): the CUDA
    kernel on the card, its plain version on the CPU, where the JAX
    prefill reaches ``flash_attention`` / ``chunked_attention``, the same
    online-softmax function.
  * ``decode_attention`` — one new token against the cache, plain
    PyTorch as in JAX (ring-buffer validity under a decode window).
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


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, index: torch.Tensor, *,
                     window: int = 0) -> torch.Tensor:
    """q: (B, H, Dk); caches: (B, S, Hkv, Dk/Dv); index: 0-d int tensor,
    the number of tokens already in the cache (the new token's position).

    With window > 0 the cache is a ring buffer of size S and every slot
    written so far is valid: slot < min(index + 1, S), after the caller
    wrote the current token at index % S."""
    B, S, Hkv, Dk = k_cache.shape
    Dv = v_cache.shape[-1]
    H = q.shape[1]
    qg = q.reshape(B, Hkv, H // Hkv, Dk)
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache).to(
        torch.float32) / math.sqrt(Dk)
    k_pos = torch.arange(S, device=q.device)
    if window > 0:
        valid = k_pos < torch.clamp(index + 1, max=S)          # ring buffer
    else:
        valid = k_pos <= index
    s = torch.where(valid[None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p.to(v_cache.dtype), v_cache)
    return out.reshape(B, H, Dv)
