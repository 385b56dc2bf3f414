"""Attention of the LM stack (PyTorch port of the GQA and MLA parts of
``repro/models/attention.py``).

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
    PyTorch as in JAX (ring-buffer validity under a decode window);
    ``flash_decode_partial`` and ``combine_partials`` are its form over a
    cache sharded along the sequence across processes
    (``sharding/longctx.py``).

MLA (DeepSeek-V2's multi-head latent attention): ``mla_attention`` expands
the latent kv and attends with Dk = head_dim + rope_head_dim (192 at
deepseek-v2-lite) and Dv = head_dim (128), through the flash kernel in the
prefill and ``attend`` in training; ``mla_decode_absorbed`` attends in the
latent space against the ``(ckv, krope)`` cache, which it updates in
place.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.layers import (apply_rope, column_products,
                                       dense_init, row_parallel)

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
                    num_kv_heads: int, head_dim: int, tp=None):
    """q, k, v of shapes (B, S, heads, head_dim), whole heads.  With
    ``tp`` (a :class:`repro_torch.sharding.tensor_parallel.ModelAxis`)
    each of ``wq``/``wk``/``wv`` is this process's column part or whole:
    the split ones' products are gathered to whole heads in one
    all-gather (a column split can cut through a head, and rope and
    softmax need whole heads), the whole ones computed whole; attention
    then runs replicated on every process of the axis."""
    B, S, _ = x.shape
    heads = (num_heads, num_kv_heads, num_kv_heads)
    outs = column_products(x, (wq, wk, wv), [h * head_dim for h in heads],
                           tp)
    return tuple(o.reshape(B, S, h, head_dim) for o, h in zip(outs, heads))


def heads_split(tp, w_cols: int, num_heads: int, head_dim: int) -> bool:
    """Whether a projection of ``num_heads`` heads, ``w_cols`` of whose
    columns this process holds, gives it whole heads of its own: the
    axis splits the columns and divides the heads."""
    return (tp is not None and num_heads % tp.size == 0
            and tp.is_split(w_cols, num_heads * head_dim))


def gqa_attention(x: torch.Tensor, p, *, num_heads: int, num_kv_heads: int,
                  head_dim: int, causal: bool, attn_fn=None, positions=None,
                  rope_theta: float = 0.0, kv_x=None, tp=None):
    """GQA attention of x (B, S, d) over itself, or over ``kv_x`` (B, L,
    d) (a cross layer's encoder output), RoPE on q and k at
    ``positions`` where given.  Returns (y (B, S, d), k, v).

    Over the model axis ``tp``: where it divides the query and KV heads
    (``heads_split``), each process projects, attends and multiplies
    ``wo``'s rows for its own heads, x (and ``kv_x``) entering through
    ``tp.copy`` and the partial outputs summed over the axis (k and v
    are then its heads only); else q/k/v are gathered to whole heads
    (:func:`gqa_project_qkv`), attention runs whole on every process,
    and ``wo`` goes through ``row_parallel``."""
    B, S, _ = x.shape
    attn_fn = attn_fn or attend
    L = (x if kv_x is None else kv_x).shape[1]
    if (heads_split(tp, p["wq"].shape[-1], num_heads, head_dim)
            and heads_split(tp, p["wk"].shape[-1], num_kv_heads, head_dim)):
        xs = tp.copy(x)
        ss = xs if kv_x is None else tp.copy(kv_x)
        q = (xs @ p["wq"]).reshape(B, S, -1, head_dim)
        k = (ss @ p["wk"]).reshape(B, L, -1, head_dim)
        v = (ss @ p["wv"]).reshape(B, L, -1, head_dim)
        out_proj = lambda a: tp.reduce(a @ p["wo"])
    else:
        if kv_x is None:
            q, k, v = gqa_project_qkv(x, p["wq"], p["wk"], p["wv"],
                                      num_heads, num_kv_heads, head_dim, tp)
        else:
            (q,) = column_products(x, (p["wq"],), (num_heads * head_dim,),
                                   tp)
            k, v = column_products(kv_x, (p["wk"], p["wv"]),
                                   (num_kv_heads * head_dim,) * 2, tp)
            q = q.reshape(B, S, num_heads, head_dim)
            k, v = (t.reshape(B, L, num_kv_heads, head_dim) for t in (k, v))
        out_proj = lambda a: row_parallel(a, p["wo"], tp)
    if positions is not None:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    y = out_proj(attn_fn(q, k, v, causal=causal).reshape(B, S, -1))
    return y, k, v


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool = True) -> torch.Tensor:
    """q: (B, Sq, H, Dk); k: (B, Skv, Hkv, Dk); v: (B, Skv, Hkv, Dv) with H
    = G * Hkv.  Returns (B, Sq, H, Dv); query head h reads kv head h // G."""
    B, Sq, H, D = q.shape
    Skv, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    G = H // Hkv
    qg = q.reshape(B, Sq, Hkv, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k) / math.sqrt(D)
    if causal:
        mask = torch.ones((Sq, Skv), dtype=torch.bool,
                          device=q.device).tril()
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s.to(torch.float32), dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype), v)
    return out.reshape(B, Sq, H, Dv)


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


def flash_decode_partial(q: torch.Tensor, k_shard: torch.Tensor,
                         v_shard: torch.Tensor, index, shard_offset):
    """Online-softmax partials of one shard of a sequence-sharded decode
    cache.  q: (B, H, Dk); k/v_shard: (B, S_loc, Hkv, D*); shard_offset:
    the absolute position of the shard's first cache slot.  Returns (m,
    l, o): (B, H), (B, H), (B, H, Dv) fp32 — combine them with
    :func:`combine_partials`."""
    B, S_loc, Hkv, Dk = k_shard.shape
    H = q.shape[1]
    qg = q.reshape(B, Hkv, H // Hkv, Dk)
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k_shard).to(
        torch.float32) / math.sqrt(Dk)
    pos = shard_offset + torch.arange(S_loc, device=q.device)
    s = torch.where((pos <= index)[None, None, None, :], s, NEG_INF)
    m = torch.amax(s, dim=-1)                                  # (B,Hkv,G)
    p = torch.exp(s - m[..., None])
    l = torch.sum(p, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", p.to(v_shard.dtype), v_shard)
    Dv = v_shard.shape[-1]
    return (m.reshape(B, H), l.reshape(B, H),
            o.reshape(B, H, Dv).to(torch.float32))


def combine_partials(m: torch.Tensor, l: torch.Tensor, o: torch.Tensor,
                     group=None) -> torch.Tensor:
    """Combine :func:`flash_decode_partial`'s partials over the processes
    of ``group`` (``torch.distributed``; JAX's ``pmax`` / ``psum`` over
    the sequence-sharding axis become ``all_reduce`` MAX / SUM)."""
    import torch.distributed as dist
    m_g = m.clone()
    dist.all_reduce(m_g, op=dist.ReduceOp.MAX, group=group)
    corr = torch.exp(m - m_g)
    l_g = l * corr
    o_g = o * corr[..., None]
    dist.all_reduce(l_g, op=dist.ReduceOp.SUM, group=group)
    dist.all_reduce(o_g, op=dist.ReduceOp.SUM, group=group)
    return o_g / torch.clamp(l_g, min=1e-30)[..., None]


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention)
# ---------------------------------------------------------------------------
MLA_LEAVES = ("w_dkv", "w_kr", "w_uk", "w_uv", "wq", "wo")


def mla_init(gen: torch.Generator, d_model: int, num_heads: int,
             head_dim: int, kv_lora_rank: int, rope_head_dim: int, *,
             lead=(), dtype=torch.float32) -> dict:
    lead = tuple(lead)

    def up():                                   # (r, H, hd), N(0, 1/r)
        w = torch.randn(lead + (kv_lora_rank, num_heads, head_dim),
                        generator=gen, device=gen.device)
        return w.mul_(1.0 / math.sqrt(kv_lora_rank)).to(dtype)

    p = {"w_dkv": dense_init(gen, d_model, kv_lora_rank, lead=lead,
                             dtype=dtype),
         "w_kr": dense_init(gen, d_model, rope_head_dim, lead=lead,
                            dtype=dtype)}
    p["w_uk"] = up()
    p["w_uv"] = up()
    p["wq"] = dense_init(gen, d_model, num_heads * (head_dim + rope_head_dim),
                         lead=lead, dtype=dtype)
    p["wo"] = dense_init(gen, num_heads * head_dim, d_model, lead=lead,
                         dtype=dtype,
                         scale=1.0 / math.sqrt(num_heads * head_dim))
    return p


def mla_attention(x: torch.Tensor, p, positions: torch.Tensor, *,
                  num_heads: int, head_dim: int, rope_head_dim: int,
                  rope_theta: float, attn_fn=None, tp=None):
    """Training / prefill MLA: expand the latent kv and attend with Dk =
    head_dim + rope_head_dim, Dv = head_dim.  The query RoPE applies to
    the last ``rope_head_dim`` columns only; the key RoPE slice is one
    head, broadcast to all.  ``attn_fn(q, k, v)`` is the causal attention
    (``attend`` by default; the prefill passes the flash kernel's op).
    Returns (out (B, S, d_model), and the decode cache's latent ``ckv``
    (B, S, r) and roped ``krope`` (B, S, rd)).

    Over the model axis ``tp``: where it splits ``w_uk``/``w_uv``'s heads
    (then ``wq``'s columns and ``wo``'s rows split at whole heads too),
    each process attends with its own heads: the latent ``ckv`` and the
    rope key, column-split products of a dim the heads share, are
    gathered whole and enter the heads through ``tp.copy``, and the
    partial outputs are summed over the axis.  Else every product is
    gathered whole, attention runs whole, ``wo`` through
    ``row_parallel``."""
    B, S, _ = x.shape
    H, hd, rd = num_heads, head_dim, rope_head_dim
    r = p["w_uk"].shape[-3]
    heads = tp is not None and tp.is_split(p["w_uk"].shape[-2], H)
    if heads:
        xs = tp.copy(x)
        ckv, kr = (tp.copy(t) for t in column_products(
            x, (p["w_dkv"], p["w_kr"]), (r, rd), tp, xs=xs))
        q = xs @ p["wq"]
    else:
        q, ckv, kr = column_products(
            x, (p["wq"], p["w_dkv"], p["w_kr"]), (H * (hd + rd), r, rd), tp)
    h_loc = p["w_uk"].shape[-2]
    # one key head, shared by all (JAX's apply_rope_1h)
    krope = apply_rope(kr, positions, rope_theta)
    k_nope = torch.einsum("bsr,rhd->bshd", ckv, p["w_uk"])
    v = torch.einsum("bsr,rhd->bshd", ckv, p["w_uv"])
    q = q.reshape(B, S, h_loc, hd + rd)
    q_rope = apply_rope(q[..., hd:], positions, rope_theta)
    q = torch.cat([q[..., :hd], q_rope], dim=-1)
    k = torch.cat([k_nope, krope[:, :, None, :].expand(
        B, S, h_loc, rd)], dim=-1)
    out = (attn_fn or attend)(q, k, v).reshape(B, S, h_loc * hd)
    y = tp.reduce(out @ p["wo"]) if heads else row_parallel(out, p["wo"], tp)
    return y, ckv, krope


def mla_decode_absorbed(x: torch.Tensor, p, ckv_cache: torch.Tensor,
                        krope_cache: torch.Tensor, index: torch.Tensor, *,
                        num_heads: int, head_dim: int, rope_head_dim: int,
                        rope_theta: float) -> torch.Tensor:
    """Absorbed-matmul MLA decode: scores and values in the compressed
    latent space against the cache of (ckv, krope) alone.

    x: (B, d_model), the current token; caches (B, S, r) / (B, S, rd),
    written in place at ``index`` (clamped to the last slot, as JAX's
    ``dynamic_update_slice`` clamps it); index: 0-d int tensor, the
    token's position.  Returns (B, d_model)."""
    B = x.shape[0]
    S = ckv_cache.shape[1]
    pos = index.reshape(1, 1).expand(B, 1)
    ckv_new = x @ p["w_dkv"]                                   # (B, r)
    krope_new = apply_rope((x @ p["w_kr"])[:, None, :], pos, rope_theta)
    slot = torch.clamp(index, max=S - 1).reshape(1).long()
    ckv_cache.index_copy_(1, slot, ckv_new[:, None].to(ckv_cache.dtype))
    krope_cache.index_copy_(1, slot, krope_new.to(krope_cache.dtype))
    q = (x @ p["wq"]).reshape(B, num_heads, head_dim + rope_head_dim)
    q_nope = q[..., :head_dim]
    q_rope = apply_rope(q[:, None, :, head_dim:], pos, rope_theta)[:, 0]
    q_lat = torch.einsum("bhd,rhd->bhr", q_nope, p["w_uk"])   # absorb W_uk
    s = (torch.einsum("bhr,bsr->bhs", q_lat, ckv_cache).to(torch.float32)
         + torch.einsum("bhd,bsd->bhs", q_rope, krope_cache).to(
             torch.float32))
    s = s / math.sqrt(head_dim + rope_head_dim)
    valid = torch.arange(S, device=x.device) <= index
    s = torch.where(valid[None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o_lat = torch.einsum("bhs,bsr->bhr", w.to(ckv_cache.dtype), ckv_cache)
    o = torch.einsum("bhr,rhd->bhd", o_lat, p["w_uv"])         # (B, H, hd)
    return o.reshape(B, num_heads * head_dim) @ p["wo"]
