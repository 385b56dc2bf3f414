"""Sequence-parallel flash decode (PyTorch port of
``repro/sharding/longctx.py``): every process computes the online-softmax
partials (m, l, o) over its shard of the KV cache and the partials are
combined with ``all_reduce`` MAX / SUM — one small collective per layer.
Plain PyTorch, as in the JAX package; exact against
``models/attention.py::decode_attention`` up to the sum's order.

Torch has no ``shard_map``: the caller holds, and passes, this process's
cache shard and its :class:`repro_torch.sharding.tensor_parallel.SeqSplit`
(``Serving.seq_split`` of the cache's placement), whose group is the one
the sequence is split over: ``model``, or ``data`` at B = 1 (JAX's
``cache_shardings``), served by this one path.  A shard whose positions
all lie past the token (m at the mask value) weighs exactly 0 in the
merge."""
from __future__ import annotations

import torch

from repro_torch.models.attention import (combine_partials,
                                          decode_attention,
                                          flash_decode_partial)


def sharded_flash_decode(q: torch.Tensor, k_shard: torch.Tensor,
                         v_shard: torch.Tensor, index, seq) -> torch.Tensor:
    """q: (B, H, Dk), the same on every process of ``seq.group``;
    k/v_shard: (B, S / n, Hkv, D*), this process's contiguous part of the
    cache sequence (part i holds positions [i * S / n, (i + 1) * S / n));
    index: the last valid position (the new token's).  Returns (B, H, Dv)
    on every process: :func:`decode_attention` where the sequence is whole
    here (``seq.size`` 1), else the partials merged over ``seq.group``."""
    if seq.size == 1:
        return decode_attention(q, k_shard, v_shard, index)
    m, l, o = flash_decode_partial(q, k_shard, v_shard, index, seq.offset)
    return combine_partials(m, l, o, seq.group).to(v_shard.dtype)
