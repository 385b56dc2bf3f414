"""Sequence-parallel flash decode (PyTorch port of
``repro/sharding/longctx.py``): every process computes the online-softmax
partials (m, l, o) over its shard of the KV cache and the partials are
combined with ``all_reduce`` MAX / SUM — one small collective per layer.
Plain PyTorch, as in the JAX package; exact against
``models/attention.py::decode_attention`` up to the sum's order.

Torch has no ``shard_map``: the caller holds, and passes, this process's
cache shard."""
from __future__ import annotations

import torch

from repro_torch.models.attention import (combine_partials,
                                          flash_decode_partial)
from repro_torch.sharding.specs import Mesh


def sharded_flash_decode(q: torch.Tensor, k_shard: torch.Tensor,
                         v_shard: torch.Tensor, index, *, mesh: Mesh,
                         axis: str = "data") -> torch.Tensor:
    """q: (B, H, Dk), the same on every process of ``axis``; k/v_shard:
    (B, S / n, Hkv, D*), this process's contiguous slice of the cache
    sequence (shard i holds positions [i * S / n, (i + 1) * S / n));
    index: the global position of the new token.  Returns (B, H, Dv) on
    every process."""
    loc = k_shard.shape[1]
    m, l, o = flash_decode_partial(q, k_shard, v_shard, index,
                                   mesh.coords[axis] * loc)
    return combine_partials(m, l, o, mesh.groups[axis]).to(v_shard.dtype)
