"""Public entry point of the flash-attention kernel (PyTorch port of
``repro/kernels/flash_attention/ops.py``).

Takes the model's ``(B, S, H, D)`` layout and hands the kernel its
``(B, H, S, D)`` transposes as views: no copy in, and the kernel writes
the output in the model's ``(B, S, H, D)`` order, so the caller's
``reshape(B, S, H * D)`` is a view too.  Key/value head ``h // G`` serves
query head ``h`` (GQA without repeating k and v).  Unlike the JAX wrapper
it needs no padding: the kernel masks the ragged tail of any Sq and Skv,
so the function is the one JAX's ``attend`` computes at every length
(through ``chunked_attention`` where the length is not a multiple of its
block), non-causal queries against an encoder's keys included (Sq !=
Skv; the JAX wrapper refuses a non-causal call whose keys it would
zero-pad, since padded keys would take softmax weight).  The call dispatches on the tensors' device through the kernel
wrapper: the plain version for CPU tensors, the CUDA kernel for CUDA
tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel as K


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, Sq, H, Dk); k: (B, Skv, Hkv, Dk); v: (B, Skv, Hkv, Dv) with H
    a multiple of Hkv.  Returns (B, Sq, H, Dv), contiguous."""
    o = K.flash_attention_fwd(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal,
                              window=window)
    return o.transpose(1, 2)
