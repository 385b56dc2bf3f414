"""Public entry point of the flash-attention kernel (PyTorch port of
``repro/kernels/flash_attention/ops.py``).

Takes the model's ``(B, S, H, D)`` layout and folds the heads into the
kernel's ``(B*H, S, D)``, heads ordered (b, h) so that key/value head
``bh // G`` serves query head ``bh`` (GQA without repeating k and v).
Unlike the JAX wrapper it needs no padding: the kernel masks the ragged
tail of any Sq and Skv, so the function is the one JAX's ``attend``
computes at every length (through ``chunked_attention`` where the length
is not a multiple of its block).  The call dispatches on the tensors'
device through the kernel wrapper: the plain version for CPU tensors, the
CUDA kernel for CUDA tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel as K


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, Sq, H, D); k, v: (B, Skv, Hkv, D) with H a multiple of Hkv.
    Returns (B, Sq, H, D)."""
    B, Sq, H, D = q.shape
    _, Skv, Hkv, _ = k.shape
    fold = lambda t, h, s: t.transpose(1, 2).contiguous().view(B * h, s, D)
    qf, kf, vf = fold(q, H, Sq), fold(k, Hkv, Skv), fold(v, Hkv, Skv)
    of = K.flash_attention_fwd(qf, kf, vf, causal=causal, window=window)
    return of.reshape(B, H, Sq, D).transpose(1, 2)
