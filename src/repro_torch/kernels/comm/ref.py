"""Plain PyTorch versions of the communication-compression kernels.

The same functions as the CUDA kernels in ``csrc/comm.cu`` and as the JAX
package's ``repro/kernels/comm/ref.py``, over the flat ``(rows, 128)``
fp32 layout of :mod:`repro_torch.core.flat`:

  quantize_i8      q = clip(round(g * inv_scale), -127, 127) as int8, and
                   optionally the residual g - q * scale
  dequant_i8_fma   acc + scale_w * q
  sign_pack        8 rows of sign bits -> one uint8 row, and optionally
                   the residual g - mu * sign (pad masked)
  sign_unpack_fma  acc + mu_w * sign (pad masked)

Conventions, as in the JAX package: ``round`` is round half to even
(``torch.round``); row r of g lands in bit ``r % 8`` of packed row
``r // 8``; ``sign(0) := +1``, computed as ``g >= 0`` (so ``-0.0`` packs as
+1); elements whose flat index ``row * 128 + lane`` is ``>= n_valid`` (the
layout's zero pad) decode to exact zero.  Every product and sum is rounded
on its own, fp32 throughout; the kernels round the same way, so on the
card each equals its plain version bitwise.  The CPU path of each kernel
wrapper runs these, and the card's tests hold each kernel against them.
"""
from __future__ import annotations

from typing import Tuple

import torch

SIGN_PACK = 8         # rows of sign bits per packed uint8 row


def _shifts(device) -> torch.Tensor:
    return torch.arange(SIGN_PACK, dtype=torch.int32,
                        device=device).reshape(1, SIGN_PACK, 1)


def valid_mask(shape: Tuple[int, int], n_valid: int,
               device=None) -> torch.Tensor:
    """True where the flat index ``row * lanes + lane`` is < n_valid."""
    rows, lanes = shape
    row = torch.arange(rows, dtype=torch.int64, device=device)[:, None]
    lane = torch.arange(lanes, dtype=torch.int64, device=device)[None, :]
    return row * lanes + lane < n_valid


def quantize_i8_ref(g: torch.Tensor, scalars: torch.Tensor, *,
                    with_error: bool = False):
    """``scalars``: (2,) fp32 ``[inv_scale, scale]``, the wrapper's
    form."""
    inv_scale, scale = scalars[0], scalars[1]
    q = torch.clamp(torch.round(g * inv_scale), -127.0, 127.0)
    q8 = q.to(torch.int8)
    if not with_error:
        return q8
    return q8, g - q * scale


def dequant_i8_fma_ref(acc: torch.Tensor, q: torch.Tensor,
                       scale_w: torch.Tensor) -> torch.Tensor:
    return acc + scale_w * q.to(torch.float32)


def sign_pack_ref(g: torch.Tensor, mu: torch.Tensor, n_valid: int, *,
                  with_error: bool = False):
    rows, lanes = g.shape
    bits = (g >= 0).to(torch.int32)
    packed = torch.sum(bits.reshape(rows // SIGN_PACK, SIGN_PACK, lanes)
                       << _shifts(g.device), dim=1).to(torch.uint8)
    if not with_error:
        return packed
    s = (2 * bits - 1).to(torch.float32)
    dec = mu * torch.where(valid_mask(g.shape, n_valid, g.device), s, 0.0)
    return packed, g - dec


def sign_unpack_fma_ref(acc: torch.Tensor, packed: torch.Tensor,
                        mu_w: torch.Tensor, n_valid: int) -> torch.Tensor:
    rows, lanes = acc.shape
    bits = (packed.to(torch.int32)[:, None, :] >> _shifts(acc.device)) & 1
    s = (2 * bits - 1).to(torch.float32).reshape(rows, lanes)
    dec = torch.where(valid_mask(acc.shape, n_valid, acc.device), s, 0.0)
    return acc + mu_w * dec
