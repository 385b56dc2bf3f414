"""Public entry points of the comm kernels (PyTorch port of
``repro/kernels/comm/ops.py``).

The JAX package picks its plain version with ``use_ref=True``; here each
call dispatches on its tensors' device through the kernel wrapper: the
plain version (``ref.py``) for CPU tensors, the CUDA kernel for CUDA
tensors.  These are the primitives the codecs of
:mod:`repro_torch.comm.codecs` compose: the codec computes the scale or
magnitude (one PyTorch reduction) and passes it here as a device scalar
or a number; the kernels do the sweeps.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.comm import kernel as K


def _scalar(x, device) -> torch.Tensor:
    """A one-element fp32 tensor on ``device`` (a 0-d tensor is reshaped,
    a host number becomes a fill, not a host-to-device copy)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32).reshape(1)
    return torch.full((1,), x, dtype=torch.float32, device=device)


def quantize_i8(g: torch.Tensor, inv_scale, scale, *,
                with_error: bool = False):
    scalars = torch.cat([_scalar(inv_scale, g.device),
                         _scalar(scale, g.device)])
    return K.quantize_i8_pass(g, scalars, with_error=with_error)


def dequant_i8_fma(acc: torch.Tensor, q: torch.Tensor, scale_w, *,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    return K.dequant_i8_fma_pass(acc, q, _scalar(scale_w, acc.device),
                                 out=out)


def sign_pack(g: torch.Tensor, mu, n_valid: int, *,
              with_error: bool = False):
    return K.sign_pack_pass(g, _scalar(mu, g.device), n_valid,
                            with_error=with_error)


def sign_unpack_fma(acc: torch.Tensor, packed: torch.Tensor, mu_w,
                    n_valid: int, *,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    return K.sign_unpack_fma_pass(acc, packed, _scalar(mu_w, acc.device),
                                  n_valid, out=out)
