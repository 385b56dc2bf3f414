"""CUDA pack/unpack kernels of the gradient-compression uplink
(:mod:`repro_torch.comm`): int8 quantize / dequantize-FMA and 1-bit sign
pack / unpack-FMA over the flat ``(rows, 128)`` dtype-group buffers of
:mod:`repro_torch.core.flat`, each with its plain PyTorch version
(``ref.py``); the counterpart of ``repro/kernels/comm``."""
from repro_torch.kernels.comm.ops import (dequant_i8_fma, quantize_i8,
                                          sign_pack, sign_unpack_fma)

__all__ = ["quantize_i8", "dequant_i8_fma", "sign_pack", "sign_unpack_fma"]
