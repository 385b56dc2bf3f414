"""CUDA kernels of the communication-compression uplink: build, binding and
wrappers.

The four kernels of ``repro/kernels/comm/kernel.py`` (Pallas, TPU) — int8
quantize and dequantize-FMA, 1-bit sign pack and unpack-FMA — are written
by hand for Hopper in ``csrc/comm.cu`` and built and loaded as the fused
update's are (:mod:`repro_torch.kernels._cuda`: ``nvcc`` for ``sm_90a`` at
first use, into ``build/`` beside this file, keyed by a hash of the source
and flags).

Each wrapper checks device, dtype, shape and contiguity, then:

  * for CPU tensors computes the plain PyTorch version (``ref.py``) — the
    CPU tests run that, and nothing else takes it;
  * for CUDA tensors launches the kernel on the current stream, raises on
    the error code the launch returns, and adds one to its ``launches``
    count.  There is no fallback: a CUDA tensor gets the kernel or an
    error.

The scalars (``[inv_scale, scale]``, ``scale * w``, ``mu``, ``mu * w``) are
one- or two-element fp32 tensors on the buffers' device, read by the
kernel from device memory.  ``out=acc`` updates an accumulator in place.

Bounds at the full width of smollm-360m (rows = 2,826,728; one fp32 buffer
is 1.447 GB, an int8 payload 0.362 GB, the sign bits 0.045 GB; H100 SXM,
3.35 TB/s), all four bound by bytes:

  * ``quantize_i8_pass``: reads 1.447 GB, writes 0.362 GB (+ 1.447 GB of
    residual with error feedback): 0.540 ms (0.972 ms);
  * ``dequant_i8_fma_pass``: reads 1.809 GB, writes 1.447 GB: 0.972 ms;
  * ``sign_pack_pass``: reads 1.447 GB, writes 0.045 GB (+ 1.447 GB):
    0.446 ms (0.878 ms);
  * ``sign_unpack_fma_pass``: reads 1.492 GB, writes 1.447 GB: 0.878 ms.

``PERF.md`` holds their measured times.  Each declares that work
(``*_cost``, no operation counted), which a wrapper given fake tensors
charges under the cost counter (:func:`repro_torch.kernels._cuda.traced`)
instead of launching.
"""
from __future__ import annotations

import ctypes
import os
from typing import Optional

import torch

from repro_torch.kernels._cuda import (LANES, CudaLibrary, KernelCost,
                                      charge, check_buf, check_flat,
                                      check_scalar, device_of, ptr,
                                      raise_on, stream, traced)
from repro_torch.kernels.comm import ref as R
from repro_torch.kernels.comm.ref import SIGN_PACK

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                      "comm.cu")


def _bind(lib: ctypes.CDLL) -> None:
    P, I64 = ctypes.c_void_p, ctypes.c_int64
    lib.cm_quantize_i8.argtypes = [P, P, P, P, I64, P]
    lib.cm_dequant_i8_fma.argtypes = [P, P, P, P, I64, P]
    lib.cm_sign_pack.argtypes = [P, P, I64, P, P, I64, P]
    lib.cm_sign_unpack_fma.argtypes = [P, P, P, I64, P, I64, P]
    for fn in (lib.cm_quantize_i8, lib.cm_dequant_i8_fma, lib.cm_sign_pack,
               lib.cm_sign_unpack_fma):
        fn.restype = ctypes.c_int


LIB = CudaLibrary("comm", SOURCE, _bind)
build = LIB.build


def quantize_i8_cost(rows: int, with_error: bool) -> KernelCost:
    buf = rows * LANES * 4.0
    return KernelCost(0.0, 0.0, buf, buf / 4 + (buf if with_error else 0))


def dequant_i8_fma_cost(rows: int) -> KernelCost:
    buf = rows * LANES * 4.0
    return KernelCost(0.0, 0.0, buf + buf / 4, buf)


def sign_pack_cost(rows: int, with_error: bool) -> KernelCost:
    buf = rows * LANES * 4.0
    return KernelCost(0.0, 0.0, buf, buf / 32 + (buf if with_error else 0))


def sign_unpack_fma_cost(rows: int) -> KernelCost:
    buf = rows * LANES * 4.0
    return KernelCost(0.0, 0.0, buf + buf / 32, buf)


def _check_out(out: Optional[torch.Tensor], shape) -> None:
    if out is not None:
        check_buf("out", out, shape)


def _check_n_valid(n_valid: int, shape) -> int:
    n_valid = int(n_valid)
    if not 0 <= n_valid <= shape[0] * shape[1]:
        raise ValueError(f"n_valid={n_valid} outside [0, {shape[0]} * "
                         f"{shape[1]}]")
    return n_valid


def _check_sign_rows(shape) -> None:
    if shape[0] % SIGN_PACK:
        raise ValueError(f"rows={shape[0]} must be a multiple of "
                         f"{SIGN_PACK} to pack sign bits")


# ---------------------------------------------------------------------------
# int8: quantize (+ residual) / dequantize-FMA
# ---------------------------------------------------------------------------
def quantize_i8_pass(g: torch.Tensor, scalars: torch.Tensor, *,
                     with_error: bool = False):
    """g: (rows, 128) fp32; scalars: (2,) fp32 ``[inv_scale, scale]`` on
    the same device.  Returns q (rows, 128) int8, and the residual
    ``g - q * scale`` (rows, 128) fp32 when ``with_error``.

    Replaces ``repro/kernels/comm/kernel.py::quantize_i8_pass``."""
    shape = check_flat("g", g)
    check_buf("g", g, shape)
    check_buf("scalars", scalars, (2,))
    dev = device_of(g, scalars)
    if traced(g, scalars):
        charge(quantize_i8_pass, quantize_i8_cost(shape[0], with_error))
        q = g.new_empty(shape, dtype=torch.int8)
        return (q, g.new_empty(shape)) if with_error else q
    if dev.type == "cpu":
        return R.quantize_i8_ref(g, scalars, with_error=with_error)
    lib = LIB.load()
    q = torch.empty(shape, dtype=torch.int8, device=dev)
    err = torch.empty_like(g) if with_error else None
    with torch.cuda.device(dev):
        code = lib.cm_quantize_i8(g.data_ptr(), scalars.data_ptr(),
                                  q.data_ptr(), ptr(err), g.numel(),
                                  stream(dev))
    raise_on(code, "quantize_i8_pass")
    quantize_i8_pass.launches += 1
    return (q, err) if with_error else q


quantize_i8_pass.launches = 0


def dequant_i8_fma_pass(acc: torch.Tensor, q: torch.Tensor,
                        scale_w: torch.Tensor, *,
                        out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """acc: (rows, 128) fp32; q: (rows, 128) int8; scale_w: one-element
    fp32 (``scale * w_k``).  Returns ``acc + scale_w * q``, written into
    ``out`` when given (``out=acc`` updates the accumulator in place).

    Replaces ``repro/kernels/comm/kernel.py::dequant_i8_fma_pass``."""
    shape = check_flat("acc", acc)
    check_buf("acc", acc, shape)
    check_buf("q", q, shape, torch.int8)
    check_scalar("scale_w", scale_w)
    _check_out(out, shape)
    dev = device_of(acc, q, scale_w, out)
    if traced(acc, q, scale_w, out):
        charge(dequant_i8_fma_pass, dequant_i8_fma_cost(shape[0]))
        return acc.new_empty(shape) if out is None else out
    if dev.type == "cpu":
        res = R.dequant_i8_fma_ref(acc, q, scale_w.reshape(()))
        return res if out is None else out.copy_(res)
    lib = LIB.load()
    if out is None:
        out = torch.empty_like(acc)
    scale_w = scale_w.reshape(1).contiguous()
    with torch.cuda.device(dev):
        code = lib.cm_dequant_i8_fma(acc.data_ptr(), q.data_ptr(),
                                     scale_w.data_ptr(), out.data_ptr(),
                                     acc.numel(), stream(dev))
    raise_on(code, "dequant_i8_fma_pass")
    dequant_i8_fma_pass.launches += 1
    return out


dequant_i8_fma_pass.launches = 0


# ---------------------------------------------------------------------------
# sign1bit: pack (+ residual) / unpack-FMA
# ---------------------------------------------------------------------------
def sign_pack_pass(g: torch.Tensor, mu: torch.Tensor, n_valid: int, *,
                   with_error: bool = False):
    """g: (rows, 128) fp32, rows a multiple of 8; mu: one-element fp32 (the
    group's mean |g|); n_valid: the group's true element count.  Returns
    the packed sign bits (rows / 8, 128) uint8 (row r of g in bit ``r % 8``
    of packed row ``r // 8``; ``g >= 0`` packs as 1), and the residual
    ``g - mu * mask * sign`` when ``with_error``.

    Replaces ``repro/kernels/comm/kernel.py::sign_pack_pass``."""
    shape = check_flat("g", g)
    check_buf("g", g, shape)
    _check_sign_rows(shape)
    check_scalar("mu", mu)
    n_valid = _check_n_valid(n_valid, shape)
    dev = device_of(g, mu)
    if traced(g, mu):
        charge(sign_pack_pass, sign_pack_cost(shape[0], with_error))
        bits = g.new_empty((shape[0] // SIGN_PACK, LANES), dtype=torch.uint8)
        return (bits, g.new_empty(shape)) if with_error else bits
    if dev.type == "cpu":
        return R.sign_pack_ref(g, mu.reshape(()), n_valid,
                               with_error=with_error)
    lib = LIB.load()
    bits = torch.empty((shape[0] // SIGN_PACK, LANES), dtype=torch.uint8,
                       device=dev)
    err = torch.empty_like(g) if with_error else None
    mu = mu.reshape(1).contiguous()
    with torch.cuda.device(dev):
        code = lib.cm_sign_pack(g.data_ptr(), mu.data_ptr(), n_valid,
                                bits.data_ptr(), ptr(err), shape[0],
                                stream(dev))
    raise_on(code, "sign_pack_pass")
    sign_pack_pass.launches += 1
    return (bits, err) if with_error else bits


sign_pack_pass.launches = 0


def sign_unpack_fma_pass(acc: torch.Tensor, packed: torch.Tensor,
                         mu_w: torch.Tensor, n_valid: int, *,
                         out: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """acc: (rows, 128) fp32; packed: (rows / 8, 128) uint8; mu_w:
    one-element fp32 (``mu * w_k``).  Returns ``acc + mu_w * sign`` with
    elements of flat index >= n_valid adding exact zeros, written into
    ``out`` when given (``out=acc`` updates in place).

    Replaces ``repro/kernels/comm/kernel.py::sign_unpack_fma_pass``."""
    shape = check_flat("acc", acc)
    check_buf("acc", acc, shape)
    _check_sign_rows(shape)
    check_buf("packed", packed, (shape[0] // SIGN_PACK, LANES), torch.uint8)
    check_scalar("mu_w", mu_w)
    n_valid = _check_n_valid(n_valid, shape)
    _check_out(out, shape)
    dev = device_of(acc, packed, mu_w, out)
    if traced(acc, packed, mu_w, out):
        charge(sign_unpack_fma_pass, sign_unpack_fma_cost(shape[0]))
        return acc.new_empty(shape) if out is None else out
    if dev.type == "cpu":
        res = R.sign_unpack_fma_ref(acc, packed, mu_w.reshape(()), n_valid)
        return res if out is None else out.copy_(res)
    lib = LIB.load()
    if out is None:
        out = torch.empty_like(acc)
    mu_w = mu_w.reshape(1).contiguous()
    with torch.cuda.device(dev):
        code = lib.cm_sign_unpack_fma(acc.data_ptr(), packed.data_ptr(),
                                      mu_w.data_ptr(), n_valid,
                                      out.data_ptr(), shape[0], stream(dev))
    raise_on(code, "sign_unpack_fma_pass")
    sign_unpack_fma_pass.launches += 1
    return out


sign_unpack_fma_pass.launches = 0

KERNELS = (quantize_i8_pass, dequant_i8_fma_pass, sign_pack_pass,
           sign_unpack_fma_pass)


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
