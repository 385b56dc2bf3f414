"""CUDA flash-attention forward kernel: build, binding and wrapper.

``repro/kernels/flash_attention/kernel.py::flash_attention_fwd`` (Pallas,
TPU) is written by hand for Hopper in ``csrc/flash_attention.cu`` and built
and loaded as the other families are (:mod:`repro_torch.kernels._cuda`:
``nvcc`` for ``sm_90a`` at first use, into ``build/`` beside this file,
keyed by a hash of the source and flags).

The wrapper checks device, dtype, shape and contiguity, then:

  * for CPU tensors computes the plain PyTorch version (``ref.py``) — the
    CPU tests run that, and nothing else takes it;
  * for CUDA tensors launches the kernel on the current stream, raises on
    the error code the launch returns, and adds one to its ``launches``
    count.  There is no fallback: a CUDA tensor gets the kernel or an
    error.

The kernel has no backward: a tensor that requires a gradient is refused
(training attends through the plain ``models.attention.attend``).  Head
dims 64 and 128 are built; fp32 only (bf16 inputs are ROADMAP Queue 2 row
11's open part).

Bound at the serving prefill of smollm-360m (B 8, 15/5 heads, S 1024, D
64, causal, one layer): 16.4 GFLOP, 83.9 MB — bound by operations, 0.244
ms at the H100's 67 fp32 TFLOP/s.  ``PERF.md`` holds the measured time.
"""
from __future__ import annotations

import ctypes
import math
import os

import torch

from repro_torch.kernels._cuda import CudaLibrary, device_of, raise_on, stream
from repro_torch.kernels.flash_attention import ref as R

HEAD_DIMS = (64, 128)
MAX_BLOCKS_Y = 65535          # the grid's y extent is B * H

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                      "flash_attention.cu")


def _bind(lib: ctypes.CDLL) -> None:
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.fa_forward.argtypes = [P, P, P, P, I, I, I, I, I, ctypes.c_float, I,
                               I, P]
    lib.fa_forward.restype = ctypes.c_int


LIB = CudaLibrary("flash_attention", SOURCE, _bind)
build = LIB.build


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> tuple:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected torch.float32, got {t.dtype} "
                            "(bf16 inputs: ROADMAP Queue 2 row 11)")
        if t.dim() != 3:
            raise ValueError(f"{name}: expected (heads, S, D), got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")
        if t.requires_grad:
            raise RuntimeError(
                f"{name} requires grad: the flash-attention kernel has no "
                "backward; differentiate through models.attention.attend")
    BH, Sq, D = q.shape
    BHkv, Skv, Dk = k.shape
    if tuple(v.shape) != (BHkv, Skv, Dk) or Dk != D:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if BHkv == 0 or BH % BHkv:
        raise ValueError(f"{BH} query heads are not a multiple of {BHkv} "
                         "key/value heads")
    return BH, Sq, Skv, D, BH // BHkv


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0
                        ) -> torch.Tensor:
    """q: (BH, Sq, D); k, v: (BHkv, Skv, D), fp32, contiguous, heads
    ordered (b, h); query head bh reads key/value head bh // (BH / BHkv).
    Any Sq and Skv.  Returns o (BH, Sq, D).

    Replaces ``repro/kernels/flash_attention/kernel.py::flash_attention_fwd``.
    """
    BH, Sq, Skv, D, group = _check(q, k, v)
    window = int(window)
    if window < 0:
        raise ValueError(f"window={window} must be >= 0")
    dev = device_of(q, k, v)
    if dev.type == "cpu":
        return R.attention_ref(q, k, v, causal=causal, window=window)
    if D not in HEAD_DIMS:
        raise NotImplementedError(
            f"head dim {D}: the CUDA kernel is built for {HEAD_DIMS} "
            "(other head dims: ROADMAP Queue 2 row 11)")
    if BH > MAX_BLOCKS_Y:
        raise ValueError(f"B * H = {BH} exceeds the grid's {MAX_BLOCKS_Y}")
    lib = LIB.load()
    o = torch.empty_like(q)
    with torch.cuda.device(dev):
        code = lib.fa_forward(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              o.data_ptr(), BH, Sq, Skv, D, group,
                              1.0 / math.sqrt(D), int(bool(causal)), window,
                              stream(dev))
    raise_on(code, "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    return o


flash_attention_fwd.launches = 0

KERNELS = (flash_attention_fwd,)


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
