"""CUDA flash-attention forward kernel: build, binding and wrapper.

``repro/kernels/flash_attention/kernel.py::flash_attention_fwd`` (Pallas,
TPU) is written by hand for Hopper in ``csrc/flash_attention.cu`` and built
and loaded as the other families are (:mod:`repro_torch.kernels._cuda`:
``nvcc`` for ``sm_90a`` at first use, into ``build/`` beside this file,
keyed by a hash of the source and flags).

The kernel reads q, k and v as strided ``(B, H, S, D)`` views (the model's
``(B, S, H, D)`` tensors transposed, no copy) and writes o through its own
strides, so :func:`repro_torch.kernels.flash_attention.flash_attention`
hands it the model's layout as it is and gets the output back in it.  Both
products run on the tensor cores (``wgmma``, one warpgroup per query head,
the query heads of a GQA group in one block) as 3xTF32: each operand split
into a TF32 high and low part, three products, which keeps fp32 accuracy;
see the source's note.

The wrapper checks device, dtype, shape and layout, then:

  * for CPU tensors computes the plain PyTorch version (``ref.py``) — the
    CPU tests run that, and nothing else takes it;
  * for CUDA tensors launches the kernel on the current stream, raises on
    the error code the launch returns, and adds one to its ``launches``
    count.  There is no fallback: a CUDA tensor gets the kernel or an
    error.

The kernel has no backward: a tensor that requires a gradient is refused
(training attends through the plain ``models.attention.attend``).  The
built forms (key head dim, value head dim) are :data:`FORMS`: 64, 96 and
128 for both (the dense configs), and (192, 128), MLA's prefill, whose
keys are wider than its values; fp32 and bf16 (q, k and v of one dtype).
At bf16 both products are bf16 ``wgmma`` into fp32, the softmax fp32, P
rounded to bf16 before P.V and o written in bf16, as JAX's kernel does
(``repro/kernels/flash_attention/kernel.py``: bf16 operands into the MXU
at fp32, ``p.astype(v.dtype)``, o in the input dtype).

Bound at the serving prefill of smollm-360m (B 8, 15/5 heads, S 1024, D
64, causal, one layer): 16.1 GFLOP of products, 83.9 MB.  As three TF32
products on the tensor cores (495 TFLOP/s) plus the softmax at fp32's 67
TFLOP/s: about 0.10 ms; in fp32 outside the tensor cores: 0.244 ms.  At
bf16 the same call is 16.374 GFLOP at 989 TFLOP/s (0.0166 ms) plus the
softmax's 0.252 GFLOP at 67 (0.0038 ms) against 41.9 MB (0.0125 ms):
bound by operations at 0.0201 ms.
``PERF.md`` holds the measured time.  :func:`attention_cost` declares
that work for any call, which the wrapper given fake tensors charges under
the cost counter (:func:`repro_torch.kernels._cuda.traced`) instead of
launching.
"""
from __future__ import annotations

import ctypes
import math
import os

import numpy as np
import torch

from repro_torch.kernels._cuda import (CudaLibrary, KernelCost, charge,
                                      device_of, raise_on, stream, traced)
from repro_torch.kernels.flash_attention import ref as R

FORMS = ((64, 64), (96, 96), (128, 128), (192, 128))   # (Dk, Dv)
MAX_QUERY_TILES = 65535       # the grid's y extent: ceil(Sq / 64)

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                      "flash_attention.cu")


DTYPES = (torch.float32, torch.bfloat16)


def _bind(lib: ctypes.CDLL) -> None:
    P, I = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.fa_forward, lib.fa_forward_bf16):
        fn.argtypes = [P, P, P, P, P, I, I, I, I, I, I, I, ctypes.c_float, I,
                       I, P]
        fn.restype = ctypes.c_int


LIB = CudaLibrary("flash_attention", SOURCE, _bind)
build = LIB.build


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> tuple:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in DTYPES or t.dtype != q.dtype:
            raise TypeError(
                f"{name}: expected q, k and v of one dtype among {DTYPES}, "
                f"got {q.dtype}, {k.dtype}, {v.dtype} (the kernel of "
                "ROADMAP Queue 2 row 11)")
        if t.dim() != 4:
            raise ValueError(f"{name}: expected (B, heads, S, D), got "
                             f"{tuple(t.shape)}")
        if t.requires_grad:
            raise RuntimeError(
                f"{name} requires grad: the flash-attention kernel has no "
                "backward; differentiate through models.attention.attend")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: the last dimension must have unit "
                             f"stride, got strides {t.stride()}")
    B, H, Sq, Dk = q.shape
    Bk, Hkv, Skv, Dkk = k.shape
    if (tuple(v.shape[:-1]) != tuple(k.shape[:-1]) or Dkk != Dk
            or Bk != B):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if Hkv == 0 or H % Hkv:
        raise ValueError(f"{H} query heads are not a multiple of {Hkv} "
                         "key/value heads")
    return B, H, Hkv, Sq, Skv, Dk, v.shape[-1]


def attention_pairs(Sq: int, Skv: int, *, causal: bool = True,
                    window: int = 0) -> int:
    """(query, key) pairs one head computes: query i against key j of
    the same sequence, j <= i when causal, i - j < window when given."""
    i = np.arange(Sq, dtype=np.int64)
    hi = np.minimum(i, Skv - 1) if causal else np.full_like(i, Skv - 1)
    lo = np.maximum(i - window + 1, 0) if window > 0 else np.zeros_like(i)
    return int(np.maximum(hi - lo + 1, 0).sum())


def attention_cost(B: int, H: int, Hkv: int, Sq: int, Skv: int, Dk: int,
                   Dv: int, *, causal: bool = True, window: int = 0,
                   nbytes: int = 4) -> KernelCost:
    """One call as the kernel computes it: q, k and v read once and o
    written once, ``nbytes`` an element; per (query, key) pair 2 Dk
    operations for q.k and 2 Dv for p.v, and 4 fp32 operations for scale,
    max, exp and sum.  At fp32 (``nbytes`` 4) each product is three TF32
    tensor-core products (3xTF32); at bf16 (``nbytes`` 2) one bf16
    tensor-core product."""
    pairs = B * H * attention_pairs(Sq, Skv, causal=causal, window=window)
    products = pairs * (2 * Dk + 2 * Dv)
    read = float((B * H * Sq * Dk + B * Hkv * Skv * (Dk + Dv)) * nbytes)
    written = float(B * H * Sq * Dv * nbytes)
    if nbytes == 2:
        return KernelCost(4.0 * pairs, 0.0, read, written, float(products))
    return KernelCost(4.0 * pairs, 3.0 * products, read, written)


def _check_form(q, k, v, Sq: int, Dk: int, Dv: int, *, fake: bool) -> None:
    """What the CUDA kernel takes beyond the plain version: a built
    (Dk, Dv) form, 16-byte copies, the grid's query tiles."""
    if (Dk, Dv) not in FORMS:
        raise NotImplementedError(
            f"head dims (Dk, Dv) = ({Dk}, {Dv}): the CUDA kernel is built "
            f"for {FORMS} (other head dims: ROADMAP Queue 2 row 11)")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not _aligned(t, fake=fake):
            raise ValueError(f"{name}: the kernel copies 16 bytes at a time "
                             "and needs a 16-byte aligned base and strides "
                             f"that are multiples of 4, got {t.stride()}")
    if (Sq + 63) // 64 > MAX_QUERY_TILES:
        raise ValueError(f"Sq = {Sq} exceeds the grid's {MAX_QUERY_TILES} "
                         "query tiles")


def _aligned(t: torch.Tensor, *, fake: bool = False) -> bool:
    """16-byte copies: base 16-byte aligned, batch/head/seq strides whole
    16-byte chunks (the last dimension is unit stride, checked before)."""
    per = 16 // t.element_size()
    return ((fake or t.data_ptr() % 16 == 0)
            and all(s % per == 0 for s in t.stride()[:3]))


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0
                        ) -> torch.Tensor:
    """q: (B, H, Sq, Dk); k: (B, Hkv, Skv, Dk); v: (B, Hkv, Skv, Dv), fp32
    or bf16 (one dtype; o in it too), any strides with the last dimension at unit stride; query head h reads
    key/value head h // (H / Hkv); scores scaled by 1 / sqrt(Dk).  The
    folded form, (BH, Sq, Dk) and (BHkv, Skv, Dk | Dv) with heads ordered
    (b, h), is the case B = 1 (``unsqueeze(0)``).  Any Sq and Skv.

    Returns o, a (B, H, Sq, Dv) view of a contiguous (B, Sq, H, Dv) tensor
    (the model's layout).

    Replaces ``repro/kernels/flash_attention/kernel.py::flash_attention_fwd``.
    """
    B, H, Hkv, Sq, Skv, Dk, Dv = _check(q, k, v)
    window = int(window)
    if window < 0:
        raise ValueError(f"window={window} must be >= 0")
    dev = device_of(q, k, v)
    if traced(q, k, v):
        _check_form(q, k, v, Sq, Dk, Dv, fake=True)
        charge(flash_attention_fwd, attention_cost(
            B, H, Hkv, Sq, Skv, Dk, Dv, causal=causal, window=window,
            nbytes=q.element_size()))
        return q.new_empty((B, Sq, H, Dv)).transpose(1, 2)
    o = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=dev).transpose(1, 2)
    if dev.type == "cpu":
        fold = lambda t: t.reshape(-1, *t.shape[-2:])
        return o.copy_(R.attention_ref(fold(q), fold(k), fold(v),
                                       causal=causal, window=window
                                       ).view(o.shape))
    _check_form(q, k, v, Sq, Dk, Dv, fake=False)
    lib = LIB.load()
    strides = (ctypes.c_int64 * 12)(*(s for t in (q, k, v, o)
                                       for s in t.stride()[:3]))
    fwd = lib.fa_forward if q.dtype == torch.float32 else lib.fa_forward_bf16
    with torch.cuda.device(dev):
        code = fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              o.data_ptr(), strides, B, Hkv, Sq, Skv, Dk,
                              Dv, H // Hkv, 1.0 / math.sqrt(Dk),
                              int(bool(causal)), window, stream(dev))
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
