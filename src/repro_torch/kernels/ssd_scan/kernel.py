"""CUDA SSD chunked-scan kernel: build, binding and wrapper.

``repro/kernels/ssd_scan/kernel.py::ssd_scan_fwd`` (Pallas, TPU) is
written by hand for Hopper in ``csrc/ssd_scan.cu`` and built and loaded as
the other families are (:mod:`repro_torch.kernels._cuda`: ``nvcc`` for
``sm_90a`` at first use, into ``build/`` beside this file, keyed by a hash
of the source and flags).

The wrapper checks device, dtype, shape and strides, then:

  * for CPU tensors computes the plain PyTorch version
    (``ref.ssd_chunked_ref``) — the CPU tests run that, and nothing else
    takes it;
  * for CUDA tensors launches the kernel on the current stream, raises on
    the error code the launch returns, and adds one to its ``launches``
    count.  There is no fallback: a CUDA tensor gets the kernel or an
    error.

It takes the model's (B, S, H, P) layout, so the mamba block calls it
directly: where the JAX wrapper folds the heads and ``ssd_chunked``
repeats B and C to heads, the kernel reads x, B and C through their
strides (unit stride on the last axis), as views of the convolution's
output without copies, and B and C by group (head h reads group h // (H /
G)).  Besides y, it writes the final state: the JAX prefill takes
``h_final`` from ``ssd_chunked`` for the decode cache (the Pallas kernel
writes y only).  Like both, it starts from a zero state.  No backward: a
tensor that requires a gradient is refused (SSM-family training is a
ROADMAP item).  P = 64 or 128, N <= 128, chunk <= 256.  x, B and C are
fp32 or bf16 (one dtype; y in it too), dt and A fp32, as JAX's
``mamba_block`` hands them over at either dtype (dt is the softplus of an
fp32 sum); h_final is fp32.  A bf16 input is converted to fp32 as it is
loaded and the scan computes as at fp32, as JAX's kernel upcasts its
inputs (``repro/kernels/ssd_scan/kernel.py``).

The design (``csrc/ssd_scan.cu`` has it in full): SSD's chunk-parallel
algorithm in two device kernels a call, every product 3xTF32 on the
tensor cores (``wgmma``) at fp32 accuracy: (1) per (b, h), the chunks'
cumsums (sequential in index order, the bits ``torch.cumsum`` gives on
the card) and states, and the state passed across the chunks, with, in
the same launch, C B^T once per group (the heads of a group share B and
C); (2) each chunk's outputs, independently.  A block takes 64 columns of
P, so P = 128 (jamba's mamba layers) runs the state and output blocks
at two column offsets, C B^T still once per group.  The wrapper hands them
their scratch (``torch.empty``): the states entering the chunks (B H
nchunks x P x N fp32, 50 MB at the prefill), the cumsums and the C B^T
tiles (8 MB).
``launches`` counts calls; :func:`kernels_per_call` says how many device
kernels each one runs.

Bound at the serving prefill of mamba2-780m (B 8, 48 heads, one group, S
1024, P 64, N 128, chunk 256, one layer): 19.9 GFLOP with C B^T taken
once for the group, bound by operations: 0.123 ms as the kernel computes
it (3xTF32 products at the H100's 495 TFLOP/s, the rest at fp32's 67),
0.297 ms in fp32.  At bf16 the bound stays, with half the bytes of x, B,
C and y.  ``PERF.md`` holds the measured time.
:func:`ssd_cost` declares that work for any call, which the wrapper given
fake tensors charges under the cost counter
(:func:`repro_torch.kernels._cuda.traced`) instead of launching.
"""
from __future__ import annotations

import ctypes
import os
from typing import Tuple

import torch

from repro_torch.kernels._cuda import (CudaLibrary, KernelCost, charge,
                                      device_of, raise_on, stream, traced)
from repro_torch.kernels.ssd_scan import ref as R

HEAD_DIMS = (64, 128)
DTYPES = (torch.float32, torch.bfloat16)      # x, B, C (and y)
MAX_STATE = 128
MAX_CHUNK = 256

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                      "ssd_scan.cu")


def _bind(lib: ctypes.CDLL) -> None:
    P, I, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    for fn in (lib.ssd_forward, lib.ssd_forward_bf16):
        fn.argtypes = [P] * 10 + [I] * 7 + [I64] * 12 + [P]
        fn.restype = ctypes.c_int
    lib.ssd_kernels_per_call.argtypes = []
    lib.ssd_kernels_per_call.restype = ctypes.c_int


LIB = CudaLibrary("ssd_scan", SOURCE, _bind)
build = LIB.build


def ssd_cost(B: int, H: int, S: int, P: int, N: int, chunk: int,
             G=None, nbytes: int = 4) -> KernelCost:
    """One call at chunk L = min(chunk, S): x, dt, a, B and C read once, y
    written once; x, B, C and y at ``nbytes`` an element (4 or 2), dt,
    a and h_final at 4.  Per head and chunk: the causal half of C.B^T and of
    M.(x dt) (2N + 2P + 3 a pair), the carried state's term (2NP + N a
    position) and the state update (2NP + N a position, NP a chunk).  The
    matrix products (C.B^T and M.(x dt) over the causal half, C.h and the
    state update) are three TF32 tensor-core products each (3xTF32), the
    decays and masks fp32.

    With ``G`` groups given, what the kernel computes: C.B^T once per
    group (the heads of a group share B and C), B and C read once per
    group, and h_final written; without, every term per head, as the
    Pallas kernel takes them."""
    L = min(chunk, S)
    nc = -(-S // L)
    pairs = L * (L + 1) // 2
    per_head = pairs * (2 * P + 3) + L * (4 * N * P + 2 * N + P + 1) + N * P
    products = B * nc * (H * (pairs * 2 * P + L * 4 * N * P)
                         + (G or H) * pairs * 2 * N)
    if G is None:
        ops = B * H * nc * (per_head + pairs * 2 * N)
        written = B * H * S * P * nbytes
        read = B * H * S * ((P + 2 * N) * nbytes + 2 * 4)
    else:
        ops = B * nc * (H * per_head + G * pairs * 2 * N)
        written = B * H * S * P * nbytes + B * H * N * P * 4
        read = (B * H * S * (P * nbytes + 2 * 4)
                + B * G * S * 2 * N * nbytes)
    return KernelCost(float(ops - products), 3.0 * products, float(read),
                      float(written))


def _check_form(x, dt, A, Bm, Cm, P: int, N: int, L: int) -> None:
    """What the CUDA kernel takes beyond the plain version."""
    if P not in HEAD_DIMS or N > MAX_STATE or L > MAX_CHUNK:
        raise NotImplementedError(
            f"P={P}, N={N}, chunk={L}: the CUDA kernel takes P in "
            f"{HEAD_DIMS}, N <= {MAX_STATE}, chunk <= {MAX_CHUNK} (other "
            "shapes: ROADMAP Queue 2 row 12)")
    for name, t in (("x", x), ("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: expected unit stride on the last axis")


def _check(x, dt, A, Bm, Cm, chunk) -> Tuple[int, ...]:
    for name, t in (("x", x), ("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm)):
        want = DTYPES if name in ("x", "Bm", "Cm") else (torch.float32,)
        if t.dtype not in want or (name in ("Bm", "Cm")
                                   and t.dtype != x.dtype):
            raise TypeError(
                f"{name}: x, Bm and Cm of one dtype among {DTYPES}, dt and "
                f"A float32, got x {x.dtype}, dt {dt.dtype}, A {A.dtype}, "
                f"Bm {Bm.dtype}, Cm {Cm.dtype} (the kernel of ROADMAP Queue "
                "2 row 12)")
        if t.requires_grad:
            raise RuntimeError(
                f"{name} requires grad: the SSD-scan kernel has no "
                "backward; training runs through models/ssm.py::"
                "ssd_chunked")
    if x.dim() != 4:
        raise ValueError(f"x: expected (B, S, H, P), got {tuple(x.shape)}")
    B, S, H, P = x.shape
    if tuple(dt.shape) != (B, S, H) or tuple(A.shape) != (H,):
        raise ValueError(f"dt {tuple(dt.shape)} / A {tuple(A.shape)} do not "
                         f"match x {tuple(x.shape)}")
    if Bm.dim() != 4 or tuple(Bm.shape[:2]) != (B, S) \
            or tuple(Cm.shape) != tuple(Bm.shape):
        raise ValueError(f"Bm {tuple(Bm.shape)} / Cm {tuple(Cm.shape)} do "
                         f"not match x {tuple(x.shape)} as (B, S, G, N)")
    G, N = Bm.shape[2], Bm.shape[3]
    if G < 1 or H % G:
        raise ValueError(f"{H} heads are not a multiple of {G} groups")
    if int(chunk) < 1:
        raise ValueError(f"chunk={chunk} must be >= 1")
    return B, S, H, P, G, N


def ssd_scan_fwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, H, P); dt: (B, S, H) (softplus'ed, >= 0); A: (H,) < 0;
    Bm, Cm: (B, S, G, N) with G dividing H (G = H: broadcast already); x,
    Bm and Cm fp32 or bf16, dt and A fp32.  Returns (y (B, S, H, P)
    contiguous in x's dtype, h_final (B, H, N, P) fp32).

    Replaces ``repro/kernels/ssd_scan/kernel.py::ssd_scan_fwd``."""
    B, S, H, P, G, N = _check(x, dt, A, Bm, Cm, chunk)
    dev = device_of(x, dt, A, Bm, Cm)
    L = min(int(chunk), S)
    if traced(x, dt, A, Bm, Cm):
        _check_form(x, dt, A, Bm, Cm, P, N, L)
        charge(ssd_scan_fwd, ssd_cost(B, H, S, P, N, int(chunk), G=G,
                                      nbytes=x.element_size()))
        return x.new_empty((B, S, H, P)), x.new_empty((B, H, N, P))
    if dev.type == "cpu":
        return R.ssd_chunked_ref(x, dt, A, Bm, Cm, int(chunk))
    _check_form(x, dt, A, Bm, Cm, P, N, L)
    lib = LIB.load()
    nc = -(-S // L)
    y = torch.empty((B, S, H, P), dtype=x.dtype, device=dev)
    hT = torch.empty((B, H, N, P), dtype=torch.float32, device=dev)
    # scratch: the state entering each chunk (transposed, P x N), each
    # chunk's cumsum of a, and C B^T of each (b, group, chunk) in 64 x 32
    # tiles
    states = torch.empty((B * H * nc, P, N), dtype=torch.float32, device=dev)
    acum = torch.empty((B * H * nc, L), dtype=torch.float32, device=dev)
    cb = torch.empty((B * G * nc, -(-L // 64), -(-L // 32), 64 * 32),
                     dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        fwd = (lib.ssd_forward if x.dtype == torch.float32
               else lib.ssd_forward_bf16)
        code = fwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), y.data_ptr(), hT.data_ptr(), states.data_ptr(),
            acum.data_ptr(), cb.data_ptr(), B, S, H, G, N, P, L,
            *x.stride()[:3], *dt.stride(), *Bm.stride()[:3],
            *Cm.stride()[:3], stream(dev))
    raise_on(code, "ssd_scan_fwd")
    ssd_scan_fwd.launches += 1
    return y, hT


ssd_scan_fwd.launches = 0

KERNELS = (ssd_scan_fwd,)


def kernels_per_call() -> int:
    """Device kernels one ``ssd_scan_fwd`` call on a CUDA tensor launches
    (the states with C B^T per group, then the outputs); ``launches``
    counts calls."""
    return LIB.load().ssd_kernels_per_call()


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
