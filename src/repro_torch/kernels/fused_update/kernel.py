"""CUDA kernels of the fused server update: build, binding and wrappers.

The three forward kernels of ``repro/kernels/fused_update/kernel.py``
(Pallas, TPU) are written by hand for Hopper in
``csrc/fused_update.cu`` and compiled with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with :mod:`ctypes`.  The
build happens at first use, into ``build/`` beside this file, keyed by a
hash of the source and flags, so a fresh checkout builds everything it
runs and a changed source never loads a stale library.

Each wrapper checks device, dtype, shape and contiguity, then:

  * for CPU tensors computes the plain PyTorch version (``ref.py``) — the
    CPU tests run that, and nothing else takes it;
  * for CUDA tensors launches the kernel on the current stream, raises on
    the error code the launch returns, and adds one to its ``launches``
    count.  There is no fallback: a CUDA tensor gets the kernel or an
    error.

Bounds at the full width of smollm-360m (rows = 2,826,728; one fp32 buffer
is 1.447 GB; H100 SXM, 3.35 TB/s):

  * ``aggregate_pass`` (cohort 4): reads 5.79 GB, writes 1.45 GB;
  * ``accumulate_pass``: reads 2.89 GB, writes 1.45 GB;
  * ``update_pass``: sgd reads 2.89 GB, writes 1.45 GB; adam reads
    5.79 GB, writes 4.34 GB.

All three are bound by bytes; ``PERF.md`` holds their measured times.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional, Tuple

import torch

from repro_torch.kernels.fused_update import ref as R

LANES = 128
OPT_CODES = {"sgd": 0, "sgdm": 1, "adam": 2, "yogi": 3}
AGG_THREADS = 256
AGG_MAX_BLOCKS = 1024        # fixed, so ssq is a function of n alone

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "csrc", "fused_update.cu")
BUILD_DIR = os.path.join(_HERE, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_log = ""               # nvcc's output (-Xptxas -v) from the last build


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found to build the fused "
                           "update kernels (set CUDA_HOME)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build(force: bool = False) -> str:
    """Compile the kernels' shared library if needed; returns its path."""
    global build_log
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()
                                ).hexdigest()[:16]
    path = os.path.join(BUILD_DIR, f"libfused_update_{digest}.so")
    if os.path.exists(path) and not force:
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
                          capture_output=True, text=True)
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
    os.replace(tmp, path)
    return path


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            P, I64, I, F = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                            ctypes.c_float)
            lib.fu_aggregate.argtypes = [P, P, P, P, P, I64, I, I, P]
            lib.fu_accumulate.argtypes = [P, P, P, P, I64, P]
            lib.fu_update.argtypes = [I, P, P, P, P, P, P, P, P, I64,
                                      F, F, F, F, F, F, P]
            for fn in (lib.fu_aggregate, lib.fu_accumulate, lib.fu_update):
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def _check_buf(name: str, t: torch.Tensor, shape: Tuple[int, ...]) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _device_of(*ts: torch.Tensor) -> torch.device:
    devs = {t.device for t in ts if t is not None}
    if len(devs) != 1:
        raise ValueError("tensors on different devices: "
                         f"{sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err} "
                           f"({torch.cuda.get_device_name()})")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


# ---------------------------------------------------------------------------
# Pass 1: weighted cohort reduce + global sum of squares
# ---------------------------------------------------------------------------
def aggregate_pass(g_stack: torch.Tensor, w_norm: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """g_stack: (cohort, rows, 128) fp32; w_norm: (cohort,) normalized
    weights on the same device.  Returns (G (rows, 128), ssq ()).

    Replaces ``repro/kernels/fused_update/kernel.py::aggregate_pass``."""
    if g_stack.dim() != 3 or g_stack.shape[-1] != LANES:
        raise ValueError(f"g_stack: expected (cohort, rows, {LANES}), got "
                         f"{tuple(g_stack.shape)}")
    cohort, rows, _ = g_stack.shape
    _check_buf("g_stack", g_stack, (cohort, rows, LANES))
    _check_buf("w_norm", w_norm, (cohort,))
    dev = _device_of(g_stack, w_norm)
    if dev.type == "cpu":
        return R.aggregate_ref(g_stack, w_norm)
    lib = _load()
    n = rows * LANES
    nblocks = max(1, min(-(-(n // 4) // AGG_THREADS), AGG_MAX_BLOCKS))
    G = torch.empty((rows, LANES), dtype=torch.float32, device=dev)
    partials = torch.empty((nblocks,), dtype=torch.float64, device=dev)
    ssq = torch.empty((), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.fu_aggregate(g_stack.data_ptr(), w_norm.data_ptr(),
                               G.data_ptr(), partials.data_ptr(),
                               ssq.data_ptr(), n, cohort, nblocks,
                               _stream(dev))
    _raise_on(err, "aggregate_pass")
    aggregate_pass.launches += 1
    return G, ssq


aggregate_pass.launches = 0


# ---------------------------------------------------------------------------
# Streaming pass (scan strategy): acc + w * g in one sweep
# ---------------------------------------------------------------------------
def accumulate_pass(acc: torch.Tensor, g: torch.Tensor, w: torch.Tensor, *,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """acc/g: (rows, 128) fp32; w: one-element fp32 tensor (the normalized
    client weight) on the same device.  Returns ``acc + w * g``, written
    into ``out`` when given (``out=acc`` updates the accumulator in place,
    which the scan executor does to keep one buffer alive).

    Replaces ``repro/kernels/fused_update/kernel.py::accumulate_pass``."""
    if acc.dim() != 2 or acc.shape[-1] != LANES:
        raise ValueError(f"acc: expected (rows, {LANES}), got "
                         f"{tuple(acc.shape)}")
    shape = tuple(acc.shape)
    _check_buf("acc", acc, shape)
    _check_buf("g", g, shape)
    if w.dtype != torch.float32 or w.numel() != 1:
        raise ValueError("w: expected a one-element float32 tensor")
    if out is not None:
        _check_buf("out", out, shape)
    dev = _device_of(acc, g, w, out)
    if dev.type == "cpu":
        res = R.accumulate_ref(acc, g, w.reshape(()))
        if out is None:
            return res
        return out.copy_(res)
    lib = _load()
    if out is None:
        out = torch.empty_like(acc)
    w = w.reshape(1).contiguous()
    with torch.cuda.device(dev):
        err = lib.fu_accumulate(acc.data_ptr(), g.data_ptr(), w.data_ptr(),
                                out.data_ptr(), acc.numel(), _stream(dev))
    _raise_on(err, "accumulate_pass")
    accumulate_pass.launches += 1
    return out


accumulate_pass.launches = 0


# ---------------------------------------------------------------------------
# Pass 2: clip scale + server optimizer + parameter write
# ---------------------------------------------------------------------------
def update_pass(G: torch.Tensor, p: torch.Tensor, m: Optional[torch.Tensor],
                v: Optional[torch.Tensor], scalars: torch.Tensor, *, opt: str,
                momentum: float = 0.9, b1: float = 0.9, b2: float = 0.99,
                eps: float = 1e-8):
    """One fused optimizer sweep over a flat buffer group.

    scalars: (4,) fp32 = [scale, lr, bc1, bc2] on the device.  Returns
    (new_p, new_m, new_v) with None slots per optimizer arity.

    Replaces ``repro/kernels/fused_update/kernel.py::update_pass``."""
    if opt not in OPT_CODES:
        raise ValueError(f"unknown optimizer {opt!r}")
    shape = tuple(G.shape)
    if len(shape) != 2 or shape[-1] != LANES:
        raise ValueError(f"G: expected (rows, {LANES}), got {shape}")
    _check_buf("G", G, shape)
    _check_buf("p", p, shape)
    need_m = opt != "sgd"
    need_v = opt in ("adam", "yogi")
    if need_m != (m is not None) or need_v != (v is not None):
        raise ValueError(f"{opt}: optimizer slots m/v do not match")
    if m is not None:
        _check_buf("m", m, shape)
    if v is not None:
        _check_buf("v", v, shape)
    _check_buf("scalars", scalars, (4,))
    dev = _device_of(G, p, m, v, scalars)
    if dev.type == "cpu":
        return R.update_ref(G, p, m, v, scalars, opt=opt, momentum=momentum,
                            b1=b1, b2=b2, eps=eps)
    lib = _load()
    new_p = torch.empty_like(p)
    new_m = torch.empty_like(p) if need_m else None
    new_v = torch.empty_like(p) if need_v else None
    with torch.cuda.device(dev):
        err = lib.fu_update(OPT_CODES[opt], G.data_ptr(), p.data_ptr(),
                            _ptr(m), _ptr(v), scalars.data_ptr(),
                            new_p.data_ptr(), _ptr(new_m), _ptr(new_v),
                            G.numel(), momentum, b1, 1.0 - b1, b2, 1.0 - b2,
                            eps, _stream(dev))
    _raise_on(err, "update_pass")
    update_pass.launches += 1
    return new_p, new_m, new_v


update_pass.launches = 0

KERNELS = (aggregate_pass, accumulate_pass, update_pass)


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
