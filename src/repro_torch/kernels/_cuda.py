"""What the kernel families of the port share (``kernels/fused_update``,
``kernels/comm``): building and loading a family's CUDA source, and the
checks every wrapper makes before it hands pointers to a kernel.

Each family keeps its kernels in one ``csrc/*.cu`` file with a plain C
interface.  :class:`CudaLibrary` compiles it with ``nvcc`` for ``sm_90a``
into a shared library at first use, in ``build/`` beside the family's
``kernel.py`` (``.gitignore`` lists every such directory), keyed by a hash
of the source and the flags, so a fresh checkout builds what it runs and a
changed source never loads a stale library.  The library is loaded with
:mod:`ctypes`; the family's ``bind`` callback declares the entry points'
``argtypes`` and ``restype``.  Nothing is built when a module is imported:
only a launch on a CUDA tensor (or an explicit :meth:`CudaLibrary.build`)
calls ``nvcc``.

Each kernel also declares its cost as a function of its shapes
(:class:`KernelCost`: the counts its bound is computed from).  Under the
cost counter of :mod:`repro_torch.roofline.cost` a wrapper given fake
tensors charges that cost (:func:`charge`) instead of launching; see
:func:`traced`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Callable, List, NamedTuple, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import is_fake

LANES = 128           # last axis of every flat buffer (repro_torch.core.flat)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found to build the kernels "
                           "(set CUDA_HOME)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


class CudaLibrary:
    """One ``.cu`` source -> one loaded shared library."""

    def __init__(self, name: str, source: str,
                 bind: Callable[[ctypes.CDLL], None]):
        self.name = name
        self.source = source
        self.build_dir = os.path.join(os.path.dirname(os.path.dirname(
            source)), "build")
        self._bind = bind
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None
        self.build_log = ""      # nvcc's output (-Xptxas -v), last build

    def build(self, force: bool = False) -> str:
        """Compile the shared library if needed; returns its path."""
        with open(self.source, "rb") as f:
            digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()
                                    ).hexdigest()[:16]
        path = os.path.join(self.build_dir, f"lib{self.name}_{digest}.so")
        if os.path.exists(path) and not force:
            return path
        os.makedirs(self.build_dir, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, self.source],
                              capture_output=True, text=True)
        self.build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {self.source} "
                               f"({proc.returncode}):\n{self.build_log}")
        os.replace(tmp, path)
        return path

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(self.build())
                self._bind(lib)
                self._lib = lib
            return self._lib


class KernelCost(NamedTuple):
    """One launch's work: fp32 operations, TF32 tensor-core operations
    (3xTF32: three TF32 products for each fp32 product), bytes read, bytes
    written, and bf16 tensor-core operations (a bf16 kernel's products,
    one each)."""
    flops: float
    tc_flops: float
    bytes_read: float
    bytes_written: float
    bf16_flops: float = 0.0


# the cost counters open now, innermost last (repro_torch.roofline.cost)
COST_COUNTERS: List = []


def traced(*ts: Optional[torch.Tensor]) -> bool:
    """Whether this call is traced by a cost counter that charges the
    kernels' declared costs.  False for real tensors, and for fake ones
    under a counter that traces the plain versions; raises for a fake
    tensor with no counter open (nothing could launch on it)."""
    if not any(t is not None and is_fake(t) for t in ts):
        return False
    if not COST_COUNTERS:
        raise RuntimeError(
            "a fake tensor reached a kernel wrapper with no cost counter "
            "open: trace the call with repro_torch.roofline.trace_cost")
    return COST_COUNTERS[-1].charge_kernels


def charge(fn, cost: KernelCost) -> None:
    """Charge one launch of kernel ``fn`` to the open counter."""
    COST_COUNTERS[-1].charge(fn.__name__, cost)


def check_buf(name: str, t: torch.Tensor, shape: Tuple[int, ...],
              dtype: torch.dtype = torch.float32) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def check_flat(name: str, t: torch.Tensor) -> Tuple[int, ...]:
    if t.dim() != 2 or t.shape[-1] != LANES:
        raise ValueError(f"{name}: expected (rows, {LANES}), got "
                         f"{tuple(t.shape)}")
    return tuple(t.shape)


def check_scalar(name: str, t: torch.Tensor) -> None:
    if t.dtype != torch.float32 or t.numel() != 1:
        raise ValueError(f"{name}: expected a one-element float32 tensor")


def device_of(*ts: Optional[torch.Tensor]) -> torch.device:
    """The one device of the given tensors (None entries skipped): the CPU,
    where a wrapper computes the plain version, or a CUDA device."""
    devs = {t.device for t in ts if t is not None}
    if len(devs) != 1:
        raise ValueError("tensors on different devices: "
                         f"{sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err} "
                           f"({torch.cuda.get_device_name()})")


def ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream
