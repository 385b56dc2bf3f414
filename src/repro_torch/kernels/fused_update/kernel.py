"""CUDA kernels of the fused server update: build, binding and wrappers.

The six kernels of ``repro/kernels/fused_update/kernel.py`` (Pallas, TPU),
three forward passes and their backward passes, are written by hand for
Hopper in ``csrc/fused_update.cu`` and compiled with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, loaded with
:mod:`ctypes`.  The build happens at first use, into ``build/`` beside
this file, keyed by a hash of the source and flags, so a fresh checkout
builds everything it runs and a changed source never loads a stale
library (:mod:`repro_torch.kernels._cuda`).

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
    5.79 GB, writes 4.34 GB;
  * ``accumulate_pass_bwd``: reads 2.89 GB, writes 1.45 GB;
  * ``aggregate_pass_bwd`` (cohort 4): reads 8.68 GB, writes 5.79 GB;
  * ``update_pass_bwd``: sgd reads 2.89 GB, writes 1.45 GB; adam reads
    8.68 GB, writes 4.34 GB.

All six are bound by bytes; ``PERF.md`` holds their measured times.
Each declares that work (``*_cost``: bytes of every fp32 buffer read once
and written once, no operation counted), which a wrapper given fake
tensors charges under the cost counter (:func:`repro_torch.kernels._cuda.
traced`) instead of launching.
``accumulate_pass`` (four launches a scan round) reads g and writes out
with streaming cache hints; the source's note gives the times of the forms
``tools/accumulate_forms.py`` compares.  The
backward kernels' sums (``dw``, ``dscal``) are fp64 per-block partials over
a fixed grid, added in a fixed order, so they are bitwise equal from launch
to launch.
"""
from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import torch

from repro_torch.kernels._cuda import (LANES, CudaLibrary, KernelCost,
                                      charge, check_buf, check_flat,
                                      check_scalar, device_of, ptr,
                                      raise_on, stream, traced)
from repro_torch.kernels.fused_update import ref as R

OPT_CODES = {"sgd": 0, "sgdm": 1, "adam": 2, "yogi": 3}
AGG_THREADS = 256
AGG_MAX_BLOCKS = 1024        # fixed, so every sum is a function of n alone

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                      "fused_update.cu")


def _bind(lib: ctypes.CDLL) -> None:
    P, I64, I, F = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                    ctypes.c_float)
    lib.fu_aggregate.argtypes = [P, P, P, P, P, I64, I, I, P]
    lib.fu_accumulate.argtypes = [P, P, P, P, I64, P]
    lib.fu_update.argtypes = [I, P, P, P, P, P, P, P, P, I64,
                              F, F, F, F, F, F, P]
    lib.fu_accumulate_bwd.argtypes = [P, P, P, P, P, P, I64, I, P]
    lib.fu_aggregate_bwd.argtypes = [P, P, P, P, P, P, P, P, I64, I, I, P]
    lib.fu_update_bwd.argtypes = [I, P, P, P, P, P, P, P, P, P, P,
                                  P, P, I64, F, F, F, F, F, F, I, P]
    for fn in (lib.fu_aggregate, lib.fu_accumulate, lib.fu_update,
               lib.fu_accumulate_bwd, lib.fu_aggregate_bwd,
               lib.fu_update_bwd):
        fn.restype = ctypes.c_int


LIB = CudaLibrary("fused_update", SOURCE, _bind)
build = LIB.build
_load = LIB.load


_SLOTS = {"sgd": 0, "sgdm": 1, "adam": 2, "yogi": 2}


def _buf(rows: int) -> float:
    """Bytes of one fp32 flat buffer of ``rows`` rows."""
    return rows * LANES * 4.0


def aggregate_cost(cohort: int, rows: int) -> KernelCost:
    return KernelCost(0.0, 0.0, cohort * _buf(rows), _buf(rows))


def accumulate_cost(rows: int) -> KernelCost:
    return KernelCost(0.0, 0.0, 2 * _buf(rows), _buf(rows))


def update_cost(opt: str, rows: int) -> KernelCost:
    """G and p read, p written, and each optimizer slot read and written."""
    k = _SLOTS[opt]
    return KernelCost(0.0, 0.0, (2 + k) * _buf(rows), (1 + k) * _buf(rows))


def accumulate_bwd_cost(rows: int) -> KernelCost:
    return KernelCost(0.0, 0.0, 2 * _buf(rows), _buf(rows))


def aggregate_bwd_cost(cohort: int, rows: int) -> KernelCost:
    return KernelCost(0.0, 0.0, (cohort + 2) * _buf(rows),
                      cohort * _buf(rows))


def update_bwd_cost(opt: str, rows: int) -> KernelCost:
    """G, each slot and the cotangent of p and of each slot read; the
    cotangents of G and of each slot written."""
    k = _SLOTS[opt]
    return KernelCost(0.0, 0.0, (2 + 2 * k) * _buf(rows),
                      (1 + k) * _buf(rows))


def _nblocks(n: int) -> int:
    """The fixed grid of a kernel that sums over ``n`` floats."""
    return max(1, min(-(-(n // 4) // AGG_THREADS), AGG_MAX_BLOCKS))


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
    check_buf("g_stack", g_stack, (cohort, rows, LANES))
    check_buf("w_norm", w_norm, (cohort,))
    dev = device_of(g_stack, w_norm)
    if traced(g_stack, w_norm):
        charge(aggregate_pass, aggregate_cost(cohort, rows))
        return g_stack.new_empty((rows, LANES)), g_stack.new_empty(())
    if dev.type == "cpu":
        return R.aggregate_ref(g_stack, w_norm)
    lib = _load()
    n = rows * LANES
    nblocks = _nblocks(n)
    G = torch.empty((rows, LANES), dtype=torch.float32, device=dev)
    partials = torch.empty((nblocks,), dtype=torch.float64, device=dev)
    ssq = torch.empty((), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.fu_aggregate(g_stack.data_ptr(), w_norm.data_ptr(),
                               G.data_ptr(), partials.data_ptr(),
                               ssq.data_ptr(), n, cohort, nblocks,
                               stream(dev))
    raise_on(err, "aggregate_pass")
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
    shape = check_flat("acc", acc)
    check_buf("acc", acc, shape)
    check_buf("g", g, shape)
    check_scalar("w", w)
    if out is not None:
        check_buf("out", out, shape)
    dev = device_of(acc, g, w, out)
    if traced(acc, g, w, out):
        charge(accumulate_pass, accumulate_cost(shape[0]))
        return acc.new_empty(shape) if out is None else out
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
                                out.data_ptr(), acc.numel(), stream(dev))
    raise_on(err, "accumulate_pass")
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
    shape = check_flat("G", G)
    check_buf("G", G, shape)
    check_buf("p", p, shape)
    need_m, need_v = _check_slots(opt, shape, m=m, v=v)
    check_buf("scalars", scalars, (4,))
    dev = device_of(G, p, m, v, scalars)
    if traced(G, p, m, v, scalars):
        charge(update_pass, update_cost(opt, shape[0]))
        return (p.new_empty(shape), p.new_empty(shape) if need_m else None,
                p.new_empty(shape) if need_v else None)
    if dev.type == "cpu":
        return R.update_ref(G, p, m, v, scalars, opt=opt, momentum=momentum,
                            b1=b1, b2=b2, eps=eps)
    lib = _load()
    new_p = torch.empty_like(p)
    new_m = torch.empty_like(p) if need_m else None
    new_v = torch.empty_like(p) if need_v else None
    with torch.cuda.device(dev):
        err = lib.fu_update(OPT_CODES[opt], G.data_ptr(), p.data_ptr(),
                            ptr(m), ptr(v), scalars.data_ptr(),
                            new_p.data_ptr(), ptr(new_m), ptr(new_v),
                            G.numel(), momentum, b1, 1.0 - b1, b2, 1.0 - b2,
                            eps, stream(dev))
    raise_on(err, "update_pass")
    update_pass.launches += 1
    return new_p, new_m, new_v


update_pass.launches = 0


def _check_slots(opt: str, shape, **slots) -> Tuple[bool, bool]:
    """Optimizer-state buffers (``m``/``v`` and their cotangents) are
    given exactly where ``opt`` has the slot, each of ``shape``."""
    need_m = opt != "sgd"
    need_v = opt in ("adam", "yogi")
    for name, t in slots.items():
        need = need_v if name.endswith("v") else need_m
        if need != (t is not None):
            raise ValueError(f"{opt}: optimizer slot {name} "
                             f"{'missing' if need else 'not expected'}")
        if t is not None:
            check_buf(name, t, shape)
    return need_m, need_v


# ---------------------------------------------------------------------------
# Backward of the streaming pass: dg = w d_out, dw = <g, d_out>
# ---------------------------------------------------------------------------
def accumulate_pass_bwd(g: torch.Tensor, w: torch.Tensor,
                        d_out: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """VJP of :func:`accumulate_pass` w.r.t. (g, w); the accumulator's
    cotangent is ``d_out`` itself.  g/d_out: (rows, 128) fp32; w: the
    forward's one-element weight.  Returns (dg (rows, 128), dw ()).

    Replaces ``repro/kernels/fused_update/kernel.py::accumulate_pass_bwd``."""
    shape = check_flat("g", g)
    check_buf("g", g, shape)
    check_buf("d_out", d_out, shape)
    check_scalar("w", w)
    dev = device_of(g, w, d_out)
    if traced(g, w, d_out):
        charge(accumulate_pass_bwd, accumulate_bwd_cost(shape[0]))
        return g.new_empty(shape), g.new_empty(())
    if dev.type == "cpu":
        return R.accumulate_bwd_ref(g, w.reshape(()), d_out)
    lib = _load()
    n = g.numel()
    nblocks = _nblocks(n)
    dg = torch.empty_like(g)
    partials = torch.empty((nblocks,), dtype=torch.float64, device=dev)
    dw = torch.empty((), dtype=torch.float32, device=dev)
    w = w.reshape(1).contiguous()
    with torch.cuda.device(dev):
        err = lib.fu_accumulate_bwd(g.data_ptr(), w.data_ptr(),
                                    d_out.data_ptr(), dg.data_ptr(),
                                    partials.data_ptr(), dw.data_ptr(), n,
                                    nblocks, stream(dev))
    raise_on(err, "accumulate_pass_bwd")
    accumulate_pass_bwd.launches += 1
    return dg, dw


accumulate_pass_bwd.launches = 0


# ---------------------------------------------------------------------------
# Backward of pass 1: cotangent scatter + per-client weight cotangents
# ---------------------------------------------------------------------------
def aggregate_pass_bwd(g_stack: torch.Tensor, w_norm: torch.Tensor,
                       G: torch.Tensor, dG: torch.Tensor, dssq: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """VJP of :func:`aggregate_pass` w.r.t. (g_stack, w_norm): the forward's
    inputs, its saved output ``G`` and the cotangents (dG, dssq).  Returns
    (dg_stack (cohort, rows, 128), dw (cohort,)); ``dg_stack`` is written
    whole, as the Pallas kernel writes it.

    Replaces ``repro/kernels/fused_update/kernel.py::aggregate_pass_bwd``."""
    if g_stack.dim() != 3 or g_stack.shape[-1] != LANES:
        raise ValueError(f"g_stack: expected (cohort, rows, {LANES}), got "
                         f"{tuple(g_stack.shape)}")
    cohort, rows, _ = g_stack.shape
    check_buf("g_stack", g_stack, (cohort, rows, LANES))
    check_buf("w_norm", w_norm, (cohort,))
    check_buf("G", G, (rows, LANES))
    check_buf("dG", dG, (rows, LANES))
    check_scalar("dssq", dssq)
    dev = device_of(g_stack, w_norm, G, dG, dssq)
    if traced(g_stack, w_norm, G, dG, dssq):
        charge(aggregate_pass_bwd, aggregate_bwd_cost(cohort, rows))
        return g_stack.new_empty(g_stack.shape), g_stack.new_empty((cohort,))
    if dev.type == "cpu":
        return R.aggregate_bwd_ref(g_stack, w_norm, G, dG, dssq.reshape(()))
    lib = _load()
    n = rows * LANES
    nblocks = _nblocks(n)
    dg = torch.empty_like(g_stack)
    partials = torch.empty((cohort, nblocks), dtype=torch.float64,
                           device=dev)
    dw = torch.empty((cohort,), dtype=torch.float32, device=dev)
    dssq = dssq.reshape(1).contiguous()
    with torch.cuda.device(dev):
        err = lib.fu_aggregate_bwd(g_stack.data_ptr(), w_norm.data_ptr(),
                                   dssq.data_ptr(), G.data_ptr(),
                                   dG.data_ptr(), dg.data_ptr(),
                                   partials.data_ptr(), dw.data_ptr(), n,
                                   cohort, nblocks, stream(dev))
    raise_on(err, "aggregate_pass_bwd")
    aggregate_pass_bwd.launches += 1
    return dg, dw


aggregate_pass_bwd.launches = 0


# ---------------------------------------------------------------------------
# Backward of pass 2: cotangents through clip scale + optimizer recurrence
# ---------------------------------------------------------------------------
def update_pass_bwd(G: torch.Tensor, m: Optional[torch.Tensor],
                    v: Optional[torch.Tensor], scalars: torch.Tensor,
                    d_new_p: torch.Tensor, d_new_m: Optional[torch.Tensor],
                    d_new_v: Optional[torch.Tensor], *, opt: str,
                    momentum: float = 0.9, b1: float = 0.9, b2: float = 0.99,
                    eps: float = 1e-8):
    """VJP of :func:`update_pass` w.r.t. (G, m, v, scalars), replaying the
    recurrence from the forward's (G, m, v, scalars); the parameter's
    cotangent is ``d_new_p`` itself.  Returns (dG, dm, dv, dscalars (4,) =
    [dscale, dlr, dbc1, dbc2]) with None slots per optimizer arity.

    Replaces ``repro/kernels/fused_update/kernel.py::update_pass_bwd``."""
    if opt not in OPT_CODES:
        raise ValueError(f"unknown optimizer {opt!r}")
    shape = check_flat("G", G)
    check_buf("G", G, shape)
    check_buf("d_new_p", d_new_p, shape)
    need_m, need_v = _check_slots(opt, shape, m=m, v=v, d_new_m=d_new_m,
                                  d_new_v=d_new_v)
    check_buf("scalars", scalars, (4,))
    dev = device_of(G, m, v, scalars, d_new_p, d_new_m, d_new_v)
    if traced(G, m, v, scalars, d_new_p, d_new_m, d_new_v):
        charge(update_pass_bwd, update_bwd_cost(opt, shape[0]))
        return (G.new_empty(shape), G.new_empty(shape) if need_m else None,
                G.new_empty(shape) if need_v else None, G.new_empty((4,)))
    if dev.type == "cpu":
        return R.update_bwd_ref(G, m, v, scalars, d_new_p, d_new_m, d_new_v,
                                opt=opt, momentum=momentum, b1=b1, b2=b2,
                                eps=eps)
    lib = _load()
    n = G.numel()
    nblocks = _nblocks(n)
    dG = torch.empty_like(G)
    dm = torch.empty_like(G) if need_m else None
    dv = torch.empty_like(G) if need_v else None
    partials = torch.empty((4, nblocks), dtype=torch.float64, device=dev)
    dscal = torch.empty((4,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.fu_update_bwd(OPT_CODES[opt], G.data_ptr(), ptr(m),
                                ptr(v), scalars.data_ptr(),
                                d_new_p.data_ptr(), ptr(d_new_m),
                                ptr(d_new_v), dG.data_ptr(), ptr(dm),
                                ptr(dv), partials.data_ptr(),
                                dscal.data_ptr(), n, momentum, b1, 1.0 - b1,
                                b2, 1.0 - b2, eps, nblocks, stream(dev))
    raise_on(err, "update_pass_bwd")
    update_pass_bwd.launches += 1
    return dG, dm, dv, dscal


update_pass_bwd.launches = 0

KERNELS = (aggregate_pass, accumulate_pass, update_pass, accumulate_pass_bwd,
           aggregate_pass_bwd, update_pass_bwd)


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
