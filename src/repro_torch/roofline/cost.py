"""The cost of a call without running it: a trace on fake tensors
(the port's counterpart of ``repro/roofline/hlo_cost.py``).

The JAX package reads a round's cost off XLA's compiled program.  Eager
PyTorch compiles nothing, so :func:`trace_cost` runs the call once inside
``torch._subclasses.fake_tensor.FakeTensorMode`` and counts what it
dispatches:

  * **Inputs.** Tensors become stand-ins from
    ``FakeTensorMode.from_tensor`` on their own device (nothing is
    allocated, no data is copied); :class:`TensorSpec` leaves become
    fresh stand-ins of their shape, dtype and strides; numpy arrays and other
    host values stay as they are.
  * **FLOPs.** Only products count — matmul, convolution and SDPA, through
    ``torch.utils.flop_counter``'s formulas, as JAX's walker counts only
    ``dot`` and ``convolution``.  A product of fp32 operands is an fp32
    operation (the port runs no fp32 product on the tensor cores,
    ``device.strict_fp32``); one of bf16 operands (a model built at bf16)
    runs on the tensor cores at bf16 and counts under ``bf16_flops``.
  * **Bytes.** For every aten op that is neither a view nor metadata,
    bytes read are its tensor inputs' bytes and bytes written its
    outputs'.  Eager code does not fuse, so this is each launch's own
    traffic; where the L2 holds an operand from the op before it, it is an
    upper bound.  Views, ``prim`` ops, allocations (``empty*``) and ops
    that return no tensor are free.
  * **Collectives.** ``c10d`` ops (:data:`~repro_torch.roofline.analysis.
    COLLECTIVE_OPS`) count at dispatch, at their result bytes, the JAX
    package's convention.
  * **The hand-written kernels.** Each wrapper of ``kernels/*/kernel.py``
    declares its cost as a function of its shapes (fp32 operations, 3xTF32
    and bf16 tensor-core operations, bytes read and written; the counts
    ``chip_smoke.py``'s bounds print).  Given fake tensors while a counter
    that charges kernels is active, it runs its shape, dtype and form
    checks, charges that cost, adds one to the counter's launch count for
    the kernel and returns fake outputs; it never computes its plain
    version and its real ``launches`` count does not move.  A fake tensor
    that reaches a wrapper with no counter active raises.
  * **Memory**, in JAX's ``memory_analysis`` keys: the arguments' bytes
    (each storage once), the outputs', the outputs that share a storage
    with an argument (``alias``), and ``temp``: the peak of the live
    storages made during the call, tracked with ``weakref.finalize`` on
    their untyped storages.

A trace advances no real ``torch.Generator`` and no numpy random state,
and leaves no allocation on the card.  A host read inside the call
(``.item()``, ``float(t)``, ``bool(t)``, ``.cpu()``) raises: the stand-ins
hold no values.

A ``cuda`` trace charges the wrappers' declared costs (the card's
program); a ``cpu`` trace runs their plain versions (what a CPU run
executes).  On a torch built without CUDA the stand-ins of a ``cuda``
trace are CPU fakes (autograd's device guards need the CUDA runtime) and
the kernels still charge their declared costs: the count is the card's
program.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time
import traceback
import weakref
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import (DataDependentOutputException,
                                          FakeTensorMode,
                                          disable_fake_tensor_cache, is_fake)
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import _cuda
from repro_torch.roofline.analysis import COLLECTIVE_OPS

__all__ = ["Cost", "CostCounter", "HostReadError", "TensorSpec",
           "trace_cost", "trace_device"]

_ALLOC = {"empty", "empty_like", "empty_strided", "new_empty",
          "new_empty_strided", "_efficientzerotensor"}
_COLLECTIVES = frozenset(COLLECTIVE_OPS)


class HostReadError(RuntimeError):
    """The traced call read a device value on the host."""


def _host_read(exc: BaseException) -> HostReadError:
    """Name the port's line that read, from the exception's traceback."""
    here = os.path.dirname(os.path.abspath(__file__))
    pkg = os.path.dirname(here)
    frames = [f for f in traceback.extract_tb(exc.__traceback__)
              if f.filename.startswith(pkg) and not f.filename.startswith(
                  here)]
    where = (f"{os.path.relpath(frames[-1].filename, os.path.dirname(pkg))}"
             f":{frames[-1].lineno} ({frames[-1].line})" if frames
             else "an unknown line")
    return HostReadError(
        f"the traced call reads a device value on the host at {where}: a "
        f"trace on fake tensors has no values to read ({exc})")


class TensorSpec(NamedTuple):
    """A tensor's shape, dtype, strides and device, without its data: the
    port's ``jax.ShapeDtypeStruct``."""
    shape: Tuple[int, ...]
    dtype: torch.dtype
    device: torch.device
    stride: Tuple[int, ...]


@dataclasses.dataclass
class Cost:
    """One traced call: ``flops`` every operation (counted products and
    the kernels' declared operations), ``tc_flops`` the part of them on
    the tensor cores as TF32, ``bf16_flops`` the part on them at bf16;
    bytes, collectives, kernel launches and memory."""
    flops: float = 0.0
    bytes_written: float = 0.0
    collective_bytes: float = 0.0
    per_collective: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    collective_counts: Dict[str, int] = dataclasses.field(
        default_factory=dict)
    tc_flops: float = 0.0
    bytes_read: float = 0.0
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    n_ops: int = 0
    memory: Dict[str, int] = dataclasses.field(default_factory=dict)
    trace_s: float = 0.0
    bf16_flops: float = 0.0

    @property
    def bytes(self) -> float:
        return self.bytes_read + self.bytes_written


def _nbytes(t: torch.Tensor) -> int:
    """A tensor's bytes, at most its storage's (an expanded input is read
    once)."""
    n = t.numel() * t.element_size()
    try:
        return min(n, t.untyped_storage().nbytes())
    except (RuntimeError, NotImplementedError):
        return n


def _tensors(tree):
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _op_tensors(*groups):
    """The tensors of an op's arguments or results: at the top level or in
    a list or tuple (``cat``'s inputs, ``unbind``'s outputs)."""
    out = []
    for g in groups:
        for x in g:
            if isinstance(x, torch.Tensor):
                out.append(x)
            elif isinstance(x, (list, tuple)):
                out.extend(t for t in x if isinstance(t, torch.Tensor))
    return out


_HALF = (torch.bfloat16, torch.float16)   # products on the tensor cores
_DECOMPOSE: Dict[Any, bool] = {}


def _decomposes(func) -> bool:
    """A composite op (matmul, einsum under inference mode) that no flop
    formula covers: counted as the ops it decomposes into, as
    ``FlopCounterMode`` counts it."""
    d = _DECOMPOSE.get(func)
    if d is None:
        d = _DECOMPOSE[func] = (
            func._overloadpacket not in flop_registry
            and func.namespace == "aten"
            and torch._C._dispatch_has_kernel_for_dispatch_key(
                func.name(), "CompositeImplicitAutograd"))
    return d


class CostCounter(TorchDispatchMode):
    """Counts what :func:`trace_cost` describes; pushed above the fake
    mode, so it sees the aten ops below functorch's transforms (a vmapped
    product at its batched shape)."""

    def __init__(self, *, charge_kernels: bool):
        super().__init__()
        self.charge_kernels = bool(charge_kernels)
        self.cost = Cost()
        self._known: Dict[int, int] = {}      # storage id -> bytes
        self._live = 0
        self.peak = 0

    # ---- memory ------------------------------------------------------
    def note_arguments(self, tensors) -> None:
        for t in tensors:
            self._known.setdefault(id(t.untyped_storage()), -1)

    def _free(self, key: int, nbytes: int) -> None:
        self._known.pop(key, None)
        self._live -= nbytes

    def _track(self, outs) -> None:
        for t in outs:
            st = t.untyped_storage()
            key = id(st)
            if key in self._known:
                continue
            nbytes = st.nbytes()
            self._known[key] = nbytes
            self._live += nbytes
            self.peak = max(self.peak, self._live)
            weakref.finalize(st, self._free, key, nbytes)

    # ---- the kernels' declared costs ---------------------------------
    def charge(self, name: str, kc: "_cuda.KernelCost") -> None:
        c = self.cost
        c.flops += kc.flops + kc.tc_flops + kc.bf16_flops
        c.tc_flops += kc.tc_flops
        c.bf16_flops += kc.bf16_flops
        c.bytes_read += kc.bytes_read
        c.bytes_written += kc.bytes_written
        c.launches[name] = c.launches.get(name, 0) + 1

    # ---- every aten op -----------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _decomposes(func):
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        name = func._overloadpacket.__name__
        if func.namespace == "c10d":
            if name in _COLLECTIVES:
                b = float(sum(_nbytes(t) for t in _tensors(out)))
                c = self.cost
                c.collective_bytes += b
                c.per_collective[name] = c.per_collective.get(name, 0.0) + b
                c.collective_counts[name] = \
                    c.collective_counts.get(name, 0) + 1
            return out
        if func.namespace == "prim" or func.is_view:
            return out
        outs = _op_tensors(out if isinstance(out, (tuple, list))
                           else (out,))
        if not outs:
            return out
        self._track(outs)
        if name in _ALLOC:
            return out
        c = self.cost
        c.n_ops += 1
        c.bytes_read += sum(_nbytes(t) for t in _op_tensors(
            args, kwargs.values()))
        c.bytes_written += sum(_nbytes(t) for t in outs)
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            f = float(count(*args, **kwargs, out_val=out))
            c.flops += f
            if any(t.dtype in _HALF for t in _op_tensors(args)):
                c.bf16_flops += f
        return out

    def __enter__(self):
        _cuda.COST_COUNTERS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _cuda.COST_COUNTERS.remove(self)
        return super().__exit__(*exc)


def trace_device(device) -> torch.device:
    """The device a trace's stand-ins live on: ``device``, or the CPU for
    a ``cuda`` trace on a torch built without CUDA."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.backends.cuda.is_built():
        return torch.device("cpu")
    return device


def trace_cost(fn, args, *, device, mode: Optional[FakeTensorMode] = None,
               fake_cache: bool = True) -> Tuple[Cost, Any]:
    """Run ``fn(*args)`` once on fake stand-ins and count its cost.
    Returns (:class:`Cost`, the fake result).  ``device`` is the device
    whose program is costed; ``mode`` an open fake mode whose stand-ins
    ``args`` already hold (the dry run builds its model in one).
    ``fake_cache=False`` traces without the fake modes' dispatch cache,
    which the model axis's client update needs: there an entry made for
    a view under forward-mode AD fails a later view's check (an internal
    assert of torch's), in the same trace or a later one, the cache
    being class-wide.  Without it a trace takes about twice as long."""
    device = torch.device(device)
    mode = mode or FakeTensorMode(allow_non_fake_inputs=False)
    t0 = time.perf_counter()
    with mode, (contextlib.nullcontext() if fake_cache
                else disable_fake_tensor_cache(mode)):
        def stand_in(x):
            if isinstance(x, TensorSpec):
                return torch.empty_strided(
                    x.shape, x.stride, dtype=x.dtype,
                    device=trace_device(x.device))
            if isinstance(x, torch.Tensor) and not is_fake(x):
                return mode.from_tensor(x)
            return x
        fargs = tree_map(stand_in, tuple(args),
                         is_leaf=lambda x: isinstance(x, TensorSpec))
        counter = CostCounter(charge_kernels=device.type == "cuda")
        arg_ts = _tensors(fargs)
        counter.note_arguments(arg_ts)
        with counter:
            try:
                out = fn(*fargs)
            except DataDependentOutputException as e:
                raise _host_read(e) from e
            except RuntimeError as e:
                if "not supported for tensor subclasses" not in str(e):
                    raise
                raise _host_read(e) from e
        cost = counter.cost
        arg_st = {id(t.untyped_storage()): t.untyped_storage().nbytes()
                  for t in arg_ts}
        out_st = {id(t.untyped_storage()): t.untyped_storage().nbytes()
                  for t in _tensors(out)}
        cost.memory = {
            "argument_size_in_bytes": int(sum(arg_st.values())),
            "output_size_in_bytes": int(sum(out_st.values())),
            "alias_size_in_bytes": int(sum(b for k, b in out_st.items()
                                           if k in arg_st)),
            "temp_size_in_bytes": int(counter.peak)}
    cost.trace_s = time.perf_counter() - t0
    return cost, out
