"""Pass 4: host reads in traced bodies (FL401), the port's form of
``repro/analysis/fedlint/jit_rules.py``.

The port runs eagerly, so nothing is compiled, but three kinds of body
are traced all the same, and a host read of a device value in one of
them is a fault:

  * the functions the round builders return (the functions nested in
    ``make_federated_round``, ``make_async_tick`` and ``_chunk_rounds``):
    ``roofline/cost.py::trace_cost`` runs them on fake tensors, which hold
    no values, for the trainer's ``roofline=True`` event and the dry run;
    and on the card a read is a device sync in every round;
  * the functions passed to ``torch.func`` transforms (``vmap``,
    ``grad``, ``grad_and_value``, ``jvp``, ``vjp``, ``jacrev``,
    ``jacfwd``, ``hessian``), by name or as a lambda, or to a transform
    of a transform: under ``vmap`` a read raises, under the others it
    syncs once per call;
  * anything nested inside either.

  * **FL401**: in such a body, ``.cpu()``, ``.numpy()`` and
    ``.to("cpu")`` calls, and ``.item()``, ``.tolist()`` and ``bool()`` /
    ``float()`` / ``int()`` of a torch expression: a call rooted at
    ``torch`` (``torch.sum(...)``; not ``torch.cuda``, ``torch.device``
    and the like, which return host values), a name last bound to one,
    a parameter annotated ``torch.Tensor``, the first parameter of a
    function a transform receives (what it differentiates or batches),
    or an operation, index or method on one of those.  A tensor's metadata (``.shape``,
    ``.dtype``, ``.device``, ``.numel()``, ``.size()``, ...) is host data
    and never flagged, and neither is host numpy work (draws, ``np.sum``
    of the host weights, ``np.float32`` metrics): the round's host
    bookkeeping is numpy by design.

FL402 and FL403 have no torch form.  JAX flags host numpy (FL402) and
clock reads (FL403) in a jitted body because they run once, at trace
time, and freeze into the compiled program.  An eager body runs every
line on every call: its numpy work is host work done each round (the
draws, the async pool's order, the fp32 learning-rate schedule), and a
clock read measures the call it sits in.  A trace on fake tensors runs
them too, on the host values the call was given.

Under-approximation, as JAX's pass: what the analysis cannot resolve it
does not flag (a tensor reached through a dict or a helper's return, a
function a transform receives from elsewhere, reads inside a helper the
body calls).
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.fedlint.core import (Finding, ProjectIndex,
                                               SourceFile, dotted_root,
                                               dotted_tail)

_ROUND_BUILDERS = frozenset({"make_federated_round", "make_async_tick",
                             "_chunk_rounds"})
_TRANSFORMS = frozenset({"vmap", "grad", "grad_and_value", "jvp", "vjp",
                         "jacrev", "jacfwd", "hessian"})
_READS = frozenset({"cpu", "numpy"})          # tensor-only host reads
_VALUE_READS = frozenset({"item", "tolist"})  # host reads on a tensor
_CASTS = frozenset({"bool", "float", "int"})
_META_ATTRS = frozenset({"shape", "dtype", "device", "ndim", "is_cuda",
                         "requires_grad", "layout", "is_leaf", "names"})
_META_METHODS = frozenset({"size", "dim", "numel", "nelement", "stride",
                           "element_size", "data_ptr", "is_contiguous",
                           "get_device", "storage_offset",
                           "is_floating_point", "is_complex"})
# torch namespaces and functions that return host values
_HOST_TORCH = frozenset({"cuda", "device", "distributed", "backends",
                         "finfo", "iinfo", "is_tensor", "is_grad_enabled",
                         "get_default_dtype", "Size", "dtype", "version",
                         "utils", "profiler", "is_floating_point",
                         "get_rng_state", "initial_seed"})

FuncNode = ast.AST     # FunctionDef | AsyncFunctionDef | Lambda
_FUNCS = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


def _torch_imports(sf: SourceFile) -> Set[str]:
    """Names bound by ``from torch... import X``: transforms and tensor
    factories called bare."""
    names: Set[str] = set()
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.ImportFrom) and node.module and (
                node.module == "torch" or node.module.startswith("torch.")):
            names.update(a.asname or a.name for a in node.names)
    return names


def _is_transform(call: ast.Call, torch_names: Set[str]) -> bool:
    f = call.func
    if isinstance(f, ast.Name):
        return f.id in _TRANSFORMS and f.id in torch_names
    if isinstance(f, ast.Attribute) and f.attr in _TRANSFORMS:
        owner = f.value
        return (isinstance(owner, ast.Attribute) and owner.attr == "func"
                and dotted_root(owner) == "torch") or (
            isinstance(owner, ast.Name) and owner.id in ("torch", "func"))
    return False


def _collect_defs(tree: ast.AST) -> Dict[str, FuncNode]:
    defs: Dict[str, FuncNode] = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs[node.name] = node
        elif isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and isinstance(node.value, ast.Lambda):
            defs[node.targets[0].id] = node.value
    return defs


def _resolve(node: ast.AST, defs: Dict[str, FuncNode],
             torch_names: Set[str]) -> Optional[FuncNode]:
    """A lambda, a name bound to a def of the file, either wrapped in
    ``functools.partial``, or the function of a transform of one."""
    if isinstance(node, ast.Lambda):
        return node
    if isinstance(node, ast.Name):
        return defs.get(node.id)
    if isinstance(node, ast.Call) and node.args and (
            dotted_tail(node.func) == "partial"
            or _is_transform(node, torch_names)):
        return _resolve(node.args[0], defs, torch_names)
    return None


def _traced_roots(sf: SourceFile, torch_names: Set[str]
                  ) -> List[Tuple[FuncNode, bool]]:
    """(function, whether a transform receives it)."""
    defs = _collect_defs(sf.tree)
    roots: List[Tuple[FuncNode, bool]] = []
    for node in ast.walk(sf.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node.name in _ROUND_BUILDERS:
            roots.extend((n, False) for n in ast.walk(node)
                         if isinstance(n, _FUNCS) and n is not node)
        elif isinstance(node, ast.Call) and node.args \
                and _is_transform(node, torch_names):
            fn = _resolve(node.args[0], defs, torch_names)
            if fn is not None:
                roots.append((fn, True))
    return roots


def _pos(node: ast.AST) -> Tuple[int, int]:
    return (getattr(node, "lineno", 0), getattr(node, "col_offset", 0))


class _Scope:
    """One function's bindings in source order: name -> [(position, is a
    torch value)], looked up at a position (the last binding before it),
    then in the enclosing function's scope."""

    def __init__(self, fn: FuncNode, parent: Optional["_Scope"],
                 torch_names: Set[str], transformed: bool = False):
        self.parent = parent
        self.torch_names = torch_names
        self.bindings: Dict[str, List[Tuple[Tuple[int, int], bool]]] = {}
        a = fn.args
        for i, p in enumerate(a.posonlyargs + a.args + a.kwonlyargs):
            ann = p.annotation
            is_t = (ann is not None and dotted_tail(ann) == "Tensor") or (
                transformed and i == 0)
            self._bind(p.arg, _pos(fn), is_t)
        body = fn.body if isinstance(fn.body, list) else [fn.body]
        stmts = sorted((n for b in body for n in _own_nodes(b)
                        if isinstance(n, (ast.Assign, ast.AnnAssign,
                                          ast.AugAssign, ast.For,
                                          ast.NamedExpr))), key=_pos)
        for n in stmts:
            self._bind_stmt(n)

    def _bind(self, name: str, pos, is_t: bool) -> None:
        self.bindings.setdefault(name, []).append((pos, is_t))

    def _bind_target(self, target: ast.AST, value: Optional[ast.AST],
                     pos, is_t: bool) -> None:
        if isinstance(target, ast.Name):
            self._bind(target.id, pos, is_t)
        elif isinstance(target, (ast.Tuple, ast.List)):
            vals = (value.elts if isinstance(value, (ast.Tuple, ast.List))
                    and len(value.elts) == len(target.elts) else None)
            for i, t in enumerate(target.elts):
                self._bind_target(
                    t, None, pos,
                    self.is_torch(vals[i]) if vals is not None else is_t)

    def _bind_stmt(self, n: ast.AST) -> None:
        # a binding takes effect after its statement's own expressions
        pos = (getattr(n, "end_lineno", n.lineno),
               getattr(n, "end_col_offset", 0))
        if isinstance(n, ast.Assign):
            is_t = self.is_torch(n.value)
            for t in n.targets:
                self._bind_target(t, n.value, pos, is_t)
        elif isinstance(n, ast.AnnAssign) and n.value is not None:
            self._bind_target(n.target, n.value, pos,
                              self.is_torch(n.value))
        elif isinstance(n, ast.AugAssign):
            self._bind_target(n.target, None, pos,
                              self.is_torch(n.target)
                              or self.is_torch(n.value))
        elif isinstance(n, ast.For):
            self._bind_target(n.target, None, _pos(n.body[0]),
                              self.is_torch(n.iter))
        elif isinstance(n, ast.NamedExpr):
            self._bind_target(n.target, None, pos, self.is_torch(n.value))

    def lookup(self, name: str, pos) -> Optional[bool]:
        found = [t for p, t in self.bindings.get(name, ()) if p <= pos]
        if found:
            return found[-1]
        if name in self.bindings:       # bound later in this function
            return None
        return self.parent.lookup(name, pos) if self.parent else None

    def is_torch(self, e: Optional[ast.AST]) -> bool:
        if e is None:
            return False
        if isinstance(e, ast.Name):
            return bool(self.lookup(e.id, _pos(e)))
        if isinstance(e, ast.Call):
            f = e.func
            if isinstance(f, ast.Call):          # transform(fn)(args)
                return self.is_torch(f) or _is_transform(
                    f, self.torch_names)
            if isinstance(f, ast.Name):
                return f.id in self.torch_names and f.id not in _HOST_TORCH
            if isinstance(f, ast.Attribute):
                if dotted_root(f) == "torch" and isinstance(
                        f.value, (ast.Name, ast.Attribute)):
                    chain = ast.unparse(f).split(".")
                    if chain[0] == "torch":
                        return not (set(chain[1:]) & _HOST_TORCH)
                if f.attr in _META_METHODS:
                    return False
                return self.is_torch(f.value)
            return False
        if isinstance(e, ast.Attribute):
            return e.attr not in _META_ATTRS and self.is_torch(e.value)
        if isinstance(e, ast.Subscript):
            return self.is_torch(e.value)
        if isinstance(e, ast.BinOp):
            return self.is_torch(e.left) or self.is_torch(e.right)
        if isinstance(e, ast.UnaryOp):
            return self.is_torch(e.operand)
        if isinstance(e, ast.Compare):
            return self.is_torch(e.left) or any(
                self.is_torch(c) for c in e.comparators)
        if isinstance(e, ast.BoolOp):
            return any(self.is_torch(v) for v in e.values)
        if isinstance(e, ast.IfExp):
            return self.is_torch(e.body) or self.is_torch(e.orelse)
        return False


def _own_nodes(node: ast.AST):
    """``node`` and what it holds, not entering nested functions."""
    yield node
    for child in ast.iter_child_nodes(node):
        if not isinstance(child, _FUNCS):
            yield from _own_nodes(child)


def _to_cpu(call: ast.Call) -> bool:
    args = list(call.args) + [k.value for k in call.keywords
                              if k.arg == "device"]
    return any(isinstance(a, ast.Constant) and a.value == "cpu"
               for a in args)


def _flag_scope(sf: SourceFile, fn: FuncNode, scope: _Scope,
                findings: List[Finding], seen: Set[int]) -> None:
    body = fn.body if isinstance(fn.body, list) else [fn.body]
    for node in (n for b in body for n in _own_nodes(b)):
        if id(node) in seen or not isinstance(node, ast.Call):
            continue
        seen.add(id(node))
        f = node.func
        msg = None
        if isinstance(f, ast.Attribute) and f.attr in _READS:
            msg = (f".{f.attr}() inside a traced body reads a device "
                   "tensor on the host")
        elif isinstance(f, ast.Attribute) and f.attr == "to" \
                and _to_cpu(node):
            msg = ".to('cpu') inside a traced body reads a device tensor "\
                  "on the host"
        elif isinstance(f, ast.Attribute) and f.attr in _VALUE_READS \
                and scope.is_torch(f.value):
            msg = (f".{f.attr}() of a torch expression inside a traced "
                   "body reads a device value on the host")
        elif isinstance(f, ast.Name) and f.id in _CASTS and node.args \
                and scope.is_torch(node.args[0]):
            msg = (f"{f.id}() of a torch expression inside a traced body "
                   "reads a device value on the host")
        if msg is not None:
            findings.append(Finding(
                sf.path, node.lineno, "FL401",
                msg + ": a sync on the card every call, and a trace on "
                "fake tensors has no value to read; decide on host values "
                "(the draws, the host weights) or keep the value on the "
                "device"))


def _scopes(fn: FuncNode, parent: Optional[_Scope],
            torch_names: Set[str], transformed: bool = False):
    """``fn``'s scope, then each nested function's, with its parent."""
    scope = _Scope(fn, parent, torch_names, transformed)
    yield fn, scope
    body = fn.body if isinstance(fn.body, list) else [fn.body]
    for node in (n for b in body for n in _own_nodes(b)):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, _FUNCS):
                yield from _scopes(child, scope, torch_names)


def check(index: ProjectIndex) -> List[Finding]:
    findings: List[Finding] = []
    for sf in index.files:
        torch_names = _torch_imports(sf)
        seen: Set[int] = set()
        for root, transformed in _traced_roots(sf, torch_names):
            for fn, scope in _scopes(root, None, torch_names, transformed):
                _flag_scope(sf, fn, scope, findings, seen)
    return findings
