"""Pass 2: kernel contracts (FL201-FL204), the port's form of
``repro/analysis/fedlint/kernel_rules.py``.

Every hand-written kernel of the port ships as ``kernel.py`` (the
wrapper: checks, then the launch) beside ``ref.py`` (the plain PyTorch
oracle), often with an ``ops.py`` (a ``torch.autograd.Function`` over the
pair).  The JAX package dispatches through a ``use_ref`` flag in
``ops.py``; the port keeps a different contract, and these rules check
the port's:

  * **FL201**, JAX's rule: every public ``*_pass`` / ``*_pass_bwd`` in
    ``kernels/<name>/kernel.py`` has its oracle in the sibling ``ref.py``
    (``foo_pass`` -> ``foo_ref``, ``foo_pass_bwd`` -> ``foo_bwd_ref``).
  * **FL202**: wrapper and oracle have the SAME signature, identical
    positional parameters and identical keyword-only parameters after
    dropping the wrapper's own knob ``out`` (the buffer a CUDA launch
    writes into; the oracle returns a new tensor).  Drift means the CPU
    arm hands the oracle something else than the launch gets.
  * **FL203**, torch form: each public pass dispatches on the device of
    its tensors, so its body has (i) an ``if <device>.type == "cpu":``
    arm that returns its oracle (the plain version, what the CPU tests
    run), (ii) an ``if traced(...):`` arm that calls ``charge(<the
    pass>, ...)`` (the cost counter's fake tensors charge the declared
    cost instead of launching) and (iii) no ``try`` with an ``except``:
    a CUDA tensor gets the kernel or an error, never a fallback.
  * **FL204**, torch form: a ``torch.autograd.Function`` subclass defines
    ``forward`` and ``backward``, each a ``@staticmethod``; a missing
    backward surfaces only when a round differentiates through it.  The
    transforms' extra requirements (``setup_context`` and a vmap rule
    under ``torch.func``) are not part of the rule: the port's Functions
    run under ``torch.autograd``, never inside a ``torch.func``
    transform, and which Function a transform reaches is not visible to
    a per-file pass.
"""
from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Tuple

from repro_torch.analysis.fedlint.core import (Finding, ProjectIndex,
                                               SourceFile, dotted_tail)

_KERNEL_KNOBS = frozenset({"out"})


def _oracle_name(pass_name: str) -> str:
    if pass_name.endswith("_pass_bwd"):
        return pass_name[:-len("_pass_bwd")] + "_bwd_ref"
    assert pass_name.endswith("_pass"), pass_name
    return pass_name[:-len("_pass")] + "_ref"


def _public_passes(sf: SourceFile) -> List[ast.FunctionDef]:
    return [n for n in sf.tree.body
            if isinstance(n, ast.FunctionDef)
            and not n.name.startswith("_")
            and (n.name.endswith("_pass") or n.name.endswith("_pass_bwd"))]


def _top_level_funcs(sf: SourceFile) -> Dict[str, ast.FunctionDef]:
    return {n.name: n for n in sf.tree.body
            if isinstance(n, ast.FunctionDef)}


def _signature(fn: ast.FunctionDef, *, drop_knobs: bool
               ) -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
    pos = tuple(a.arg for a in fn.args.posonlyargs + fn.args.args)
    kw = tuple(sorted(a.arg for a in fn.args.kwonlyargs
                      if not (drop_knobs and a.arg in _KERNEL_KNOBS)))
    return pos, kw


def _kernel_pairs(index: ProjectIndex
                  ) -> List[Tuple[SourceFile, Optional[SourceFile]]]:
    by_dir: Dict[str, Dict[str, SourceFile]] = {}
    for sf in index.files:
        d, base = os.path.split(sf.path)
        if base in ("kernel.py", "ref.py") \
                and "/kernels/" in sf.posix + "/":
            by_dir.setdefault(d, {})[base] = sf
    return [(m["kernel.py"], m.get("ref.py"))
            for m in by_dir.values() if "kernel.py" in m]


def _calls(node: ast.AST, name: str) -> List[ast.Call]:
    return [n for n in ast.walk(node) if isinstance(n, ast.Call)
            and dotted_tail(n.func) == name]


def _is_cpu_test(test: ast.AST) -> bool:
    """``<x>.type == "cpu"`` somewhere in an if-test."""
    for node in ast.walk(test):
        if isinstance(node, ast.Compare) and len(node.ops) == 1 \
                and isinstance(node.ops[0], ast.Eq):
            sides = (node.left, node.comparators[0])
            if any(isinstance(s, ast.Attribute) and s.attr == "type"
                   for s in sides) and any(
                    isinstance(s, ast.Constant) and s.value == "cpu"
                    for s in sides):
                return True
    return False


def _arm(stmts: List[ast.stmt]) -> ast.Module:
    return ast.Module(body=stmts, type_ignores=[])


def _dispatch_findings(fn: ast.FunctionDef, oracle: str,
                       kernel: SourceFile) -> List[Finding]:
    """FL203 on one public pass."""
    out: List[Finding] = []
    ifs = [n for n in ast.walk(fn) if isinstance(n, ast.If)]
    cpu_ok = any(_is_cpu_test(n.test) and _calls(_arm(n.body), oracle)
                 and any(isinstance(s, ast.Return)
                         for s in ast.walk(_arm(n.body)))
                 for n in ifs)
    if not cpu_ok:
        out.append(Finding(
            kernel.path, fn.lineno, "FL203",
            f"kernel pass {fn.name!r} has no device-type arm returning its "
            f"oracle {oracle!r} ('if dev.type == \"cpu\": return "
            f"R.{oracle}(...)'): a CPU tensor must get the plain version, "
            "the one path the CPU tests can reach"))
    traced_ok = any(
        _calls(n.test, "traced") and any(
            c.args and dotted_tail(c.args[0]) == fn.name
            for c in _calls(_arm(n.body), "charge"))
        for n in ifs)
    if not traced_ok:
        out.append(Finding(
            kernel.path, fn.lineno, "FL203",
            f"kernel pass {fn.name!r} has no 'if traced(...):' arm calling "
            f"charge({fn.name}, ...): under the cost counter its fake "
            "tensors must charge the declared cost, not launch"))
    for node in ast.walk(fn):
        if isinstance(node, ast.Try) and node.handlers:
            out.append(Finding(
                kernel.path, node.lineno, "FL203",
                f"try/except in kernel pass {fn.name!r}: a fallback around "
                "the launch; a CUDA tensor gets the kernel or an error"))
    return out


def _is_autograd_function(base: ast.AST, sf: SourceFile) -> bool:
    """``torch.autograd.Function`` / ``autograd.Function``, or a bare
    ``Function`` imported from ``torch.autograd``."""
    if isinstance(base, ast.Attribute):
        return base.attr == "Function" and dotted_tail(base.value) == \
            "autograd"
    if isinstance(base, ast.Name) and base.id == "Function":
        return any(isinstance(n, ast.ImportFrom) and n.module ==
                   "torch.autograd" and any(a.name == "Function"
                                            for a in n.names)
                   for n in ast.walk(sf.tree))
    return False


def _check_autograd_functions(sf: SourceFile,
                              findings: List[Finding]) -> None:
    """FL204 within one file."""
    for node in ast.walk(sf.tree):
        if not isinstance(node, ast.ClassDef) or not any(
                _is_autograd_function(b, sf) for b in node.bases):
            continue
        methods = {m.name: m for m in node.body
                   if isinstance(m, (ast.FunctionDef,
                                     ast.AsyncFunctionDef))}
        for name in ("forward", "backward"):
            m = methods.get(name)
            if m is None:
                findings.append(Finding(
                    sf.path, node.lineno, "FL204",
                    f"torch.autograd.Function {node.name!r} defines no "
                    f"{name}; differentiating through it fails deep "
                    "inside a round"))
            elif not any(dotted_tail(d) == "staticmethod"
                         for d in m.decorator_list):
                findings.append(Finding(
                    sf.path, m.lineno, "FL204",
                    f"{node.name}.{name} is not a @staticmethod: autograd "
                    "calls it on the class, with ctx first"))


def check(index: ProjectIndex) -> List[Finding]:
    findings: List[Finding] = []
    for kernel, ref in _kernel_pairs(index):
        passes = _public_passes(kernel)
        if not passes:
            continue
        ref_funcs = _top_level_funcs(ref) if ref else {}
        for fn in passes:
            oracle = _oracle_name(fn.name)
            rfn = ref_funcs.get(oracle)
            if rfn is None:
                where = ref.path if ref else os.path.join(
                    os.path.dirname(kernel.path), "ref.py")
                findings.append(Finding(
                    kernel.path, fn.lineno, "FL201",
                    f"kernel pass {fn.name!r} has no oracle {oracle!r} in "
                    f"{where}; every *_pass needs a same-signature plain "
                    "PyTorch reference"))
            else:
                kpos, kkw = _signature(fn, drop_knobs=True)
                rpos, rkw = _signature(rfn, drop_knobs=False)
                if (kpos, kkw) != (rpos, rkw):
                    findings.append(Finding(
                        kernel.path, fn.lineno, "FL202",
                        f"signature drift between {fn.name} and {oracle}: "
                        f"kernel ({', '.join(kpos)} * {', '.join(kkw)}) vs "
                        f"oracle ({', '.join(rpos)} * {', '.join(rkw)}) "
                        "(positional must match exactly; kw-only compared "
                        "after dropping the wrapper's out=)"))
            findings.extend(_dispatch_findings(fn, oracle, kernel))
    for sf in index.files:
        _check_autograd_functions(sf, findings)
    return findings
