"""Pass 5: sanitizer coverage (FL501), JAX's rule on the port's builders.

The ``--sanitize`` mode only means something if the round an engine runs
contains a probe site: a ``check_flat_groups(...)`` call guarded by
``if sanitize:`` (the guard keeps the unsanitized round free of the
probes' launches).  Each round builder has one (``core/round.py``:
the post-round parameters; ``core/async_round.py``: the deltas entering
the pool); a new engine, or a refactor of a builder, can ship without
one, and ``--sanitize`` then runs with no named flat-group diagnostics.

  * **FL501** — a ``@register_engine`` class whose round builder
    (``make_async_tick`` for ``is_async = True`` engines,
    ``make_federated_round`` otherwise) contains no
    ``check_flat_groups`` call under an ``if``-test referencing
    ``sanitize`` — and neither the class nor its bases carry such a
    probe in their own methods.

Under-approximation (fedlint's standing contract: what the analysis
cannot resolve it does not flag):

  * the engine's ``is_async`` must resolve to a literal ``True``/``False``
    on the class or a base in the analyzed tree (a missing declaration is
    FL301's finding, not this pass's);
  * the expected builder function must be DEFINED somewhere in the
    analyzed tree — fixture snippets and single-file plugins that never
    carry the builder are silent, only a tree that contains the builder
    without its probe is flagged.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.fedlint.core import (Finding, ProjectIndex,
                                               SourceFile, dotted_tail)

_PROBE = "check_flat_groups"
_GUARD = "sanitize"
_BUILDERS = {True: "make_async_tick", False: "make_federated_round"}


def _test_references_guard(test: ast.AST) -> bool:
    """True when the if-test mentions ``sanitize`` — as a bare name or a
    dotted tail (``self.sanitize`` / ``fed.sanitize``)."""
    for node in ast.walk(test):
        if isinstance(node, ast.Name) and node.id == _GUARD:
            return True
        if isinstance(node, ast.Attribute) and node.attr == _GUARD:
            return True
    return False


def _has_guarded_probe(scope: ast.AST) -> bool:
    """A ``check_flat_groups`` call anywhere under an ``if`` whose test
    references ``sanitize``, transitively nested inside ``scope`` (the
    real probes live in closures the builders return)."""
    for node in ast.walk(scope):
        if isinstance(node, ast.If) and _test_references_guard(node.test):
            for sub in node.body:
                for inner in ast.walk(sub):
                    if isinstance(inner, ast.Call) \
                            and dotted_tail(inner.func) == _PROBE:
                        return True
    return False


def _class_literals(sf: SourceFile) -> Dict[str, Dict[str, object]]:
    """Per-class map of class-level ``attr = <bool literal>`` values
    (ClassInfo stores attr NAMES only; this pass needs ``is_async``'s
    value)."""
    out: Dict[str, Dict[str, object]] = {}
    for node in ast.walk(sf.tree):
        if not isinstance(node, ast.ClassDef):
            continue
        vals: Dict[str, object] = {}
        for item in node.body:
            if isinstance(item, ast.Assign) \
                    and isinstance(item.value, ast.Constant):
                for t in item.targets:
                    if isinstance(t, ast.Name):
                        vals[t.id] = item.value.value
            elif isinstance(item, ast.AnnAssign) \
                    and isinstance(item.target, ast.Name) \
                    and isinstance(item.value, ast.Constant):
                vals[item.target.id] = item.value.value
        out[node.name] = vals
    return out


class _Facts:
    """One scan of the tree: builder defs + their probe status, every
    class's literal attrs, every class's guarded-probe status."""

    def __init__(self, index: ProjectIndex):
        self.builder_probed: Dict[str, bool] = {}
        self.literals: Dict[str, Dict[str, object]] = {}
        self.class_probed: Dict[str, bool] = {}
        for sf in index.files:
            self.literals.update(_class_literals(sf))
            for node in ast.walk(sf.tree):
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                        and node.name in _BUILDERS.values():
                    # last definition wins, consistent with the class map
                    self.builder_probed[node.name] = _has_guarded_probe(node)
                elif isinstance(node, ast.ClassDef):
                    self.class_probed[node.name] = _has_guarded_probe(node)
        self._index = index

    def resolve_literal(self, cls: str, attr: str,
                        _seen: Optional[Set[str]] = None) -> Tuple[bool,
                                                                         object]:
        """(found, value) for a class-level literal, walking bases through
        the project class map like ``class_declares``."""
        if _seen is None:
            _seen = set()
        if cls in _seen:
            return False, None
        _seen.add(cls)
        vals = self.literals.get(cls)
        if vals is not None and attr in vals:
            return True, vals[attr]
        info = self._index.classes.get(cls)
        if info is None:
            return False, None
        for b in info.bases:
            found, v = self.resolve_literal(b, attr, _seen)
            if found:
                return True, v
        return False, None

    def class_or_base_probed(self, cls: str,
                             _seen: Optional[Set[str]] = None) -> bool:
        if _seen is None:
            _seen = set()
        if cls in _seen:
            return False
        _seen.add(cls)
        if self.class_probed.get(cls):
            return True
        info = self._index.classes.get(cls)
        if info is None:
            return False
        return any(self.class_or_base_probed(b, _seen) for b in info.bases)


def check(index: ProjectIndex) -> List[Finding]:
    facts = _Facts(index)
    findings: List[Finding] = []
    for sf in index.files:
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            if not any(dotted_tail(d.func if isinstance(d, ast.Call)
                                   else d) == "register_engine"
                       for d in node.decorator_list):
                continue
            found, is_async = facts.resolve_literal(node.name, "is_async")
            if not found or not isinstance(is_async, bool):
                continue               # FL301's problem, not ours
            builder = _BUILDERS[is_async]
            if builder not in facts.builder_probed:
                continue               # builder not in the analyzed tree
            if facts.builder_probed[builder]:
                continue
            if facts.class_or_base_probed(node.name):
                continue
            findings.append(Finding(
                sf.path, node.lineno, "FL501",
                f"engine {node.name!r} has no sanitize probe site: its "
                f"round builder {builder!r} (and the class itself) never "
                f"calls {_PROBE} under an 'if {_GUARD}:' guard, so "
                "--sanitize runs with no named flat-group diagnostics — "
                "restore the guarded probe in the builder (see "
                "repro_torch.core.sanitize)"))
    return findings
