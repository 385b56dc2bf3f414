"""Pass 3: registry capability surfaces (FL301-FL302), JAX's rules on the
port's registries (``core/engines.py``, ``core/executors.py``,
``comm/codecs.py``, ``core/algorithms.py``) and its own ``FedConfig``
(``configs/base.py``).

The round builder composes plugins by interrogating DECLARED capabilities
(``exe.produces & eng.accepts``, ``"lossy" in eng.codec_capabilities``,
``getattr(eng, "is_async", False)``...).  A registered class that forgot a
declaration doesn't fail loudly — ``getattr`` defaults paper over it and
the plugin silently loses a feature.  Likewise the config-guard
ValueErrors: a message telling the user to set a field that doesn't exist
on FedConfig points at nothing.

  * **FL301** — every ``@register_executor`` class must declare (possibly
    via bases, resolved across the whole analyzed tree) ``produces``,
    ``supports_reweight`` and ``codec_capabilities``; every
    ``@register_engine`` class: ``accepts``, ``preferred``,
    ``meta_capabilities``, ``codec_capabilities`` and ``is_async``; every
    ``@register_codec`` class: ``lossy``.  Every ``register_algorithm``
    call site must pass ``pseudo_gradient=`` explicitly (the server-lr
    semantics hinge on it).
  * **FL302** — ``raise ValueError(...)`` message text that names a config
    field with ``some_field=...`` must name a REAL field: a FedConfig
    field, a parameter of the enclosing function(s), or an attribute of
    the enclosing class.  Catches guard messages left stale by config
    renames.
"""
from __future__ import annotations

import ast
import re
from typing import List, Set

from repro_torch.analysis.fedlint.core import (Finding, ProjectIndex,
                                               SourceFile, dotted_tail)

_REQUIRED_ATTRS = {
    "register_executor": ("produces", "supports_reweight",
                          "codec_capabilities"),
    "register_engine": ("accepts", "preferred", "meta_capabilities",
                        "codec_capabilities", "is_async"),
    "register_codec": ("lossy",),
}

# underscore-containing identifier immediately followed by '=' (not '==')
_FIELD_TOKEN = re.compile(r"\b([a-z][a-z0-9]*(?:_[a-z0-9]+)+)=(?!=)")


def _check_registered_classes(index: ProjectIndex, sf: SourceFile,
                              findings: List[Finding]) -> None:
    for node in ast.walk(sf.tree):
        if not isinstance(node, ast.ClassDef):
            continue
        for dec in node.decorator_list:
            target = dec.func if isinstance(dec, ast.Call) else dec
            reg = dotted_tail(target)
            required = _REQUIRED_ATTRS.get(reg or "")
            if not required:
                continue
            missing = [a for a in required
                       if not index.class_declares(node.name, a)]
            if missing:
                findings.append(Finding(
                    sf.path, node.lineno, "FL301",
                    f"{reg} class {node.name!r} does not declare its full "
                    f"capability surface: missing {', '.join(missing)} "
                    "(declare on the class or inherit from a base that "
                    "does — getattr defaults silently disable features)"))


def _check_algorithm_calls(sf: SourceFile,
                           findings: List[Finding]) -> None:
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Call) \
                and dotted_tail(node.func) == "register_algorithm" \
                and node.args:                     # skip the def itself
            kwargs = {kw.arg for kw in node.keywords}
            if "pseudo_gradient" not in kwargs:
                findings.append(Finding(
                    sf.path, node.lineno, "FL301",
                    "register_algorithm call without an explicit "
                    "pseudo_gradient= declaration; resolve_server_lr's "
                    "lr=1.0 forcing hinges on it — declare it even when "
                    "the default would do"))


def _literal_text(call: ast.Call) -> str:
    """Concatenated literal fragments of the exception message (Constant
    strings + the Constant parts of f-strings); formatted values are
    replaced by a space so tokens never merge across them."""
    parts: List[str] = []
    for arg in call.args:
        for node in ast.walk(arg):
            if isinstance(node, ast.Constant) and isinstance(node.value,
                                                                  str):
                parts.append(node.value)
            elif isinstance(node, ast.FormattedValue):
                parts.append(" ")
    return " ".join(parts)


def _enclosing_valid_names(stack: List[ast.AST],
                           index: ProjectIndex) -> Set[str]:
    valid: Set[str] = set(index.fedconfig_fields)
    for node in stack:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            a = node.args
            valid.update(p.arg for p in a.posonlyargs + a.args + a.kwonlyargs)
            if a.vararg:
                valid.add(a.vararg.arg)
            if a.kwarg:
                valid.add(a.kwarg.arg)
        elif isinstance(node, ast.ClassDef):
            info = index.classes.get(node.name)
            if info is not None:
                valid.update(info.attrs)
    return valid


def _check_value_errors(index: ProjectIndex, sf: SourceFile,
                        findings: List[Finding]) -> None:
    def visit(node: ast.AST, stack: List[ast.AST]) -> None:
        if isinstance(node, ast.Raise) and isinstance(node.exc, ast.Call) \
                and dotted_tail(node.exc.func) == "ValueError":
            text = _literal_text(node.exc)
            tokens = set(_FIELD_TOKEN.findall(text))
            valid = _enclosing_valid_names(stack, index) if tokens else set()
            for tok in sorted(tokens):
                if tok not in valid:
                    findings.append(Finding(
                        sf.path, node.lineno, "FL302",
                        f"ValueError message names {tok!r} as a settable "
                        "field, but it is not a FedConfig field, a "
                        "parameter of the enclosing function, or an "
                        "attribute of the enclosing class — the guidance "
                        "points at nothing the user can set"))
        is_scope = isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.ClassDef))
        if is_scope:
            stack = stack + [node]
        for child in ast.iter_child_nodes(node):
            visit(child, stack)

    visit(sf.tree, [])


def check(index: ProjectIndex) -> List[Finding]:
    findings: List[Finding] = []
    for sf in index.files:
        _check_registered_classes(index, sf, findings)
        _check_algorithm_calls(sf, findings)
        _check_value_errors(index, sf, findings)
    return findings
