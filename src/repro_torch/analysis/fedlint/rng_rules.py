"""Pass 1: RNG discipline (FL101-FL103), PyTorch port of
``repro/analysis/fedlint/rng_rules.py``.

The port draws its randomness on the host: numpy generators keyed by seed
tuples, ``np.random.default_rng((seed, TAG, round))``, whose constant
components come from ONE registry (:mod:`repro_torch.core.rngtags`, the
JAX package's tags plus the port's own), so that its streams are the JAX
package's where they must be and separate from one another everywhere.
Two streams keyed by the same constants ARE the same stream.  The rules:

  * **FL101**: a constant tag written inline, JAX's rule: a literal int
    component of a ``default_rng((seed, 7777, ...))`` seed tuple, or one
    named by a module-level int of the same file instead of an import
    from ``repro_torch.core.rngtags``; likewise ``fold_in(k, 0x1234)``,
    which the port does not call but a snippet beside it may.  Dynamic
    components (seeds, round indices, parameters) are the sanctioned
    pattern and never flagged.  ``core/rngtags.py`` itself is exempt: it
    is the registry.
  * **FL102**: two constant tags share a value (registry names and/or
    inline constants), JAX's rule.
  * **FL103**, torch form.  JAX's rule flags a ``jax.random`` key
    consumed twice.  numpy and torch generators are stateful: drawing
    twice from one generator advances it, which is correct.  The reuse
    that breaks a stream is building one generator twice from the same
    key: the same seed expression handed twice to ``default_rng(...)``
    (or ``Generator(...)``, ``SeedSequence(...)``), or to
    ``.manual_seed(...)`` of the same generator expression, in one
    straight-line statement list with no name it reads rebound in
    between, so the second generator replays the first one's numbers (a
    numpy and a torch generator, or torch generators built apart, are
    different streams).  Branches of an ``if`` are separate lists (as in
    JAX's rule), and a call without a seed (fresh entropy) is never
    flagged.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.fedlint.core import (Finding, ProjectIndex,
                                               SourceFile, dotted_root,
                                               dotted_tail)

# calls that build a generator from their first argument, and the method
# that reseeds one
_SEEDED = frozenset({"default_rng", "Generator", "SeedSequence",
                     "RandomState"})
_RESEED = "manual_seed"

def _module_int_consts(sf: SourceFile) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for node in sf.tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and isinstance(node.value, ast.Constant)
                and isinstance(node.value.value, int)
                and not isinstance(node.value.value, bool)):
            out[node.targets[0].id] = node.value.value
    return out


def _rngtags_imports(sf: SourceFile) -> Tuple[Set[str], Set[str]]:
    """(names imported FROM the registry, aliases OF the registry module)."""
    names: Set[str] = set()
    modules: Set[str] = set()
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.ImportFrom) and node.module:
            if node.module.endswith("rngtags"):
                names.update(a.asname or a.name for a in node.names)
            elif node.module.split(".")[-1] == "core":
                for a in node.names:
                    if a.name == "rngtags":
                        modules.add(a.asname or "rngtags")
        elif isinstance(node, ast.Import):
            for a in node.names:
                if a.name.endswith("rngtags"):
                    modules.add(a.asname or a.name.split(".")[-1])
    return names, modules


def _tag_ok(tag: ast.AST, reg_names: Set[str], reg_mods: Set[str],
            local_consts: Dict[str, int]) -> Optional[str]:
    """None if the tag expression is acceptable; else a reason string."""
    if isinstance(tag, ast.Constant) and isinstance(tag.value, int) \
            and not isinstance(tag.value, bool):
        return (f"inline constant rng tag {tag.value:#x}; declare it in "
                "repro_torch.core.rngtags and import it")
    if isinstance(tag, ast.Name):
        if tag.id in reg_names:
            return None
        if tag.id in local_consts:
            return (f"constant rng tag {tag.id} is defined locally; move "
                    "it to repro_torch.core.rngtags (the tag registry) "
                    "and import it")
        return None                       # dynamic (param, loop index, ...)
    if isinstance(tag, ast.Attribute):
        root = dotted_root(tag)
        if root in reg_mods:
            return None
        return None                       # attribute of something else: dynamic
    # BinOp etc: acceptable iff no raw int literal participates at top level
    if isinstance(tag, ast.BinOp):
        for side in (tag.left, tag.right):
            reason = _tag_ok(side, reg_names, reg_mods, local_consts)
            if reason is not None:
                return reason
    return None


def _check_file_tags(sf: SourceFile,
                     inline_tags: List[Tuple[int, str, SourceFile, int]]
                     ) -> List[Finding]:
    findings: List[Finding] = []
    if sf.posix.endswith("core/rngtags.py"):
        return findings                   # the registry itself
    reg_names, reg_mods = _rngtags_imports(sf)
    local_consts = _module_int_consts(sf)

    for node in ast.walk(sf.tree):
        if not isinstance(node, ast.Call):
            continue
        tail = dotted_tail(node.func)
        if tail == "fold_in" and len(node.args) >= 2:
            tag = node.args[1]
            reason = _tag_ok(tag, reg_names, reg_mods, local_consts)
            if reason is not None:
                findings.append(Finding(sf.path, tag.lineno, "FL101",
                                        reason + " (fold_in tag)"))
            if isinstance(tag, ast.Constant) and isinstance(tag.value, int):
                inline_tags.append((tag.value, f"inline fold_in tag", sf,
                                    tag.lineno))
            elif isinstance(tag, ast.Name) and tag.id in local_consts:
                inline_tags.append((local_consts[tag.id],
                                    f"local constant {tag.id}", sf,
                                    tag.lineno))
        elif tail == "default_rng" and node.args:
            seed = node.args[0]
            if isinstance(seed, ast.Tuple):
                for el in seed.elts:
                    if isinstance(el, ast.Constant) \
                            and isinstance(el.value, int) \
                            and not isinstance(el.value, bool):
                        findings.append(Finding(
                            sf.path, el.lineno, "FL101",
                            f"inline constant seed-tuple component "
                            f"{el.value}; host rng streams separate via "
                            "constants from repro_torch.core.rngtags too"))
                        inline_tags.append((el.value,
                                            "inline seed-tuple component",
                                            sf, el.lineno))
                    elif isinstance(el, ast.Name) and el.id in local_consts \
                            and el.id not in reg_names:
                        findings.append(Finding(
                            sf.path, el.lineno, "FL101",
                            f"constant seed-tuple component {el.id} is "
                            "defined locally; move it to "
                            "repro_torch.core.rngtags and import it"))
                        inline_tags.append((local_consts[el.id],
                                            f"local constant {el.id}", sf,
                                            el.lineno))
    return findings


def _check_duplicates(index: ProjectIndex,
                      inline_tags: List[Tuple[int, str, SourceFile, int]]
                      ) -> List[Finding]:
    findings: List[Finding] = []
    seen: Dict[int, str] = {}
    for name, (value, sf, line) in sorted(index.rng_tags.items(),
                                          key=lambda kv: kv[1][2]):
        if value in seen:
            findings.append(Finding(
                sf.path, line, "FL102",
                f"rng tag {name} = {value:#x} collides with {seen[value]}; "
                "two streams folding the same constant out of one key are "
                "the SAME stream"))
        else:
            seen[value] = name
    for value, desc, sf, line in inline_tags:
        if value in seen:
            findings.append(Finding(
                sf.path, line, "FL102",
                f"{desc} = {value:#x} collides with registry tag "
                f"{seen[value]}"))
        else:
            seen[value] = f"{desc} ({sf.path}:{line})"
    return findings


def _seed_uses(stmt: ast.stmt) -> List[Tuple[str, Set[str], int]]:
    """(seed expression, the names it reads, line) for each generator
    built from a seed in THIS statement's own expressions: nested
    statement lists (loop and if bodies) are analyzed as independent
    straight-line scopes by the caller, and nested function and lambda
    bodies run later."""
    out: List[Tuple[str, Set[str], int]] = []

    def visit(node: ast.AST) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            return
        if isinstance(node, ast.stmt) and node is not stmt:
            return
        if isinstance(node, ast.Call) and node.args:
            tail = dotted_tail(node.func)
            # a numpy generator's stream is its seed's; a torch one's, its
            # seed's on that generator (a CPU and a CUDA generator seeded
            # alike, or numpy and torch, are different streams)
            kind = None
            if tail in _SEEDED:
                kind = "numpy"
            elif tail == _RESEED and isinstance(node.func, ast.Attribute):
                kind = ast.dump(node.func.value)
            if kind is not None:
                seed = node.args[0]
                names = {n.id for n in ast.walk(node)
                         if isinstance(n, ast.Name)}
                out.append((kind + ast.dump(seed), names, node.lineno))
        for child in ast.iter_child_nodes(node):
            visit(child)

    visit(stmt)
    return out


def _bound_names(stmt: ast.stmt) -> Set[str]:
    names: Set[str] = set()
    if isinstance(stmt, ast.Assign):
        targets = stmt.targets
    elif isinstance(stmt, (ast.AnnAssign, ast.AugAssign)):
        targets = [stmt.target]
    elif isinstance(stmt, (ast.For, ast.AsyncFor)):
        targets = [stmt.target]
    else:
        targets = []
    for t in targets:
        for node in ast.walk(t):
            if isinstance(node, ast.Name):
                names.add(node.id)
    for node in ast.walk(stmt):
        if isinstance(node, ast.NamedExpr) and isinstance(node.target,
                                                          ast.Name):
            names.add(node.target.id)
    return names


def _check_reseed_in_list(sf: SourceFile, body: List[ast.stmt],
                          findings: List[Finding]) -> None:
    seen: Dict[str, Tuple[Set[str], int]] = {}
    for stmt in body:
        for seed, names, line in _seed_uses(stmt):
            if seed in seen:
                findings.append(Finding(
                    sf.path, line, "FL103",
                    f"a generator built from the same seed as the one on "
                    f"line {seen[seed][1]}, nothing it reads rebound in "
                    "between: the two streams are one stream (draw from "
                    "the first generator, or key the second with a tag "
                    "from repro_torch.core.rngtags)"))
            else:
                seen[seed] = (names, line)
        bound = _bound_names(stmt)
        if bound:
            seen = {k: v for k, v in seen.items() if not (v[0] & bound)}
        # nested statement lists are INDEPENDENT straight-line scopes
        # (if / else arms may each build the round's generator)
        for attr in ("body", "orelse", "finalbody"):
            sub = getattr(stmt, attr, None)
            if isinstance(sub, list) and sub \
                    and isinstance(sub[0], ast.stmt):
                _check_reseed_in_list(sf, sub, findings)
        for handler in getattr(stmt, "handlers", []):
            _check_reseed_in_list(sf, handler.body, findings)


def check(index: ProjectIndex) -> List[Finding]:
    findings: List[Finding] = []
    inline_tags: List[Tuple[int, str, SourceFile, int]] = []
    for sf in index.files:
        findings.extend(_check_file_tags(sf, inline_tags))
        _check_reseed_in_list(sf, sf.tree.body, findings)
    findings.extend(_check_duplicates(index, inline_tags))
    return findings
