"""fedlint driver: file collection, project index, suppression handling
(PyTorch port of ``repro/analysis/fedlint/core.py``).

Pure stdlib (``ast`` + ``re``) by design: the analyzer imports neither
torch nor the package under analysis, so it parses source text only and
never executes the code it reads.

The passes (``rng_rules`` / ``kernel_rules`` / ``registry_rules`` /
``jit_rules`` / ``sanitize_rules``) each expose ``check(index) ->
list[Finding]``.  Cross-file facts they need (the rng tag registry,
FedConfig's field names, the global class map for capability
inheritance) are resolved once here in :class:`ProjectIndex`.

Suppressions: a finding on line L is dropped when line L (or the line a
multi-line statement starts on) carries ``# fedlint: disable=FLNNN`` (a
comma list of codes, or ``all``).
"""
from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

__all__ = ["Finding", "SourceFile", "ClassInfo", "ProjectIndex",
           "run_fedlint", "format_findings"]

_SUPPRESS_RE = re.compile(
    r"#\s*fedlint:\s*disable=([A-Za-z0-9_,\s]+)")


@dataclasses.dataclass(frozen=True)
class Finding:
    path: str                  # display path (as given on the CLI)
    line: int                  # 1-indexed
    code: str                  # "FLNNN"
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}: {self.code} {self.message}"


@dataclasses.dataclass
class SourceFile:
    path: str                          # display path
    tree: ast.Module
    lines: List[str]                   # raw source lines
    suppressions: Dict[int, Set[str]]  # line -> codes disabled there

    @property
    def posix(self) -> str:
        return self.path.replace(os.sep, "/")

    def suppressed(self, line: int, code: str) -> bool:
        codes = self.suppressions.get(line, ())
        return code in codes or "all" in codes


@dataclasses.dataclass
class ClassInfo:
    name: str
    bases: Tuple[str, ...]             # base-class *names* (dotted tail)
    attrs: Set[str]                    # class-level assignments + defs
    file: "SourceFile" = None
    line: int = 0


def dotted_tail(node: ast.AST) -> Optional[str]:
    """Terminal identifier of a Name / dotted Attribute (``np.random.
    default_rng`` -> ``default_rng``); None for anything else."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def dotted_root(node: ast.AST) -> Optional[str]:
    """Leftmost identifier of a dotted chain (``np.random.default_rng`` ->
    ``np``)."""
    while isinstance(node, ast.Attribute):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _parse_suppressions(lines: Sequence[str]) -> Dict[int, Set[str]]:
    out: Dict[int, Set[str]] = {}
    for i, text in enumerate(lines, start=1):
        m = _SUPPRESS_RE.search(text)
        if m:
            out[i] = {c.strip() for c in m.group(1).split(",") if c.strip()}
    return out


def _collect_py_files(paths: Sequence[str]) -> List[str]:
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, _dirs, names in os.walk(p):
                for n in sorted(names):
                    if n.endswith(".py"):
                        files.append(os.path.join(root, n))
        elif p.endswith(".py"):
            files.append(p)
    return files


class ProjectIndex:
    """Parsed project + the cross-file facts the passes share."""

    def __init__(self, files: List[SourceFile]):
        self.files = files
        self.classes: Dict[str, ClassInfo] = {}
        self.fedconfig_fields: Set[str] = set()
        self.rng_tags: Dict[str, Tuple[int, SourceFile, int]] = {}
        self.rngtags_file: Optional[SourceFile] = None
        for sf in files:
            self._index_file(sf)

    # -- construction -------------------------------------------------------
    def _index_file(self, sf: SourceFile) -> None:
        is_rngtags = sf.posix.endswith("core/rngtags.py")
        if is_rngtags:
            self.rngtags_file = sf
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.ClassDef):
                attrs: Set[str] = set()
                for item in node.body:
                    if isinstance(item, ast.Assign):
                        attrs.update(t.id for t in item.targets
                                     if isinstance(t, ast.Name))
                    elif isinstance(item, ast.AnnAssign) and isinstance(
                            item.target, ast.Name):
                        attrs.add(item.target.id)
                    elif isinstance(item, (ast.FunctionDef,
                                           ast.AsyncFunctionDef)):
                        attrs.add(item.name)
                bases = tuple(b for b in (dotted_tail(x) for x in node.bases)
                              if b)
                # last definition wins; names are unique in this repo
                self.classes[node.name] = ClassInfo(
                    name=node.name, bases=bases, attrs=attrs, file=sf,
                    line=node.lineno)
                if node.name == "FedConfig":
                    self.fedconfig_fields = {
                        item.target.id for item in node.body
                        if isinstance(item, ast.AnnAssign)
                        and isinstance(item.target, ast.Name)}
        if is_rngtags:
            for node in sf.tree.body:
                if (isinstance(node, ast.Assign)
                        and len(node.targets) == 1
                        and isinstance(node.targets[0], ast.Name)
                        and isinstance(node.value, ast.Constant)
                        and isinstance(node.value.value, int)):
                    self.rng_tags[node.targets[0].id] = (
                        node.value.value, sf, node.lineno)

    # -- queries ------------------------------------------------------------
    def class_declares(self, cls: str, attr: str,
                       _seen: Optional[Set[str]] = None) -> bool:
        """True if ``cls`` (or any base reachable through the project-wide
        class map) assigns ``attr`` at class level.  Unknown bases (e.g.
        stdlib or torch classes) contribute nothing."""
        if _seen is None:
            _seen = set()
        if cls in _seen:
            return False
        _seen.add(cls)
        info = self.classes.get(cls)
        if info is None:
            return False
        if attr in info.attrs:
            return True
        return any(self.class_declares(b, attr, _seen) for b in info.bases)


def load_project(paths: Sequence[str]) -> Tuple[ProjectIndex, List[Finding]]:
    """Parse every .py under ``paths``.  Unparseable files become FL001
    findings rather than a crash (the analyzer must always report)."""
    files: List[SourceFile] = []
    errors: List[Finding] = []
    for fpath in _collect_py_files(paths):
        try:
            with open(fpath, "r", encoding="utf-8") as fh:
                src = fh.read()
            tree = ast.parse(src, filename=fpath)
        except (SyntaxError, UnicodeDecodeError, OSError) as e:
            line = getattr(e, "lineno", 1) or 1
            errors.append(Finding(fpath, line, "FL001",
                                  f"cannot analyze file: {e}"))
            continue
        lines = src.splitlines()
        files.append(SourceFile(path=fpath, tree=tree, lines=lines,
                                suppressions=_parse_suppressions(lines)))
    return ProjectIndex(files), errors


def run_fedlint(paths: Sequence[str]) -> List[Finding]:
    """All five passes over ``paths``; returns suppression-filtered
    findings sorted by (path, line, code)."""
    # local imports keep core.py import-cycle-free for the pass modules
    from repro_torch.analysis.fedlint import (jit_rules, kernel_rules,
                                              registry_rules, rng_rules,
                                              sanitize_rules)
    index, findings = load_project(paths)
    for mod in (rng_rules, kernel_rules, registry_rules, jit_rules,
                sanitize_rules):
        findings.extend(mod.check(index))
    by_path = {sf.path: sf for sf in index.files}
    kept = [f for f in findings
            if f.path not in by_path
            or not by_path[f.path].suppressed(f.line, f.code)]
    return sorted(kept, key=lambda f: (f.path, f.line, f.code))


def format_findings(findings: Sequence[Finding]) -> str:
    return "\n".join(f.format() for f in findings)
