"""Tiny shared name->plugin registry behind the ClientAlgorithm /
CohortExecutor / ServerEngine registries (one implementation of the
duplicate-name check and the actionable unknown-name error)."""
from __future__ import annotations

from typing import Any, Dict


class Registry:
    def __init__(self, kind: str, register_hint: str):
        self._kind = kind            # e.g. "client algorithm"
        self._hint = register_hint   # e.g. "repro.core.algorithms.register_algorithm"
        self._items: Dict[str, Any] = {}

    def register(self, name: str, value: Any) -> Any:
        if name in self._items:
            raise ValueError(f"{self._kind} {name!r} already registered")
        self._items[name] = value
        return value

    def get(self, name: str) -> Any:
        try:
            return self._items[name]
        except KeyError:
            raise ValueError(
                f"unknown {self._kind} {name!r}; registered: "
                f"{self.names()} (register new ones with "
                f"{self._hint})") from None

    def names(self) -> tuple:
        return tuple(sorted(self._items))
