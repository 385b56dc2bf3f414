"""Config registry of the port: ``get_arch(name)`` / ``get_smoke(name)``.

Only the architectures the port can build are registered: smollm-360m
(dense; trains and serves) and mamba2-780m (SSM; serves only, its
training is ROADMAP Queue 1 item 10).  The JAX package's other
architectures wait for ROADMAP Queue 1 item 6."""
from __future__ import annotations

from repro_torch.configs import mamba2_780m, smollm_360m
from repro_torch.configs.base import ArchConfig, FedConfig

_MODULES = {
    "smollm-360m": smollm_360m,
    "mamba2-780m": mamba2_780m,
}

ARCHS = tuple(_MODULES.keys())


def get_arch(name: str) -> ArchConfig:
    if name.endswith("-smoke"):
        return get_smoke(name[: -len("-smoke")])
    if name not in _MODULES:
        raise ValueError(f"unknown arch {name!r}; the port registers "
                         f"{ARCHS} (and their -smoke variants)")
    return _MODULES[name].CONFIG


def get_smoke(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise ValueError(f"unknown arch {name!r}; the port registers "
                         f"{ARCHS}")
    return _MODULES[name].SMOKE


__all__ = ["ArchConfig", "FedConfig", "ARCHS", "get_arch", "get_smoke"]
