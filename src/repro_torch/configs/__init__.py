"""Config registry of the port: ``get_arch(name)`` / ``get_smoke(name)``.

Only the architectures the port can build are registered: the dense
family (smollm-360m, minicpm-2b, phi3-mini-3.8b, phi3-medium-14b; train
and serve), the MoE family with MLA or GQA attention (deepseek-v2-lite-16b,
llama4-scout-17b-a16e; train and serve) and the SSM family (mamba2-780m;
serves only, its training is ROADMAP Queue 1 item 10).  The JAX package's
hybrid (jamba, item 6e) and encoder / cross-attention architectures
(whisper, llama-3.2-vision, item 6f) wait."""
from __future__ import annotations

from repro_torch.configs import (deepseek_v2_lite_16b, llama4_scout_17b_a16e,
                                 mamba2_780m, minicpm_2b, phi3_medium_14b,
                                 phi3_mini_3_8b, smollm_360m)
from repro_torch.configs.base import ArchConfig, FedConfig

_MODULES = {
    "smollm-360m": smollm_360m,
    "mamba2-780m": mamba2_780m,
    "minicpm-2b": minicpm_2b,
    "phi3-mini-3.8b": phi3_mini_3_8b,
    "phi3-medium-14b": phi3_medium_14b,
    "deepseek-v2-lite-16b": deepseek_v2_lite_16b,
    "llama4-scout-17b-a16e": llama4_scout_17b_a16e,
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
