"""Config registry of the port: ``get_arch(name)`` / ``get_smoke(name)``.

All ten of the JAX package's architectures, each of which trains and
serves: the dense family (smollm-360m, minicpm-2b, phi3-mini-3.8b,
phi3-medium-14b), the MoE family with MLA or GQA attention
(deepseek-v2-lite-16b, llama4-scout-17b-a16e), the stacks with mamba
layers, the SSM family (mamba2-780m) and the hybrid
(jamba-1.5-large-398b), and the encoder / cross-attention families
(whisper-large-v3, llama-3.2-vision-90b), whose loss takes
``enc_embeds`` and ``mask`` batches as JAX's does (no data pipeline of
either package makes such batches).

``SHAPES`` (the JAX package's four input shapes), ``SKIPS`` and
:func:`matrix` are the dry run's (architecture, shape) pairs
(:mod:`repro_torch.launch.dryrun`), a copy of the JAX package's data."""
from __future__ import annotations

from repro_torch.configs import (deepseek_v2_lite_16b, jamba_1_5_large_398b,
                                 llama4_scout_17b_a16e, llama32_vision_90b,
                                 mamba2_780m, minicpm_2b, phi3_medium_14b,
                                 phi3_mini_3_8b, smollm_360m,
                                 whisper_large_v3)
from repro_torch.configs.base import (SHAPES, ArchConfig, FedConfig,
                                      ShapeConfig)

_MODULES = {
    "smollm-360m": smollm_360m,
    "mamba2-780m": mamba2_780m,
    "minicpm-2b": minicpm_2b,
    "phi3-mini-3.8b": phi3_mini_3_8b,
    "phi3-medium-14b": phi3_medium_14b,
    "deepseek-v2-lite-16b": deepseek_v2_lite_16b,
    "llama4-scout-17b-a16e": llama4_scout_17b_a16e,
    "jamba-1.5-large-398b": jamba_1_5_large_398b,
    "whisper-large-v3": whisper_large_v3,
    "llama-3.2-vision-90b": llama32_vision_90b,
}

ARCHS = tuple(_MODULES.keys())


# (arch, shape) pairs the dry run leaves out, with the JAX package's reason
SKIPS = {
    ("whisper-large-v3", "long_500k"):
        "encoder-decoder audio model: 500k-token transcript decode is not "
        "meaningful and the decoder is full-attention by construction",
}


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


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise ValueError(f"unknown shape {name!r}; one of {tuple(SHAPES)}")
    return SHAPES[name]


def matrix():
    """All (arch, shape) pairs the dry run covers: ARCHS x SHAPES less
    SKIPS."""
    return [(a, s) for a in ARCHS for s in SHAPES if (a, s) not in SKIPS]


__all__ = ["ArchConfig", "FedConfig", "ShapeConfig", "SHAPES", "ARCHS",
           "SKIPS", "get_arch", "get_smoke", "get_shape", "matrix"]
