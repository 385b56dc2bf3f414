"""Unified model API of the port (``repro/models/model.py``): a
:class:`Model` bundles ``init`` and ``loss`` so the federated runtime stays
model-agnostic.  The dense LM family is ported; the other families wait
for ROADMAP Queue 1 items 5 (paper CNN/GRU) and 6 (MoE, MLA, SSM,
encoders)."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch

from repro_torch.configs.base import ATTN, ArchConfig
from repro_torch.models import transformer

Batch = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Model:
    """init(generator) -> params; loss(params, batch, rng) -> (loss,
    metrics).  ``rng`` is accepted for signature parity and unused."""
    name: str
    init: Callable[..., Dict[str, torch.Tensor]]
    loss: Callable[..., Any]
    cfg: Any = None


def build_model(cfg: ArchConfig, *, dtype=torch.float32,
                loss_chunk: int = 2048) -> Model:
    unsupported = [what for what, bad in (
        ("MoE", cfg.moe is not None), ("MLA", cfg.mla is not None),
        ("SSM", cfg.ssm is not None or cfg.family in ("ssm", "hybrid")),
        ("encoder", cfg.encoder is not None),
        ("non-attention layers", set(cfg.layer_kinds()) != {ATTN}),
        ("rope_theta <= 0 (sinusoidal positions)", cfg.rope_theta <= 0),
    ) if bad]
    if unsupported:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(unsupported)} not yet ported to "
            "repro_torch (ROADMAP Queue 1 item 6)")
    module = transformer.Transformer(cfg)

    def init(gen: torch.Generator):
        return transformer.init_transformer(cfg, gen, dtype)

    def loss(params, batch: Batch, rng=None):
        if "mask" in batch or "enc_embeds" in batch:
            raise NotImplementedError("masked / encoder LM batches are not "
                                      "ported (ROADMAP Queue 1 item 6)")
        return transformer.lm_loss_chunked(module, params, batch["tokens"],
                                           chunk=loss_chunk)

    return Model(name=cfg.name, init=init, loss=loss, cfg=cfg)
