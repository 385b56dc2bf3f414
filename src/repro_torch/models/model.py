"""Unified model API of the port (``repro/models/model.py``): a
:class:`Model` bundles init / loss / prefill / decode for one architecture
so the federated runtime and the launchers stay model-agnostic.

The dense LM family and the MoE family (capacity-routed experts, with GQA
or MLA attention) train and serve; the SSM family (Mamba2) serves only —
its training needs derivatives through the SSD scan, forward mode
included, which no kernel has yet (ROADMAP Queue 1 item 10).  The other
families wait for ROADMAP Queue 1 items 5 (paper CNN/GRU), 6e (the jamba
hybrid) and 6f (encoders, cross-attention, sinusoidal positions).
Prefill and decode run under ``torch.inference_mode()``."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch
from torch.func import functional_call

from repro_torch.configs.base import ATTN, CROSS, MAMBA, ArchConfig
from repro_torch.models import transformer

Batch = Dict[str, torch.Tensor]
SSM_TRAINING = ("SSM-family training is not yet ported to repro_torch: it "
                "needs derivatives through the SSD scan, forward mode "
                "included (ROADMAP Queue 1 item 10)")


@dataclasses.dataclass(frozen=True)
class Model:
    """init(generator) -> params; loss(params, batch, rng) -> (loss,
    metrics); prefill(params, batch, cache_len) -> (last logits, cache);
    decode(params, tokens, cache) -> (logits, cache); make_cache(batch,
    cache_len) -> cache.  ``rng`` is accepted for signature parity and
    unused."""
    name: str
    init: Callable[..., Dict[str, torch.Tensor]]
    loss: Callable[..., Any]
    prefill: Optional[Callable[..., Any]] = None
    decode: Optional[Callable[..., Any]] = None
    make_cache: Optional[Callable[..., Any]] = None
    cfg: Any = None


def build_model(cfg: ArchConfig, *, dtype=torch.float32,
                decode_window: int = 0, loss_chunk: int = 2048) -> Model:
    """``decode_window > 0`` selects the sliding-window decode variant (a
    ring-buffer cache of that size) for GQA attention; MLA's latent cache
    is written at the clamped index, as JAX writes it."""
    kinds = set(cfg.layer_kinds())
    ssm_family = kinds == {MAMBA}
    unsupported = [what for what, bad in (
        ("hybrid attention/SSM stack (ROADMAP Queue 1 item 6e)",
         cfg.family == "hybrid" or {ATTN, MAMBA} <= kinds),
        ("encoder (ROADMAP Queue 1 item 6f)", cfg.encoder is not None),
        ("cross-attention layers (ROADMAP Queue 1 item 6f)",
         CROSS in kinds),
        ("SSM layers without an SSM config (ROADMAP Queue 1 item 6e)",
         MAMBA in kinds and cfg.ssm is None),
        ("rope_theta <= 0 (sinusoidal positions; ROADMAP Queue 1 item 6f)",
         ATTN in kinds and cfg.rope_theta <= 0),
    ) if bad]
    if unsupported:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(unsupported)} not yet ported to "
            "repro_torch")
    module = transformer.Transformer(cfg)

    def init(gen: torch.Generator):
        return transformer.init_transformer(cfg, gen, dtype)

    def loss(params, batch: Batch, rng=None):
        if ssm_family:
            raise NotImplementedError(SSM_TRAINING)
        if "mask" in batch or "enc_embeds" in batch:
            raise NotImplementedError("masked / encoder LM batches are not "
                                      "ported (ROADMAP Queue 1 item 6f)")
        return transformer.lm_loss_chunked(module, params, batch["tokens"],
                                           chunk=loss_chunk)

    @torch.inference_mode()
    def prefill(params, batch: Batch, cache_len: Optional[int] = None):
        # only the last position goes through the vocab projection
        h, _, cache = functional_call(module, params, (batch["tokens"],),
                                      {"collect_cache": True})
        logits_last = h[:, -1] @ transformer.head_of(cfg, params)
        if cache_len is not None:
            cache = transformer.pad_cache(cache, cfg, cache_len)
        return logits_last, cache

    @torch.inference_mode()
    def decode(params, tokens, cache):
        return transformer.decode_step(params, tokens, cache, cfg,
                                       window=decode_window)

    def make_cache(batch: int, cache_len: int, device=None):
        return transformer.make_cache(cfg, batch, cache_len, dtype,
                                      window=decode_window, device=device)

    return Model(name=cfg.name, init=init, loss=loss, prefill=prefill,
                 decode=decode, make_cache=make_cache, cfg=cfg)
