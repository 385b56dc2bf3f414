"""Unified model API of the port (``repro/models/model.py``): a
:class:`Model` bundles init / loss / prefill / decode for one architecture
so the federated runtime and the launchers stay model-agnostic.

Every architecture of the JAX package's transformer builds, trains and
serves: the dense LM, the MoE families (capacity-routed experts, with GQA
or MLA attention), the stacks with Mamba2 layers (the SSM family, jamba's
hybrid; training runs the differentiable ``models/ssm.py::ssd_chunked``,
the prefill the SSD-scan kernel), and the encoder-decoder and
cross-attention families (whisper, llama-3.2-vision), whose ``loss``
takes the batch's ``enc_embeds`` and ``mask`` as JAX's does.  Prefill and
decode run under ``torch.inference_mode()``.

The paper's own models (:func:`build_paper_cnn`, :func:`build_paper_gru`)
train and have no prefill or decode.  The CNN is the one model that draws
randomness: its ``dropout`` names the masked layers, and its loss takes
their keep masks as ``rng`` (:mod:`repro_torch.core.dropout`)."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch.func import functional_call

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer

Batch = Dict[str, torch.Tensor]


class Dropout(NamedTuple):
    """A model's dropout: the rate and the width of each masked layer, in
    the order the forward masks them."""
    rate: float
    widths: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class Model:
    """init(generator) -> params; loss(params, batch, rng) -> (loss,
    metrics); prefill(params, batch, cache_len, tp) -> (last logits,
    cache); decode(params, tokens, cache, tp) -> (logits, cache);
    make_cache(batch, cache_len, device, mesh) -> cache (``tp`` / ``mesh``:
    serving on a mesh, ``models/transformer.py`` says how).  ``rng`` is the dropout keep masks of a model
    with ``dropout`` (one per masked layer) and unused by every other."""
    name: str
    init: Callable[..., Dict[str, torch.Tensor]]
    loss: Callable[..., Any]
    prefill: Optional[Callable[..., Any]] = None
    decode: Optional[Callable[..., Any]] = None
    make_cache: Optional[Callable[..., Any]] = None
    cfg: Any = None
    dropout: Optional[Dropout] = None


def build_model(cfg: ArchConfig, *, dtype=torch.float32,
                decode_window: int = 0, loss_chunk: int = 2048) -> Model:
    """``decode_window > 0`` selects the sliding-window decode variant (a
    ring-buffer cache of that size) for GQA attention; MLA's latent cache
    is written at the clamped index, as JAX writes it."""
    module = transformer.Transformer(cfg)

    def init(gen: torch.Generator):
        return transformer.init_transformer(cfg, gen, dtype)

    def loss(params, batch: Batch, rng=None, tp=None):
        # tp: params are this process's shards over that model axis
        # (repro_torch.sharding.tensor_parallel)
        return transformer.lm_loss_chunked(
            module, params, batch["tokens"],
            enc_embeds=batch.get("enc_embeds"), mask=batch.get("mask"),
            chunk=loss_chunk, tp=tp)

    @torch.inference_mode()
    def prefill(params, batch: Batch, cache_len: Optional[int] = None,
                tp=None):
        # tp: serving on a mesh (sharding.tensor_parallel.serve_axis):
        # params this process's shards, batch its rows, and the cache its
        # part, padded to the axis's cache length before it is placed
        if tp is None:
            kw = {}
        elif cache_len not in (None, tp.serving.cache_len):
            raise ValueError(
                f"prefill(cache_len={cache_len}) on a mesh: the serving "
                f"axis was built for a cache of {tp.serving.cache_len}")
        else:
            kw = {"tp": tp}
        h, _, cache = functional_call(
            module, params, (batch["tokens"],),
            {"enc_embeds": batch.get("enc_embeds"), "collect_cache": True,
             **kw})
        # only the last position goes through the vocab projection
        if tp is None:
            logits_last = h[:, -1] @ transformer.head_of(cfg, params)
        else:
            logits_last = transformer.logits_of(cfg, params, h[:, -1], tp)
        if cache_len is not None and tp is None:
            cache = transformer.pad_cache(cache, cfg, cache_len)
        return logits_last, cache

    @torch.inference_mode()
    def decode(params, tokens, cache, tp=None):
        return transformer.decode_step(params, tokens, cache, cfg,
                                       window=decode_window, tp=tp)

    def make_cache(batch: int, cache_len: int, device=None, mesh=None):
        # mesh: this process's part of the cache of a global batch
        return transformer.make_cache(cfg, batch, cache_len, dtype,
                                      window=decode_window, device=device,
                                      mesh=mesh)

    return Model(name=cfg.name, init=init, loss=loss, prefill=prefill,
                 decode=decode, make_cache=make_cache, cfg=cfg)


def param_shapes(model: Model) -> Dict[str, torch.Tensor]:
    """The transformer's parameters as ``meta`` tensors (names and
    shapes of ``model.init``'s, nothing allocated)."""
    if not isinstance(model.cfg, ArchConfig):
        raise TypeError(f"{model.name}: not a transformer config")
    return dict(transformer.Transformer(model.cfg).named_parameters())


def build_paper_cnn(cfg) -> Model:
    """The FedAvg CNN; ``loss`` -> (xent, {"xent", "acc"}), with dropout
    when ``rng`` carries the masks."""
    from repro_torch.configs.paper_models import CNNConfig
    from repro_torch.models import smallnets
    from repro_torch.models.layers import accuracy, softmax_xent
    if not isinstance(cfg, CNNConfig):
        raise TypeError(f"build_paper_cnn takes a CNNConfig, got {cfg!r}")

    def loss(params, batch: Batch, rng=None):
        logits = smallnets.cnn_apply(params, cfg, batch["x"], rng=rng)
        l = softmax_xent(logits, batch["y"])
        return l, {"xent": l, "acc": accuracy(logits, batch["y"])}

    return Model(name=cfg.name, init=lambda g: smallnets.cnn_init(cfg, g),
                 loss=loss, cfg=cfg,
                 dropout=(Dropout(cfg.dropout, tuple(cfg.fc))
                          if cfg.dropout > 0 and cfg.fc else None))


def build_paper_gru(cfg) -> Model:
    """The character-level GRU; ``loss`` -> (xent, {"xent", "acc"}) of
    next-character prediction."""
    from repro_torch.configs.paper_models import GRUConfig
    from repro_torch.models import smallnets
    from repro_torch.models.layers import accuracy, softmax_xent
    if not isinstance(cfg, GRUConfig):
        raise TypeError(f"build_paper_gru takes a GRUConfig, got {cfg!r}")

    def loss(params, batch: Batch, rng=None):
        tokens = batch["tokens"]
        logits = smallnets.gru_apply(params, cfg, tokens[:, :-1])
        l = softmax_xent(logits, tokens[:, 1:])
        return l, {"xent": l, "acc": accuracy(logits, tokens[:, 1:])}

    return Model(name=cfg.name, init=lambda g: smallnets.gru_init(cfg, g),
                 loss=loss, cfg=cfg)

