"""The paper's own experimental models (§4.1.2, §4.2.2, §4.3.2), PyTorch
port of ``repro/models/smallnets.py``.

- FedAvg CNN for split CIFAR-10 / FEMNIST: conv5x5 -> relu -> maxpool,
  twice, then fully-connected layers with ReLU + dropout and a softmax
  output.
- Character-level GRU for Shakespeare: embed(256) -> GRU(1024) -> softmax.

The parameters keep the JAX package's names, shapes and layout (in its
leaf order), so
``bridge.to_torch`` carries a JAX tree across unchanged and the flat
buffers of both packages compare element for element: ``conv{1,2}_w`` in
HWIO, ``fc{i}_w`` as (d_in, d_out), the GRU's ``z.wx`` / ``z.wh`` /
``z.b`` and so on.  The forward permutes the conv weights to OIHW and runs
the NHWC images as NCHW, and flattens after permuting back to NHWC, so
that ``fc0_w``'s rows mean what they mean in JAX.

Dropout takes its keep masks from the ``rng`` argument: one boolean
tensor per hidden fc layer, of that layer's (batch, width), drawn on the
host before the round runs (:mod:`repro_torch.core.dropout`); JAX draws
the same masks from its key inside the forward.  ``rng=None`` runs
without dropout (evaluation, FedAvg's final loss).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.configs.paper_models import CNNConfig, GRUConfig
from repro_torch.core.flat import leaf_order
from repro_torch.models.layers import dense_init, softmax_xent

Params = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# CNN
# ---------------------------------------------------------------------------
def _pooled_size(s: int, pool: int, stride: int) -> int:
    return (s - pool) // stride + 1


def cnn_init(cfg: CNNConfig, gen: torch.Generator) -> Params:
    c1, c2 = cfg.conv_channels
    k = cfg.conv_kernel
    dev = gen.device

    def conv(c_in, c_out):
        w = torch.randn((k, k, c_in, c_out), generator=gen, device=dev)
        return w.mul_(math.sqrt(2.0 / (k * k * c_in)))

    params = {"conv1_w": conv(cfg.in_channels, c1),
              "conv1_b": torch.zeros((c1,), device=dev),
              "conv2_w": conv(c1, c2),
              "conv2_b": torch.zeros((c2,), device=dev)}
    s = cfg.image_size
    for _ in range(2):
        s = _pooled_size(s, cfg.pool, cfg.pool_stride)
    dims = (s * s * c2,) + tuple(cfg.fc) + (cfg.num_classes,)
    for i in range(len(dims) - 1):
        # He-style hidden init; a small final layer (init loss ~
        # ln(classes), soft initial curvature for UGA's HVP sweep)
        scale = math.sqrt(2.0 / dims[i])
        if i == len(dims) - 2:
            scale *= 0.1
        params[f"fc{i}_w"] = dense_init(gen, dims[i], dims[i + 1],
                                        scale=scale)
        params[f"fc{i}_b"] = torch.zeros((dims[i + 1],), device=dev)
    return {k: params[k] for k in leaf_order(params)}


def cnn_apply(params: Params, cfg: CNNConfig, images: torch.Tensor, *,
              rng: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    """images: (B, H, W, C) float32 -> logits (B, num_classes).  ``rng``:
    the keep masks of the hidden fc layers, or None (no dropout)."""
    k = cfg.conv_kernel
    if k % 2 != 1:
        raise ValueError(f"a {k}x{k} convolution kernel: the port pads "
                         "'SAME' as k // 2 a side, which is JAX's split for "
                         "odd kernels only")
    x = images.permute(0, 3, 1, 2)                      # NHWC -> NCHW
    for i in (1, 2):
        x = F.conv2d(x, params[f"conv{i}_w"].permute(3, 2, 0, 1),
                     params[f"conv{i}_b"], padding=k // 2)
        x = F.max_pool2d(torch.relu(x), cfg.pool, cfg.pool_stride)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # flatten in HWC
    n_fc = len(cfg.fc) + 1
    for i in range(n_fc):
        x = x @ params[f"fc{i}_w"] + params[f"fc{i}_b"]
        if i < n_fc - 1:
            x = torch.relu(x)
            if rng is not None and cfg.dropout > 0:
                x = torch.where(rng[i], x / (1 - cfg.dropout), 0.0)
    return x


def cnn_loss(params: Params, cfg: CNNConfig, batch, rng=None):
    logits = cnn_apply(params, cfg, batch["x"], rng=rng)
    return softmax_xent(logits, batch["y"])


# ---------------------------------------------------------------------------
# GRU char-LM
# ---------------------------------------------------------------------------
def gru_init(cfg: GRUConfig, gen: torch.Generator) -> Params:
    e, h = cfg.embed_dim, cfg.hidden
    dev = gen.device
    params = {"embed": torch.randn((cfg.vocab_size, e), generator=gen,
                                   device=dev).mul_(0.02)}
    for g in ("z", "r", "h"):
        params[f"{g}.wx"] = dense_init(gen, e, h)
        params[f"{g}.wh"] = dense_init(gen, h, h)
        params[f"{g}.b"] = torch.zeros((h,), device=dev)
    params["out_w"] = dense_init(gen, h, cfg.vocab_size)
    params["out_b"] = torch.zeros((cfg.vocab_size,), device=dev)
    return {k: params[k] for k in leaf_order(params)}


def _gru_cell(p: Params, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    z = torch.sigmoid(x @ p["z.wx"] + h @ p["z.wh"] + p["z.b"])
    r = torch.sigmoid(x @ p["r.wx"] + h @ p["r.wh"] + p["r.b"])
    hh = torch.tanh(x @ p["h.wx"] + (r * h) @ p["h.wh"] + p["h.b"])
    return (1 - z) * h + z * hh


def gru_apply(params: Params, cfg: GRUConfig, tokens: torch.Tensor
              ) -> torch.Tensor:
    """tokens: (B, S) integer -> logits (B, S, V)."""
    B, S = tokens.shape
    x = params["embed"][tokens.long()]                  # (B, S, e)
    h = torch.zeros((B, cfg.hidden), dtype=x.dtype, device=x.device)
    hs = []
    for t in range(S):
        h = _gru_cell(params, x[:, t], h)
        hs.append(h)
    return torch.stack(hs, dim=1) @ params["out_w"] + params["out_b"]


def gru_loss(params: Params, cfg: GRUConfig, batch, rng=None):
    """Next-char prediction: batch {'tokens': (B, S)}, shifted inside."""
    del rng
    tokens = batch["tokens"]
    logits = gru_apply(params, cfg, tokens[:, :-1])
    return softmax_xent(logits, tokens[:, 1:])
