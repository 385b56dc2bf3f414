"""The paper's own experimental models (§4), a copy of the JAX package's
``repro/configs/paper_models.py``: the FedAvg CNNs for split CIFAR-10 and
FEMNIST and the character-level GRU for Shakespeare, built by
:mod:`repro_torch.models.smallnets` rather than the transformer stack.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    """§4.1.2 / §4.2.2 — the FedAvg CNN."""
    name: str
    image_size: int
    in_channels: int
    num_classes: int
    conv_channels: Tuple[int, int]
    conv_kernel: int = 5
    pool: int = 3                  # CIFAR: 3x3/2 pooling; FEMNIST: 2x2/2
    pool_stride: int = 2
    fc: Tuple[int, ...] = (384, 192)
    dropout: float = 0.2


@dataclasses.dataclass(frozen=True)
class GRUConfig:
    """§4.3.2 — character-level GRU language model."""
    name: str
    vocab_size: int = 90           # printable charset used by LEAF Shakespeare
    embed_dim: int = 256
    hidden: int = 1024
    seq_len: int = 80


CIFAR_CNN = CNNConfig(
    name="paper-cifar-cnn",
    image_size=32, in_channels=3, num_classes=10,
    conv_channels=(64, 64), conv_kernel=5, pool=3, pool_stride=2,
    fc=(384, 192),
)

FEMNIST_CNN = CNNConfig(
    name="paper-femnist-cnn",
    image_size=28, in_channels=1, num_classes=62,
    conv_channels=(32, 64), conv_kernel=5, pool=2, pool_stride=2,
    fc=(512,),
)

SHAKESPEARE_GRU = GRUConfig(name="paper-shakespeare-gru")

# Reduced variants for fast tests / CI-style benchmark smoke.
CIFAR_CNN_SMOKE = dataclasses.replace(
    CIFAR_CNN, name="paper-cifar-cnn-smoke", conv_channels=(8, 8), fc=(32, 16))
FEMNIST_CNN_SMOKE = dataclasses.replace(
    FEMNIST_CNN, name="paper-femnist-cnn-smoke", conv_channels=(8, 8), fc=(32,))
SHAKESPEARE_GRU_SMOKE = dataclasses.replace(
    SHAKESPEARE_GRU, name="paper-shakespeare-gru-smoke", embed_dim=16,
    hidden=32, seq_len=20)

PAPER_MODELS = {c.name: c for c in (
    CIFAR_CNN, FEMNIST_CNN, SHAKESPEARE_GRU, CIFAR_CNN_SMOKE,
    FEMNIST_CNN_SMOKE, SHAKESPEARE_GRU_SMOKE)}
