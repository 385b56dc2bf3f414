"""Synthetic datasets (offline container — no downloads), byte-identical
to the JAX package's ``repro/data/synthetic.py`` for the same numpy
generator.

Stand-ins keep the *cardinality and statistical structure* of the paper's
datasets, so that its relative claims (method ordering, convergence-speed
ratios) are testable:

  * ``synthetic_images``  — gaussian class-prototype images with per-writer
    style shifts (split CIFAR-10 / FEMNIST stand-in); partition-by-writer
    yields non-IID clients, like FEMNIST's handwriting;
  * ``synthetic_chars``   — per-role Markov chains over a 90-char alphabet
    (Shakespeare stand-in): extreme non-IID, as in LEAF;
  * ``synthetic_tokens``  — integer LM streams for the transformer archs;
  * ``SeededFrames``      — an encoder's precomputed frame or patch
    embeddings (the port's own: JAX's launcher trains no encoder config).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.rngtags import FRAMES_TAG


@dataclasses.dataclass
class ImageDataset:
    x: np.ndarray          # (N, H, W, C) float32
    y: np.ndarray          # (N,) int32
    writer: np.ndarray     # (N,) int32 — style/writer id


def synthetic_images(rng: np.random.Generator, *, n: int, image_size: int,
                     channels: int, num_classes: int, num_writers: int,
                     noise: float = 0.35, style_strength: float = 0.5,
                     label_skew_alpha: float = 0.0) -> ImageDataset:
    """label_skew_alpha > 0 adds per-writer Dir(alpha) class priors on top
    of the style shift — FEMNIST-by-writer is severely non-IID in both."""
    protos = rng.normal(0, 1, (num_classes, image_size, image_size, channels))
    # writer style: per-writer gain/bias field (smooth low-rank distortion)
    gains = 1.0 + style_strength * rng.normal(
        0, 1, (num_writers, image_size, 1, channels))
    biases = style_strength * rng.normal(
        0, 1, (num_writers, 1, image_size, channels))
    w = rng.integers(0, num_writers, n).astype(np.int32)
    if label_skew_alpha > 0:
        priors = rng.dirichlet(np.full(num_classes, label_skew_alpha),
                               size=num_writers)
        u = rng.random(n)
        y = (u[:, None] < np.cumsum(priors[w], axis=1)).argmax(
            axis=1).astype(np.int32)
    else:
        y = rng.integers(0, num_classes, n).astype(np.int32)
    x = protos[y] * gains[w] + biases[w] + noise * rng.normal(
        0, 1, (n, image_size, image_size, channels))
    return ImageDataset(x=x.astype(np.float32), y=y, writer=w)


@dataclasses.dataclass
class CharDataset:
    tokens: np.ndarray     # (N, S) int32 sequences
    role: np.ndarray       # (N,) int32 — speaking-role / client id


def synthetic_tokens(rng: np.random.Generator, *, n: int, seq_len: int,
                     vocab: int, num_clients: int) -> CharDataset:
    """Cheap LM streams with per-client unigram skew (zipfian, shifted)."""
    base = 1.0 / (1.0 + np.arange(vocab)) ** 1.1
    client = rng.integers(0, num_clients, n).astype(np.int32)
    shift = rng.integers(0, vocab, num_clients)
    toks = np.zeros((n, seq_len), np.int32)
    for c in range(num_clients):
        idx = np.where(client == c)[0]
        if idx.size == 0:
            continue
        p = np.roll(base, shift[c]); p = p / p.sum()
        toks[idx] = rng.choice(vocab, size=(idx.size, seq_len), p=p)
    return CharDataset(tokens=toks, role=client)


def synthetic_chars(rng: np.random.Generator, *, n: int, seq_len: int,
                    vocab: int = 90, num_roles: int = 100,
                    n_modes: int = 8) -> CharDataset:
    """Each role samples from its own mixture of ``n_modes`` shared Markov
    transition matrices — roles are highly non-IID but share structure
    (learnable by a global model)."""
    base = rng.dirichlet(np.ones(vocab) * 0.1, size=(n_modes, vocab))
    role_mix = rng.dirichlet(np.ones(n_modes) * 0.3, size=num_roles)
    role = rng.integers(0, num_roles, n).astype(np.int32)
    toks = np.zeros((n, seq_len), np.int32)
    toks[:, 0] = rng.integers(0, vocab, n)
    # per-role transition matrix (num_roles, vocab, vocab)
    trans = np.einsum("rm,mvw->rvw", role_mix, base)
    cum = np.cumsum(trans, axis=-1)
    u = rng.random((n, seq_len))
    for t in range(1, seq_len):
        c = cum[role, toks[:, t - 1]]                  # (n, vocab)
        toks[:, t] = (u[:, t, None] < c).argmax(axis=-1)
    return CharDataset(tokens=toks, role=role)



class SeededFrames:
    """``(n, length, dim)`` float32 standard normals, an encoder config's
    ``enc_embeds`` for ``n`` examples: example ``i`` is drawn from its own
    generator, ``default_rng((seed, FRAMES_TAG, i))``.  Indexed by an
    array of example ids it draws those rows only, so a full-width
    encoder's inputs (whisper-large-v3: 1500 x 1280 an example, 7.7 MB)
    are never held for the whole dataset."""

    def __init__(self, n: int, length: int, dim: int, seed: int):
        self.shape = (n, length, dim)
        self.seed = seed

    def __len__(self) -> int:
        return self.shape[0]

    def __getitem__(self, idx) -> np.ndarray:
        idx = np.asarray(idx)
        rows = [np.random.default_rng((self.seed, FRAMES_TAG, int(i)))
                .standard_normal(self.shape[1:], dtype=np.float32)
                for i in idx.reshape(-1)]
        return np.stack(rows).reshape(idx.shape + self.shape[1:])
