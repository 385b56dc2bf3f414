"""Synthetic datasets (offline container — no downloads).

``synthetic_tokens`` gives integer LM streams for the transformer archs,
byte-identical to the JAX package's for the same numpy generator.  The
paper models' image and character stand-ins (``synthetic_images``,
``synthetic_chars``) come with those models (ROADMAP Queue 1 item 5).
"""
from __future__ import annotations

import dataclasses

import numpy as np


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
