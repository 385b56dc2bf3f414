"""Client partitioners and meta-set construction, byte-identical to the
JAX package's ``repro/data/partition.py`` for the same numpy generator.

  * ``partition_iid``       — §4.1: uniform random split (split CIFAR-10);
  * ``partition_dirichlet`` — label-skew non-IID (Dir(alpha) over classes);
  * ``partition_by_writer`` — §4.2/§4.3: one writer/role per client (FEMNIST
    / Shakespeare style, the paper's non-IID settings);
  * ``make_meta_set``       — §3.2/§4.4: sample the server meta set D_meta,
    optionally with a controlled writer-overlap rate vs the training
    population (Fig. 5's 0/25/50/75/100% overlap experiment).
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np


def partition_iid(rng: np.random.Generator, n: int, num_clients: int
                  ) -> List[np.ndarray]:
    perm = rng.permutation(n)
    return [np.sort(s) for s in np.array_split(perm, num_clients)]


def partition_dirichlet(rng: np.random.Generator, labels: np.ndarray,
                        num_clients: int, alpha: float = 0.3,
                        min_per_client: int = 8) -> List[np.ndarray]:
    classes = np.unique(labels)
    while True:
        buckets: List[List[int]] = [[] for _ in range(num_clients)]
        for c in classes:
            idx = np.where(labels == c)[0]
            rng.shuffle(idx)
            p = rng.dirichlet(np.full(num_clients, alpha))
            cuts = (np.cumsum(p)[:-1] * idx.size).astype(int)
            for b, part in zip(buckets, np.split(idx, cuts)):
                b.extend(part.tolist())
        if min(len(b) for b in buckets) >= min_per_client:
            return [np.sort(np.array(b)) for b in buckets]


def partition_by_writer(writer_ids: np.ndarray, writers: Sequence[int]
                        ) -> List[np.ndarray]:
    """One client per writer/role id, in the given order."""
    return [np.where(writer_ids == w)[0] for w in writers]


def make_meta_set(rng: np.random.Generator, writer_ids: np.ndarray,
                  train_writers: Sequence[int], aux_writers: Sequence[int],
                  *, overlap: float, fraction: float = 0.01
                  ) -> np.ndarray:
    """Sample ~``fraction`` of examples for D_meta from a writer population
    with the given overlap rate vs the training writers (§4.4): a fraction
    ``overlap`` of the meta writers come from ``train_writers``, the rest
    from the disjoint ``aux_writers``."""
    k = max(len(train_writers), 1)
    n_in = int(round(overlap * k))
    chosen = (list(rng.choice(np.asarray(train_writers), n_in, replace=False))
              + list(rng.choice(np.asarray(aux_writers), k - n_in,
                                replace=False)))
    pool = np.concatenate([np.where(writer_ids == w)[0] for w in chosen])
    n_meta = max(int(round(fraction * writer_ids.size)), 1)
    n_meta = min(n_meta, pool.size)
    return np.sort(rng.choice(pool, n_meta, replace=False))
