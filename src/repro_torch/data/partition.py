"""Client partitioners.

``partition_iid`` is the §4.1 uniform random split.  The label-skew,
per-writer and meta-overlap partitioners of the JAX package serve the
paper models' experiments and come with them (ROADMAP Queue 1 item 5).
"""
from __future__ import annotations

from typing import List

import numpy as np


def partition_iid(rng: np.random.Generator, n: int, num_clients: int
                  ) -> List[np.ndarray]:
    perm = rng.permutation(n)
    return [np.sort(s) for s in np.array_split(perm, num_clients)]
