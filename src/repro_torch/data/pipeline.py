"""Cohort scheduler + per-round batch assembly (host side).

``FederatedData`` owns the client partition and produces, per round t:
  - the random client set S_t (fraction C of K clients, Algorithm 1 line 4),
  - ``cohort_batch``: pytree with leaves (cohort, b, ...) — resampled from
    each selected client's local examples,
  - ``client_weights``: (cohort,) = n_k (the FedAvg weighting),
  - optional FedShare injection: a slice of the globally shared set is mixed
    into every client batch (Zhao et al., 2018).

The retry policy's ``sample_round(include=...)`` and the simulated client
speeds belong to the fault runtime (ROADMAP Queue 1 item 3).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.rngtags import META_SAMPLE_SEED


@dataclasses.dataclass
class FederatedData:
    arrays: Dict[str, np.ndarray]        # full dataset, leaves (N, ...)
    client_indices: List[np.ndarray]     # per-client example ids
    meta_indices: Optional[np.ndarray] = None
    shared_indices: Optional[np.ndarray] = None   # FedShare global set
    seed: int = 0

    @property
    def num_clients(self) -> int:
        return len(self.client_indices)

    def _gather(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        return {k: v[idx] for k, v in self.arrays.items()}

    def sample_round(self, round_idx: int, *, cohort: int, batch: int,
                     share: bool = False, share_fraction: float = 0.5
                     ) -> Dict:
        """Returns {'cohort_batch', 'client_weights', 'clients'}."""
        if cohort > self.num_clients:
            # numpy's replace=False error ("Cannot take a larger sample...")
            # names neither quantity; fail with both numbers and the fix
            raise ValueError(
                f"sample_round(cohort={cohort}) cannot draw that many "
                f"distinct clients from num_clients={self.num_clients}; "
                "lower the cohort (C*K) or partition the data into more "
                "clients")
        rng = np.random.default_rng((self.seed, round_idx))
        clients = rng.choice(self.num_clients, size=cohort, replace=False)
        batches, weights = [], []
        n_share = int(batch * share_fraction) if share else 0
        if n_share and self.shared_indices is None:
            # Without this, the share slice is silently skipped and every
            # client batch comes back batch - n_share examples short — a
            # shape mismatch (or quietly smaller batches) far downstream.
            raise ValueError(
                f"sample_round(share=True) with share_fraction="
                f"{share_fraction} needs a FedShare global set, but "
                "FederatedData.shared_indices is None; configure "
                "shared_indices or call with share=False")
        for c in clients:
            idx = self.client_indices[c]
            take = rng.choice(idx, size=batch - n_share,
                              replace=idx.size < batch - n_share)
            if n_share:
                sh = rng.choice(self.shared_indices, size=n_share,
                                replace=self.shared_indices.size < n_share)
                take = np.concatenate([take, sh])
                rng.shuffle(take)
            batches.append(self._gather(take))
            weights.append(idx.size)
        cohort_batch = {k: np.stack([b[k] for b in batches])
                        for k in batches[0]}
        return {
            "cohort_batch": cohort_batch,
            "client_weights": np.asarray(weights, np.float32),
            "clients": clients,
        }

    def sample_meta(self, round_idx: int, batch: int) -> Dict[str, np.ndarray]:
        assert self.meta_indices is not None, "no meta set configured"
        rng = np.random.default_rng((self.seed, META_SAMPLE_SEED, round_idx))
        take = rng.choice(self.meta_indices, size=batch,
                          replace=self.meta_indices.size < batch)
        return self._gather(take)
