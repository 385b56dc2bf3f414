"""FederatedTrainer — the driver loop (PyTorch port of
``repro/core/trainer.py::FederatedTrainer.run``, one round per call, without
observability, checkpoints or retries; those are ROADMAP Queue 1 items 4
and 8).

    trainer = FederatedTrainer(model, fed, seed=0, device="cuda")
    history = trainer.run(data, rounds=3, cohort=4, batch=8)

``run`` samples each round on the host from a
:class:`~repro_torch.data.pipeline.FederatedData`, moves it to the device,
runs the round and returns one record per round (``{"round": r,
**metrics}``), the JAX package's record format.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import FedConfig
from repro_torch.core.round import init_server_state, make_federated_round
from repro_torch.data.pipeline import FederatedData
from repro_torch.device import resolve_device
from repro_torch.models.model import Model

__all__ = ["FederatedTrainer"]


class FederatedTrainer:
    """Owns the server state and the round function."""

    def __init__(self, model: Model, fed: FedConfig, *, seed: int = 0,
                 device=None,
                 params: Optional[Dict[str, torch.Tensor]] = None):
        self.model = model
        self.fed = fed
        self.device = resolve_device(device)
        self._round = make_federated_round(model, fed)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        if params is not None:
            params = {k: v.to(self.device) for k, v in params.items()}
        self.state = init_server_state(model, fed, generator=gen,
                                       params=params)
        self.history: List[Dict[str, float]] = []

    @property
    def round(self) -> int:
        return self.state["round"]

    def _to_device(self, tree):
        """Host batch -> device tensors; integer tokens become int64, the
        index type embedding lookups take."""
        if tree is None:
            return None
        out = {}
        for k, v in tree.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            out[k] = (t if t.is_floating_point() else t.long()).to(
                self.device)
        return out

    def run(self, data: FederatedData, *, rounds: int, cohort: int,
            batch: int, meta_batch: int = 32, share: Optional[bool] = None,
            on_records: Optional[Callable] = None, log_every: int = 0,
            log_fn: Callable = print) -> List[Dict[str, float]]:
        """Train from the current round counter up to ``rounds`` total.
        ``on_records(recs, trainer)`` is called after every round."""
        share = self.fed.share if share is None else share
        run_history: List[Dict[str, float]] = []
        while self.round < rounds:
            r = self.round
            sample = data.sample_round(r, cohort=cohort, batch=batch,
                                       share=share)
            meta = data.sample_meta(r, meta_batch) if self.fed.meta else None
            weights = torch.as_tensor(sample["client_weights"]).to(
                self.device)
            self.state, metrics = self._round(
                self.state, self._to_device(sample["cohort_batch"]),
                self._to_device(meta), weights)
            rec = {name: float(v) for name, v in metrics.items()}
            rec["round"] = r
            run_history.append(rec)
            self.history.append(rec)
            if log_every and (r % log_every == 0 or r == rounds - 1):
                log_fn(f"[round {r}] " + " ".join(
                    f"{k}={v:.5g}" for k, v in rec.items() if k != "round"))
            if on_records is not None:
                on_records([rec], self)
        return run_history
