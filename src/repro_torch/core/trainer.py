"""FederatedTrainer — the driver loop (PyTorch port of
``repro/core/trainer.py::FederatedTrainer.run``, one round per call, with
the retry-with-backoff policy, without observability or checkpoints;
those are ROADMAP Queue 1 items 8 and 4).

    trainer = FederatedTrainer(model, fed, seed=0, device="cuda")
    history = trainer.run(data, rounds=3, cohort=4, batch=8)

``run`` samples each round on the host from a
:class:`~repro_torch.data.pipeline.FederatedData`, moves it to the device,
runs the round and returns one record per round (``{"round": r,
**metrics}``), the JAX package's record format.  The server state carries
from round to round whole: params, the flat optimizer state, under
``meta_mode='through_aggregation'`` ``ctrl``, whose round adds
``ctrl_w_gnorm``, ``ctrl_lr_grad`` and ``server_lr_eff`` to the record,
and under a lossy codec with error feedback ``comm``; a lossy codec's
round adds ``comm_bytes``.

Under ``participation < 1`` or an active fault config each round's draws
(:meth:`FederatedTrainer.draw_round`, keyed by the trainer's seed and the
round) go to the round, which adds ``participants`` or ``arrivals``,
``fault_crashed``, ``fault_dropped`` and, with a deadline,
``fault_timeout``.  With ``retry_backoff > 0`` and crash, drop or a
deadline in the config, a client whose report was lost is re-enqueued
``retry_backoff * 2**attempt`` rounds later, at most ``retry_max``
consecutive failures, read off the same draws; the record gains
``retried``.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import FedConfig
from repro_torch.core.round import (RoundDraws, draw_round,
                                    init_server_state, make_federated_round,
                                    sync_faults)
from repro_torch.data.pipeline import FederatedData
from repro_torch.device import resolve_device
from repro_torch.models.model import Model
from repro_torch.sim.faults import client_failed_mask

__all__ = ["FederatedTrainer"]


class FederatedTrainer:
    """Owns the server state and the round function."""

    def __init__(self, model: Model, fed: FedConfig, *, seed: int = 0,
                 device=None,
                 params: Optional[Dict[str, torch.Tensor]] = None):
        self.model = model
        self.fed = fed
        self.device = resolve_device(device)
        self.seed = seed
        self._round = make_federated_round(model, fed)
        self._faults = sync_faults(fed)
        self._draws = fed.participation < 1.0 or self._faults.active
        # retry-with-backoff bookkeeping: failed client id -> attempts so
        # far, and due round -> ids to re-enqueue
        self._retry_attempts: Dict[int, int] = {}
        self._retry_due: Dict[int, List[int]] = {}
        gen = torch.Generator(device=self.device).manual_seed(seed)
        if params is not None:
            params = {k: v.to(self.device) for k, v in params.items()}
        self.state = init_server_state(model, fed, generator=gen,
                                       params=params)
        self.history: List[Dict[str, float]] = []

    @property
    def round(self) -> int:
        return self.state["round"]

    def draw_round(self, round_idx: int, cohort: int) -> RoundDraws:
        """Round ``round_idx``'s participation and fault draws."""
        return draw_round(self.fed, self.seed, round_idx, cohort)

    def _schedule_retries(self, clients, draws: RoundDraws, due, r: int,
                          rec: Dict[str, float]) -> None:
        """Re-enqueue the clients whose report this round lost, with
        exponential backoff, from the draws the round took."""
        failed = client_failed_mask(draws.faults, self._faults)
        clients = np.asarray(clients)
        rec["retried"] = float(len(set(due or []) & set(clients.tolist())))
        for cid in clients[~failed]:
            self._retry_attempts.pop(int(cid), None)
        for cid in clients[failed]:
            cid = int(cid)
            a = self._retry_attempts.get(cid, 0)
            if a >= self.fed.retry_max:
                continue
            self._retry_attempts[cid] = a + 1
            due_round = max(r + self.fed.retry_backoff * (2 ** a), r + 1)
            self._retry_due.setdefault(due_round, []).append(cid)

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
        f = self._faults
        retry_on = (self.fed.retry_backoff > 0 and f.active
                    and (f.crash > 0 or f.drop > 0 or f.deadline > 0))
        run_history: List[Dict[str, float]] = []
        while self.round < rounds:
            r = self.round
            due = self._retry_due.pop(r, None) if retry_on else None
            sample = data.sample_round(r, cohort=cohort, batch=batch,
                                       share=share, include=due)
            meta = data.sample_meta(r, meta_batch) if self.fed.meta else None
            weights = torch.as_tensor(sample["client_weights"]).to(
                self.device)
            draws = self.draw_round(r, cohort) if self._draws else None
            self.state, metrics = self._round(
                self.state, self._to_device(sample["cohort_batch"]),
                self._to_device(meta), weights, draws)
            rec = {name: float(v) for name, v in metrics.items()}
            if retry_on:
                self._schedule_retries(sample["clients"], draws, due, r, rec)
            rec["round"] = r
            run_history.append(rec)
            self.history.append(rec)
            if log_every and (r % log_every == 0 or r == rounds - 1):
                log_fn(f"[round {r}] " + " ".join(
                    f"{k}={v:.5g}" for k, v in rec.items() if k != "round"))
            if on_records is not None:
                on_records([rec], self)
        return run_history
