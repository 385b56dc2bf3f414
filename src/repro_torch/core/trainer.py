"""FederatedTrainer — the driver loop (PyTorch port of
``repro/core/trainer.py::FederatedTrainer``, one round per call, with the
retry-with-backoff policy and checkpoints, without observability; that is
ROADMAP Queue 1 item 8).

    trainer = FederatedTrainer(model, fed, seed=0, device="cuda")
    trainer.restore(path)                      # optional resume
    history = trainer.run(data, rounds=3, cohort=4, batch=8)
    trainer.save(path)
    trainer.finish()

``run`` samples each round on the host from a
:class:`~repro_torch.data.pipeline.FederatedData`, moves it to the device,
runs the round and returns one record per round (``{"round": r,
**metrics}``), the JAX package's record format; a vector metric (the
buffered-async tick's ``staleness_hist``) becomes a list.  The server
state carries from round to round whole: params, the flat optimizer
state, under ``meta_mode='through_aggregation'`` ``ctrl``, whose round
adds ``ctrl_w_gnorm``, ``ctrl_lr_grad`` and ``server_lr_eff`` to the
record, under a lossy codec with error feedback ``comm``, and under
``engine='buffered_async'`` the delta pool ``async``; a lossy codec's
round adds ``comm_bytes``.

Under ``participation < 1``, an active fault config or a model with
dropout each round's draws (:meth:`FederatedTrainer.draw_round`, keyed by
the trainer's seed and the round) go to the round.  The dropout masks are
drawn on the host (:mod:`repro_torch.core.dropout`); participation and
faults add ``participants`` or ``arrivals``, ``fault_crashed``,
``fault_dropped`` and, with a deadline, ``fault_timeout`` (an async tick:
``fault_delayed``).  With ``retry_backoff > 0`` and crash, drop or a
deadline in the config, a client whose report was lost is re-enqueued
``retry_backoff * 2**attempt`` rounds later, at most ``retry_max``
consecutive failures, read off the same draws; the record gains
``retried``.

Under the sharded executor (``mesh=``, :mod:`repro_torch.launch.mesh`)
every process runs the trainer on its slice of the cohort and holds the
whole server state; only the mesh's rank 0 logs and writes checkpoints.

Checkpoints: :meth:`save` writes the whole server state and the run
history in the JAX package's blob format (``repro_torch.checkpoint``),
:meth:`restore` reads it back; with ``checkpoint_every`` and a
``run_dir`` a :class:`~repro_torch.checkpoint.CheckpointManager` keeps a
store in ``run_dir/checkpoints`` (a save every N rounds and at run end;
0: at run end only) that :meth:`resume_latest` resumes from.
"""
from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint import restore as ckpt_restore
from repro_torch.checkpoint import save as ckpt_save
from repro_torch.configs.base import FedConfig
from repro_torch.core.async_round import (async_checkpoint_view,
                                          async_from_checkpoint)
from repro_torch.core.round import (RoundDraws, draw_round,
                                    init_server_state, make_federated_round,
                                    round_faults)
from repro_torch.data.pipeline import FederatedData
from repro_torch.device import resolve_device
from repro_torch.models.model import Model
from repro_torch.sim.faults import client_failed_mask, resolve_faults

__all__ = ["FederatedTrainer", "batch_to_device"]


def batch_to_device(tree, device):
    """Host batch -> device tensors; integer arrays (tokens, labels) become
    int64, the index type embedding lookups and gathers take."""
    if tree is None:
        return None
    out = {}
    for k, v in tree.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = (t if t.is_floating_point() else t.long()).to(device)
    return out


class FederatedTrainer:
    """Owns the server state and the round function."""

    def __init__(self, model: Model, fed: FedConfig, *, seed: int = 0,
                 device=None,
                 params: Optional[Dict[str, torch.Tensor]] = None,
                 run_dir: Optional[str] = None,
                 checkpoint_every: Optional[int] = None,
                 keep_last: int = 3, keep_every: int = 0,
                 executor: Optional[str] = None, mesh=None):
        self.model = model
        self.fed = fed
        self.device = resolve_device(device if mesh is None
                                     else mesh.device)
        self.seed = seed
        self.mesh = mesh
        # the process that logs and writes: every process of a mesh holds
        # the same state
        self.is_main = mesh is None or mesh.rank == 0
        self._round = make_federated_round(model, fed, executor=executor,
                                           mesh=mesh)
        self._faults = round_faults(fed)
        self._draws = (fed.participation < 1.0 or self._faults.active
                       or model.dropout is not None)
        # retry-with-backoff bookkeeping: failed client id -> attempts so
        # far, and due round -> ids to re-enqueue
        self._retry_attempts: Dict[int, int] = {}
        self._retry_due: Dict[int, List[int]] = {}
        gen = torch.Generator(device=self.device).manual_seed(seed)
        if params is not None:
            params = {k: v.to(self.device) for k, v in params.items()}
        self.state = init_server_state(model, fed, generator=gen,
                                       params=params)
        self.history: List[Dict[str, Any]] = []
        self.run_dir = run_dir
        self._ckpt_every = checkpoint_every
        self.manager: Optional[CheckpointManager] = None
        if checkpoint_every is not None:
            if run_dir is None:
                raise ValueError(
                    "managed checkpointing (checkpoint_every=N) writes "
                    "under the run directory; pass run_dir= as well, or "
                    "use save(path) for one-shot checkpoints")
            self.manager = CheckpointManager(
                os.path.join(run_dir, "checkpoints"),
                keep_last=keep_last, keep_every=keep_every)
        self._last_managed_step: Optional[int] = None

    @property
    def round(self) -> int:
        return self.state["round"]

    # ---- checkpoints --------------------------------------------------
    def checkpoint_tree(self) -> Dict[str, Any]:
        """The server state in the blob's layout: the async pool in
        logical slot order."""
        tree = dict(self.state)
        if "async" in tree:
            tree["async"] = async_checkpoint_view(tree["async"])
        return tree

    def _load_tree(self, tree: Dict[str, Any]) -> None:
        if "async" in tree:
            tree["async"] = async_from_checkpoint(tree["async"])
        self.state = tree

    def save(self, path: str, extra: Optional[dict] = None) -> None:
        """The whole server state and the run history, so :meth:`restore`
        continues mid-run with the optimizer state, ``ctrl``, the
        residuals, the delta pool and the metrics curve."""
        if self.is_main:
            ckpt_save(path, self.checkpoint_tree(),
                      extra={**(extra or {}), "history": self.history})

    def restore(self, path: str) -> dict:
        """Resume from a blob :meth:`save` wrote (or the JAX trainer's, of
        the same configuration); restores the history too and returns the
        blob's ``extra`` without it."""
        tree, extra = ckpt_restore(path, self.checkpoint_tree())
        self._load_tree(tree)
        self.history = list(extra.pop("history", self.history))
        return extra

    def resume_latest(self) -> Optional[int]:
        """Restore the newest managed checkpoint (``--resume auto``);
        returns its step, or None when the store is empty."""
        if self.manager is None:
            return None
        hit = self.manager.restore_latest(self.checkpoint_tree())
        if hit is None:
            return None
        tree, extra, step = hit
        self._load_tree(tree)
        self.history = list(extra.pop("history", self.history))
        self._last_managed_step = step
        return step

    def finish(self) -> None:
        """Drain and close the checkpoint store (idempotent)."""
        if self.manager is not None:
            self.manager.close()

    def _save_managed(self, step: int) -> None:
        if self.is_main:
            self.manager.save(step, self.checkpoint_tree(),
                              extra={"history": self.history})
        self._last_managed_step = step

    def draw_round(self, round_idx: int, cohort: int) -> RoundDraws:
        """Round ``round_idx``'s participation, fault and dropout draws."""
        return draw_round(self.fed, self.seed, round_idx, cohort,
                          dropout=self.model.dropout is not None)

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

    def run(self, data: FederatedData, *, rounds: int, cohort: int,
            batch: int, meta_batch: int = 32, share: Optional[bool] = None,
            sample_meta: Optional[Callable] = None,
            on_records: Optional[Callable] = None, log_every: int = 0,
            log_fn: Callable = print) -> List[Dict[str, float]]:
        """Train from the current round counter up to ``rounds`` total.
        ``sample_meta(data, round_idx, meta_batch, sample)`` overrides the
        D_meta sampling (default: ``data.sample_meta`` when ``fed.meta``,
        else None); ``on_records(recs, trainer)`` is called after every
        round."""
        share = self.fed.share if share is None else share
        f = resolve_faults(self.fed)
        retry_on = (self.fed.retry_backoff > 0 and f.active
                    and (f.crash > 0 or f.drop > 0 or f.deadline > 0))
        run_history: List[Dict[str, Any]] = []
        while self.round < rounds:
            r = self.round
            due = self._retry_due.pop(r, None) if retry_on else None
            sample = data.sample_round(r, cohort=cohort, batch=batch,
                                       share=share, include=due)
            if sample_meta is not None:
                meta = sample_meta(data, r, meta_batch, sample)
            else:
                meta = (data.sample_meta(r, meta_batch) if self.fed.meta
                        else None)
            weights = torch.as_tensor(sample["client_weights"]).to(
                self.device)
            draws = self.draw_round(r, cohort) if self._draws else None
            self.state, metrics = self._round(
                self.state, batch_to_device(sample["cohort_batch"],
                                            self.device),
                batch_to_device(meta, self.device), weights, draws)
            rec = {name: _record_value(v) for name, v in metrics.items()}
            if retry_on:
                self._schedule_retries(sample["clients"], draws, due, r, rec)
            rec["round"] = r
            run_history.append(rec)
            self.history.append(rec)
            if log_every and self.is_main and (r % log_every == 0
                                               or r == rounds - 1):
                log_fn(f"[round {r}] " + " ".join(
                    f"{k}={_fmt(v)}" for k, v in rec.items()
                    if k != "round"))
            if on_records is not None:
                on_records([rec], self)
            if self.manager is not None and self._ckpt_every \
                    and self.round % self._ckpt_every == 0:
                self._save_managed(self.round)
        if self.manager is not None and self._last_managed_step != self.round:
            self._save_managed(self.round)
        return run_history


def _record_value(v):
    """A metric as a record holds it: a float, or a list for a vector."""
    a = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)
    return float(a) if a.ndim == 0 else a.astype(float).tolist()


def _fmt(v) -> str:
    if isinstance(v, list):
        return "[" + ",".join(f"{x:g}" for x in v) + "]"
    return f"{v:.5g}"
