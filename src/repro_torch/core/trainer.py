"""FederatedTrainer — the driver loop (PyTorch port of
``repro/core/trainer.py::FederatedTrainer``: multi-round calls, the
retry-with-backoff policy, checkpoints, observability, the sanitizer and
the live roofline event).

    trainer = FederatedTrainer(model, fed, seed=0, device="cuda",
                               rounds_per_call=4, tracker="jsonl",
                               run_dir="runs/exp0")
    trainer.restore(path)                      # optional resume
    history = trainer.run(data, rounds=10, cohort=4, batch=8)
    trainer.save(path)
    trainer.finish()

``run`` goes in chunks of ``rounds_per_call`` = K rounds, the last one
shorter when K does not divide what is left: it samples the chunk's K
rounds on the host from a
:class:`~repro_torch.data.pipeline.FederatedData` (batches, D_meta and
draws), sends them to the device in one stacked copy
(:func:`~repro_torch.core.round.stack_round_inputs`), runs the K-round
function and reads the metrics back once, after it.  It returns one
record per round (``{"round": r, **metrics}``), the JAX package's record
format, the same at every K; a vector metric (the buffered-async tick's
``staleness_hist``) becomes a list.  ``on_records(recs, trainer)`` is
called once a chunk, with its K records.  The server
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
``retried``.  A chunk's cohorts are sampled before it runs, so a retry
falls due no earlier than the next chunk (at K = 1, the next round).

Under the sharded executor (``mesh=``, :mod:`repro_torch.launch.mesh`)
every process runs the trainer on its slice of the cohort and holds the
whole server state; only the mesh's rank 0 logs, profiles and writes
trackers and checkpoints (the others track to ``noop``).

Observability (:mod:`repro_torch.obs`), as in the JAX trainer: every
record goes to the trainer's :class:`~repro_torch.obs.MetricsTracker`
(``tracker=``: a registry name, an instance or a comma list; default
``noop``; ``run(..., tracker=)`` overrides it for one call, and
``log_every`` composes a ``console`` tracker in).  Each chunk's host
phases are ``phase`` events: ``sample_stack`` (sampling and the stacked
copy to the device), ``dispatch`` (the K-round call: host issue time,
since CUDA work is queued), ``device_sync`` (``torch.cuda.synchronize()``
on a card: the device's drain tail; next to nothing on the CPU) and
``checkpoint``, between ``run_start`` and ``run_finish`` events.
``profile=N`` captures a ``torch.profiler`` trace of rounds
``[profile_start, profile_start + N)`` into ``run_dir/profile``, with
dispatch and device_sync also marked as ``repro.phase.<name>`` ranges,
and ``trace_summary=True`` parses the closed capture into a
``profile_summary`` event (:mod:`repro_torch.obs.trace_analysis`).
``sanitize=True`` builds the rounds with NaN/Inf probes
(:mod:`repro_torch.core.sanitize`), read back once a chunk, after its
device sync.  ``roofline=True`` traces each distinct K-round function
once on fake stand-ins of the staged inputs (:mod:`repro_torch.
roofline.live`), before its
first dispatch and outside the profiler window and the phase spans, and
emits at run end one ``roofline`` event per K with the measured rounds/s
of the dispatch + device-sync spans beside the prediction, under
participation < 1, faults and the buffered-async engine too: the trainer
hands the round its weights on the host, so the all-failed test and the
tick's pool bookkeeping read no device value.  A trace takes the draws
of the chunk it precedes.  A sanitized round emits no event.  None of
these changes a round's bits: they read what the trainer already holds
on the host.

Checkpoints: :meth:`save` writes the whole server state and the run
history in the JAX package's blob format (``repro_torch.checkpoint``),
:meth:`restore` reads it back; with ``checkpoint_every`` and a
``run_dir`` a :class:`~repro_torch.checkpoint.CheckpointManager` keeps a
store in ``run_dir/checkpoints`` (a save whenever a chunk crosses a
multiple of N rounds, and at run end; 0: at run end only) that
:meth:`resume_latest` resumes from.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint import restore as ckpt_restore
from repro_torch.checkpoint import save as ckpt_save
from repro_torch.configs.base import FedConfig
from repro_torch.core.async_round import (async_checkpoint_view,
                                          async_from_checkpoint)
from repro_torch.core.round import (RoundDraws, RoundFnCache,
                                    batch_to_device, draw_round,
                                    init_server_state, round_faults,
                                    stack_round_inputs)
from repro_torch.core.sanitize import probe_log
from repro_torch.data.pipeline import FederatedData
from repro_torch.device import resolve_device
from repro_torch.models.model import Model
from repro_torch.obs.profiler import RoundProfiler
from repro_torch.obs.trackers import (CompositeTracker, ConsoleTracker,
                                      resolve_tracker, span)
from repro_torch.sim.faults import client_failed_mask, resolve_faults

__all__ = ["FederatedTrainer", "batch_to_device"]


class FederatedTrainer:
    """Owns the server state and the round function."""

    def __init__(self, model: Model, fed: FedConfig, *,
                 rounds_per_call: int = 1, seed: int = 0, device=None,
                 params: Optional[Dict[str, torch.Tensor]] = None,
                 run_dir: Optional[str] = None,
                 checkpoint_every: Optional[int] = None,
                 keep_last: int = 3, keep_every: int = 0,
                 executor: Optional[str] = None, mesh=None,
                 sanitize: bool = False, tracker=None, profile: int = 0,
                 profile_start: int = 0, trace_summary: bool = False,
                 trace_top_k: int = 15, roofline: bool = False):
        if trace_summary and profile <= 0:
            raise ValueError(
                "trace_summary summarizes the profiler's capture and needs "
                "an open window; pass profile=N (train.py --profile N) "
                "alongside trace_summary")
        self.model = model
        self.fed = fed
        self.rounds_per_call = max(int(rounds_per_call), 1)
        self.device = resolve_device(device if mesh is None
                                     else mesh.device)
        self.seed = seed
        self.mesh = mesh
        # the process that logs and writes: every process of a mesh holds
        # the same state
        self.is_main = mesh is None or mesh.rank == 0
        self._sanitize = bool(sanitize)
        self._cache = RoundFnCache(model, fed, executor=executor, mesh=mesh,
                                   sanitize=sanitize)
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
        # ---- observability: the main process's sinks, noop elsewhere ----
        self.tracker = resolve_tracker(tracker if self.is_main else None,
                                       run_dir=run_dir)
        self.profiler = RoundProfiler(
            run_dir, start=profile_start,
            rounds=profile if self.is_main else 0, tracker=self.tracker,
            device=self.device)
        self._trace_summary = bool(trace_summary)
        self._trace_top_k = int(trace_top_k)
        self._roofline = bool(roofline) and self.is_main
        self._roofline_events: Dict[int, Optional[dict]] = {}
        # the traces' whole summaries (kernel launches, bytes read and
        # written), keyed by K, for callers that check more than the event
        self.roofline_summaries: Dict[int, dict] = {}
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
        """Close the profiler (a window still open is written and, with
        ``trace_summary``, summarized), then the tracker, then the
        checkpoint store (idempotent).  Callers that passed a shared
        tracker instance may close it themselves instead."""
        was_active = self.profiler.active
        self.profiler.close()
        if was_active:
            self._emit_trace_summary(self.tracker)
        self.tracker.finish()
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

    def _schedule_retries(self, samples, draws, recs, due, r: int,
                          k: int) -> None:
        """Re-enqueue the clients whose report a round of the chunk
        ``[r, r + k)`` lost, with exponential backoff, from the draws the
        round took, no earlier than the next chunk (its cohorts are
        already sampled)."""
        for j in range(k):
            failed = client_failed_mask(draws[j].faults, self._faults)
            clients = np.asarray(samples[j]["clients"])
            recs[j]["retried"] = float(len(set(due[j] or [])
                                           & set(clients.tolist())))
            for cid in clients[~failed]:
                self._retry_attempts.pop(int(cid), None)
            for cid in clients[failed]:
                cid = int(cid)
                a = self._retry_attempts.get(cid, 0)
                if a >= self.fed.retry_max:
                    continue
                self._retry_attempts[cid] = a + 1
                due_round = max(r + j + self.fed.retry_backoff * (2 ** a),
                                r + k)
                self._retry_due.setdefault(due_round, []).append(cid)

    def _stage(self, samples, metas, draws) -> tuple:
        """The chunk's batches on the device: the one round's for k = 1,
        else the K-stacked copy (:func:`stack_round_inputs`).  The weights
        stay on the host: the round's host tests read them there, and the
        round sends them up itself."""
        if len(samples) == 1:
            return (batch_to_device(samples[0]["cohort_batch"], self.device),
                    batch_to_device(metas[0], self.device),
                    np.asarray(samples[0]["client_weights"], np.float32),
                    draws[0])
        cb, mb, w, draws = stack_round_inputs(
            [s["cohort_batch"] for s in samples], metas,
            [s["client_weights"] for s in samples], draws,
            device=self.device, weights_device="cpu")
        return cb, mb, w.numpy(), draws

    @staticmethod
    def _records(k: int, metrics) -> list:
        """The chunk's k records (metrics only), read back once."""
        if k == 1:
            return [{name: _record_value(v) for name, v in metrics.items()}]
        host = {name: v.cpu().numpy() for name, v in metrics.items()}
        return [{name: _record_value(a[j]) for name, a in host.items()}
                for j in range(k)]

    def _phase_annotation(self, name: str):
        """The trace twin of the ``span()`` event: while the profiler is
        capturing, a ``repro.phase.<name>`` range, so
        :mod:`repro_torch.obs.trace_analysis` can credit device time to
        phases.  A no-op context outside the window."""
        if self.profiler.active:
            return torch.profiler.record_function(f"repro.phase.{name}")
        return contextlib.nullcontext()

    def _emit_trace_summary(self, trk) -> None:
        if not self._trace_summary:
            return
        from repro_torch.obs.trace_analysis import emit_profile_summary
        emit_profile_summary(trk, self.profiler.trace_dir,
                             top_k=self._trace_top_k)

    def _prepare_roofline(self, k: int, staged) -> None:
        """Trace the K-round function on fake stand-ins of the state and
        the staged inputs and keep its event payload.  Runs once per
        distinct k, before that function's first dispatch, outside the
        profiler window and the phase spans."""
        from repro_torch.roofline.live import (roofline_event,
                                               round_cost_summary)
        fn = self._cache(k)
        if getattr(fn, "sanitized", False):
            # the probes' counts are read on the host: no trace, no event
            self._roofline_events[k] = None
            return
        t0 = time.perf_counter()
        s = round_cost_summary(fn, (self.state, *staged), device=self.device)
        self.roofline_summaries[k] = s
        self._roofline_events[k] = roofline_event(
            s, rounds_per_call=k, analysis_s=time.perf_counter() - t0)

    def _emit_roofline(self, trk, loop_s: float, rounds_measured: int
                       ) -> None:
        """One ``roofline`` event per traced K, with this run's measured
        dispatch + device-sync throughput beside the prediction."""
        for k in sorted(self._roofline_events):
            ev = self._roofline_events[k]
            if ev is None:
                continue
            payload = dict(ev)
            payload["rounds_measured"] = rounds_measured
            payload["measured_s_per_round"] = \
                (loop_s / rounds_measured) if rounds_measured else 0.0
            payload["measured_rounds_per_s"] = \
                (rounds_measured / loop_s) if loop_s > 0 else 0.0
            trk.log_event("roofline", payload)

    def run(self, data: FederatedData, *, rounds: int, cohort: int,
            batch: int, meta_batch: int = 32, share: Optional[bool] = None,
            sample_meta: Optional[Callable] = None,
            on_records: Optional[Callable] = None, log_every: int = 0,
            log_fn: Callable = print,
            tracker=None) -> List[Dict[str, float]]:
        """Train from the current round counter up to ``rounds`` total.
        ``sample_meta(data, round_idx, meta_batch, sample)`` overrides the
        D_meta sampling (default: ``data.sample_meta`` when ``fed.meta``,
        else None); ``on_records(recs, trainer)`` is called after every
        chunk of ``rounds_per_call`` rounds with its records.  Returns
        this call's records (also appended to ``self.history`` and fed to
        the tracker).  ``tracker=`` overrides the trainer's sink for this
        call; ``log_every`` composes a ``console`` tracker in.  The
        trackers this call builds are finished before it returns."""
        share = self.fed.share if share is None else share
        owned: List[Any] = []
        trk = self.tracker
        if tracker is not None and self.is_main:
            trk = resolve_tracker(tracker, run_dir=self.run_dir, owned=owned)
        if log_every and self.is_main:
            console = ConsoleTracker(every=log_every, log_fn=log_fn)
            owned.append(console)
            trk = CompositeTracker([trk, console])
        try:
            return self._run_tracked(
                data, trk, rounds=rounds, cohort=cohort, batch=batch,
                meta_batch=meta_batch, share=share, sample_meta=sample_meta,
                on_records=on_records)
        finally:
            for t in owned:
                t.finish()

    def _run_tracked(self, data: FederatedData, trk, *, rounds: int,
                     cohort: int, batch: int, meta_batch: int, share: bool,
                     sample_meta: Optional[Callable],
                     on_records: Optional[Callable]
                     ) -> List[Dict[str, Any]]:
        f = resolve_faults(self.fed)
        retry_on = (self.fed.retry_backoff > 0 and f.active
                    and (f.crash > 0 or f.drop > 0 or f.deadline > 0))
        run_history: List[Dict[str, Any]] = []
        loop_s, rounds_measured = 0.0, 0
        trk.log_event("run_start", {
            "start_round": self.round, "rounds": rounds,
            "final_round": rounds - 1, "cohort": cohort, "batch": batch,
            "rounds_per_call": self.rounds_per_call})
        while self.round < rounds:
            r = self.round
            k = min(self.rounds_per_call, rounds - r)
            with span(trk, "sample_stack", round=r, k=k):
                due = [self._retry_due.pop(r + j, None) if retry_on
                       else None for j in range(k)]
                samples = [data.sample_round(r + j, cohort=cohort,
                                             batch=batch, share=share,
                                             include=due[j])
                           for j in range(k)]
                if sample_meta is not None:
                    metas = [sample_meta(data, r + j, meta_batch,
                                         samples[j]) for j in range(k)]
                else:
                    metas = [data.sample_meta(r + j, meta_batch)
                             if self.fed.meta else None for j in range(k)]
                draws = [self.draw_round(r + j, cohort) if self._draws
                         else None for j in range(k)]
                staged = self._stage(samples, metas, draws)
            if self._roofline and k not in self._roofline_events:
                self._prepare_roofline(k, staged)
            self.profiler.maybe_start(r, k)
            # a sanitized chunk's probes are read once, after its sync
            with (probe_log() if self._sanitize
                  else contextlib.nullcontext()):
                with span(trk, "dispatch", round=r, k=k) as sp_d, \
                        self._phase_annotation("dispatch"):
                    # the chunk's k rounds as one call; the metrics stay
                    # where the round left them until the records
                    self.state, metrics = self._cache(k)(self.state,
                                                         *staged)
                with span(trk, "device_sync", round=r, k=k) as sp_s, \
                        self._phase_annotation("device_sync"):
                    if self.device.type == "cuda":
                        torch.cuda.synchronize(self.device)
            loop_s += sp_d["dur_s"] + sp_s["dur_s"]
            rounds_measured += k
            was_profiling = self.profiler.active
            self.profiler.maybe_stop(r + k)
            if was_profiling and not self.profiler.active:
                self._emit_trace_summary(trk)
            recs = self._records(k, metrics)
            if retry_on:
                self._schedule_retries(samples, draws, recs, due, r, k)
            for j, rec in enumerate(recs):
                rec["round"] = r + j
                run_history.append(rec)
                self.history.append(rec)
                trk.log_metrics(r + j, rec)
            if on_records is not None:
                on_records(recs, self)
            if self.manager is not None and self._ckpt_every \
                    and (r + k) // self._ckpt_every > r // self._ckpt_every:
                with span(trk, "checkpoint", round=r + k - 1):
                    self._save_managed(r + k)
        if self.manager is not None and self._last_managed_step != self.round:
            with span(trk, "checkpoint", round=self.round - 1):
                self._save_managed(self.round)
        if self._roofline:
            self._emit_roofline(trk, loop_s, rounds_measured)
        trk.log_event("run_finish", {"final_round": rounds - 1,
                                     "rounds_completed": len(run_history)})
        return run_history


def _record_value(v):
    """A metric as a record holds it: a float, or a list for a vector."""
    a = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)
    return float(a) if a.ndim == 0 else a.astype(float).tolist()
