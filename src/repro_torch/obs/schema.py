"""The round-metrics schema — which keys a tracker will see, per config
(PyTorch port of ``repro/obs/schema.py``, over the port's ``FedConfig``,
``sim/faults.py`` and ``comm/codecs.py``).

A round builds ONE metrics dict per config (K-round calls stack the same
keys round after round), so the key set is a pure function of
:class:`~repro_torch.configs.base.FedConfig`.  This module states that
function in one place, so trackers (and anything downstream — the csv
header, dashboards) can rely on the documented names instead of probing.

Key catalog
-----------

Always (sync and async):
  ``round``        host round index (added by the trainer)
  ``client_loss``  cohort-weighted mean local loss
  ``grad_norm``    post-aggregation global gradient/delta norm

Sync rounds add:
  ``participants``   when ``participation < 1``
  ``arrivals`` / ``fault_crashed`` / ``fault_dropped``
                     when a fault profile is active
  ``fault_timeout``  when additionally ``round_deadline > 0``
  ``comm_bytes``     when the codec is lossy (measured uplink bytes)
  ``meta_loss``      when ``meta=True`` (post-aggregation FedMeta)
  ``ctrl_w_gnorm`` / ``ctrl_lr_grad`` / ``server_lr_eff``
                     additionally when ``meta_mode="through_aggregation"``

Async (``buffered_async``) ticks add:
  ``arrivals`` / ``server_steps`` / ``buffer_fill`` / ``overflow_dropped``
  ``staleness_mean`` / ``staleness_max``
  ``staleness_hist`` (a VECTOR — list in records — of
                     ``STALENESS_HIST_BINS`` counts)
  ``participants``   when ``participation < 1``
  ``fault_crashed`` / ``fault_dropped`` / ``fault_delayed``
                     when a fault profile is active
  ``expired``        when ``async_max_staleness > 0``
  ``comm_bytes``     when the codec is lossy
  ``meta_loss``      when ``meta=True``

The trainer adds:
  ``retried``        when the degradation policy is live
                     (``retry_backoff > 0`` and a loss-making fault
                     profile: crash, drop, or a round deadline)
"""
from __future__ import annotations

from typing import FrozenSet

from repro_torch.configs.base import FedConfig
from repro_torch.sim.faults import resolve_faults

__all__ = ["round_metric_keys", "VECTOR_METRICS",
           "ROOFLINE_EVENT_KEYS", "PROFILE_SUMMARY_EVENT_KEYS"]

# metrics whose per-round value is a vector (a list in records / jsonl,
# a JSON-encoded cell in csv) rather than a scalar float
VECTOR_METRICS: FrozenSet[str] = frozenset({"staleness_hist"})

# ---------------------------------------------------------------------------
# analysis-event schemas — the two structured events the JAX trainer emits
# beyond phase/profiler/checkpoint markers.  The jsonl tracker adds its
# envelope ("kind"/"event"/"t") on top of these payload keys.
# ---------------------------------------------------------------------------

# one per round function (trainer roofline=True; the JAX package: per
# compiled round program): the cost model's per-round prediction plus the
# measured rounds/s (repro_torch.roofline.live)
ROOFLINE_EVENT_KEYS: FrozenSet[str] = frozenset({
    "rounds_per_call", "flops_per_round", "bytes_per_round",
    "collective_bytes_per_round", "per_collective", "compute_s_per_round",
    "memory_s_per_round", "collective_s_per_round", "bottleneck",
    "predicted_rounds_per_s", "loop_ratio", "xla_flops", "memory",
    "analysis_s", "measured_rounds_per_s", "measured_s_per_round",
    "rounds_measured"})

# one per captured trace (trainer trace_summary=True): the top-K
# self-time table and busy/gap/phase attribution
# (repro_torch.obs.trace_analysis.summarize_trace), emitted by the port
# as by the JAX package
PROFILE_SUMMARY_EVENT_KEYS: FrozenSet[str] = frozenset({
    "trace", "top_k", "n_events", "n_op_events", "n_ops", "wall_us",
    "busy_us", "gap_us", "busy_frac", "total_self_us", "top_ops",
    "phase_self_us"})


def round_metric_keys(fed: FedConfig, *, trainer: bool = True
                      ) -> FrozenSet[str]:
    """The exact key set of one round record under ``fed``.

    ``trainer=True`` (default) describes :class:`FederatedTrainer`
    records — including ``round`` and the retry-policy counter;
    ``trainer=False`` describes the round function's own metrics.
    """
    faults = resolve_faults(fed)
    is_async = fed.engine == "buffered_async" \
        or fed.cohort_strategy == "buffered_async"
    keys = {"client_loss", "grad_norm"}
    if fed.participation < 1.0:
        keys.add("participants")

    if is_async:
        keys |= {"arrivals", "server_steps", "buffer_fill",
                 "overflow_dropped", "staleness_mean", "staleness_max",
                 "staleness_hist"}
        if faults.active:
            keys |= {"fault_crashed", "fault_dropped", "fault_delayed"}
        if int(getattr(fed, "async_max_staleness", 0)) > 0:
            keys.add("expired")
        if fed.meta:
            keys.add("meta_loss")
    else:
        if faults.active:
            keys |= {"arrivals", "fault_crashed", "fault_dropped"}
            if faults.deadline > 0:
                keys.add("fault_timeout")
        if fed.meta:
            keys.add("meta_loss")
            if fed.meta_mode == "through_aggregation":
                keys |= {"ctrl_w_gnorm", "ctrl_lr_grad", "server_lr_eff"}

    from repro_torch.comm.codecs import get_codec
    if get_codec(fed.codec).lossy:
        keys.add("comm_bytes")

    if trainer:
        keys.add("round")
        retry_on = (fed.retry_backoff > 0 and faults.active
                    and (faults.crash > 0 or faults.drop > 0
                         or faults.deadline > 0))
        if retry_on:
            keys.add("retried")
    return frozenset(keys)
