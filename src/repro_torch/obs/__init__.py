"""Observability subsystem — the fifth plugin registry, plus analysis
(PyTorch port of ``repro/obs``).

``repro_torch.obs`` is where runs report what happened: pluggable
:class:`MetricsTracker` sinks for per-round metrics and events
(``noop`` / ``console`` / ``jsonl`` / ``csv`` / ``composite`` built in,
``tensorboard`` behind an optional-dependency gate,
:func:`register_tracker` for plugins), host-side phase :func:`span`
timing, the :class:`RoundProfiler` capturing a ``torch.profiler`` trace
for a round window, and the documented round-metrics schema
(:func:`round_metric_keys`).

On top of that sit trace analytics (:mod:`repro_torch.obs.trace_analysis`
— per-op self time, busy/gap, phase attribution, streamed as
``profile_summary`` events) and the cross-run regression watch
(:mod:`repro_torch.obs.regress`, CLI ``python -m repro_torch.obs
report|compare``).  Wired through ``FederatedTrainer(tracker=...,
run_dir=..., profile=..., trace_summary=...)`` and ``train.py
--tracker/--run-dir/--profile/--profile-start/--trace-summary``.

Everything but the profiler is stdlib: :class:`RoundProfiler` (which
imports torch) loads on first use, so ``import repro_torch.obs`` stays
cheap.
"""
from repro_torch.obs.regress import (Tolerances, compare_bench_files,
                                     compare_run_dirs, summarize_run)
from repro_torch.obs.schema import (PROFILE_SUMMARY_EVENT_KEYS,
                                    ROOFLINE_EVENT_KEYS, VECTOR_METRICS,
                                    round_metric_keys)
from repro_torch.obs.trace_analysis import (emit_profile_summary,
                                            find_trace_file,
                                            summarize_trace)
from repro_torch.obs.trackers import (CompositeTracker, ConsoleTracker,
                                      CsvTracker, JsonlTracker,
                                      MetricsTracker, NoopTracker,
                                      TensorBoardTracker,
                                      available_trackers, get_tracker,
                                      register_tracker, resolve_tracker,
                                      span)

__all__ = ["MetricsTracker", "NoopTracker", "ConsoleTracker",
           "JsonlTracker", "CsvTracker", "CompositeTracker",
           "TensorBoardTracker", "register_tracker", "get_tracker",
           "available_trackers", "resolve_tracker", "span",
           "RoundProfiler", "round_metric_keys", "VECTOR_METRICS",
           "ROOFLINE_EVENT_KEYS", "PROFILE_SUMMARY_EVENT_KEYS",
           "summarize_trace", "find_trace_file", "emit_profile_summary",
           "summarize_run", "compare_run_dirs", "compare_bench_files",
           "Tolerances"]


def __getattr__(name):
    if name == "RoundProfiler":
        from repro_torch.obs.profiler import RoundProfiler
        return RoundProfiler
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
