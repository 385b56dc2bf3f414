"""Trace analytics — the profiler's answers without opening a trace UI
(PyTorch port of ``repro/obs/trace_analysis.py``; stdlib only).

:class:`~repro_torch.obs.profiler.RoundProfiler` (``--profile N``) writes
the window's ``torch.profiler`` capture with ``export_chrome_trace``
(``<run_dir>/profile/*.pt.trace.json``): Chrome-trace JSON whose ``"X"``
events carry ``ts`` and ``dur`` in microseconds, as the XLA capture's do.
This module parses it into the numbers a regression hunt needs:

  * per-op **self time** — duration minus nested children on the same
    (pid, tid) lane — aggregated by op name into a top-K table;
  * **busy vs gap** time: the union of op intervals vs the op stream's
    wall window (a growing gap = the host not feeding the device, not
    slower kernels);
  * **per-phase attribution**: while the capture is open the trainer
    wraps dispatch / device-sync in
    ``torch.profiler.record_function("repro.phase.<name>")`` (the trace
    twin of the tracker's ``span()`` events), so each op's self time is
    credited to the phase window(s) overlapping it.  Ops outside every
    window land in ``_unattributed`` rather than disappearing.

The op stream is the device's: the events whose category is ``kernel``,
``gpu_memcpy`` or ``gpu_memset`` (or, in an XLA capture, the JAX
package's rows).  A trace without them (a CPU run) falls back to the
host's ``cpu_op`` events.  The phase windows are the host's
``user_annotation`` ranges; the profiler's device-side copy of each
(``gpu_user_annotation``) is skipped, since it would credit the same
kernels to the same phase twice.  The rest is the JAX package's code.

:func:`emit_profile_summary` streams the result into the active tracker
as a ``profile_summary`` event (keys pinned by
``repro_torch.obs.schema.PROFILE_SUMMARY_EVENT_KEYS``) — that is how
``train.py --profile N --trace-summary`` lands in ``metrics.jsonl``.
"""
from __future__ import annotations

import glob
import gzip
import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = ["PHASE_PREFIX", "load_trace", "find_trace_file", "op_events",
           "phase_windows", "self_times", "interval_union_us", "summarize",
           "summarize_trace", "emit_profile_summary"]

# record_function prefix the trainer uses while the profiler is active;
# the suffix is the span() phase name (dispatch / device_sync)
PHASE_PREFIX = "repro.phase."

# the device stream's event categories in a torch.profiler Chrome trace,
# the host's operator category, and the device-side twin of a
# record_function range
DEVICE_CATS = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})
HOST_OP_CAT = "cpu_op"
DEVICE_ANNOTATION_CAT = "gpu_user_annotation"


def load_trace(path: str) -> Dict[str, Any]:
    """Chrome-trace JSON, gzipped (``.trace.json.gz``) or plain."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt", encoding="utf-8") as f:
        return json.load(f)


def find_trace_file(root: str) -> Optional[str]:
    """Newest ``*.trace.json(.gz)`` under ``root`` — a run dir, the
    profiler's ``<run_dir>/profile`` dir, or a direct file path.  The
    port's profiler writes ``*.pt.trace.json`` there (torch's own
    suffix), which the first pattern's plain form matches."""
    if os.path.isfile(root):
        return root
    hits: List[str] = []
    for pat in ("*.trace.json.gz", "*.trace.json"):
        hits += glob.glob(os.path.join(root, "**", pat), recursive=True)
    return max(hits, key=os.path.getmtime) if hits else None


def _complete_events(trace: Dict[str, Any]) -> List[dict]:
    """Chrome ``"X"`` (complete) events with a ts + dur, the only kind
    that carries an interval."""
    return [e for e in trace.get("traceEvents", ())
            if isinstance(e, dict) and e.get("ph") == "X"
            and isinstance(e.get("ts"), (int, float))
            and isinstance(e.get("dur"), (int, float))]


def op_events(trace: Dict[str, Any]) -> List[dict]:
    """The device op stream, the first of these that is not empty:

      1. complete events of a torch device category
         (:data:`DEVICE_CATS`: kernels, copies, fills);
      2. complete events tagged with an ``hlo_op`` arg (XLA's per-op
         rows: the JAX package's captures read the same here);
      3. every complete event on a device-named process (XLA backends
         that tag nothing);
      4. the host's ``cpu_op`` events (a CPU-only torch capture).

    Our own phase annotations are never ops."""
    evs = [e for e in _complete_events(trace)
           if not str(e.get("name", "")).startswith(PHASE_PREFIX)]
    ops = [e for e in evs if e.get("cat") in DEVICE_CATS]
    if ops:
        return ops
    ops = [e for e in evs
           if isinstance(e.get("args"), dict) and "hlo_op" in e["args"]]
    if ops:
        return ops
    dev = {e.get("pid") for e in trace.get("traceEvents", ())
           if isinstance(e, dict) and e.get("ph") == "M"
           and e.get("name") == "process_name"
           and "device" in str((e.get("args") or {}).get("name", "")).lower()}
    ops = [e for e in evs if e.get("pid") in dev]
    if ops:
        return ops
    return [e for e in evs if e.get("cat") == HOST_OP_CAT]


def phase_windows(trace: Dict[str, Any]) -> List[Tuple[str, float, float]]:
    """``(phase, start_us, end_us)`` for every host-side ``repro.phase.*``
    annotation; one phase recurs once per profiled chunk."""
    out = []
    for e in _complete_events(trace):
        name = str(e.get("name", ""))
        if name.startswith(PHASE_PREFIX) \
                and e.get("cat") != DEVICE_ANNOTATION_CAT:
            ts = float(e["ts"])
            out.append((name[len(PHASE_PREFIX):], ts, ts + float(e["dur"])))
    out.sort(key=lambda w: (w[1], w[0]))
    return out


def self_times(events: Sequence[dict]) -> List[float]:
    """Per-event self time (us), aligned with ``events``: each event's
    duration minus its direct children's durations on the same
    (pid, tid) lane.  Chrome complete events nest by containment, so a
    start-time sweep with an open-interval stack recovers the tree."""
    selfs = [float(e["dur"]) for e in events]
    lanes: Dict[Tuple[Any, Any], List[int]] = {}
    for i, e in enumerate(events):
        lanes.setdefault((e.get("pid"), e.get("tid")), []).append(i)
    for idx in lanes.values():
        idx.sort(key=lambda i: (float(events[i]["ts"]),
                                -float(events[i]["dur"])))
        stack: List[Tuple[float, int]] = []      # (end_us, event index)
        for i in idx:
            ts = float(events[i]["ts"])
            dur = float(events[i]["dur"])
            while stack and stack[-1][0] <= ts:
                stack.pop()
            if stack:
                selfs[stack[-1][1]] -= dur
            stack.append((ts + dur, i))
    return [max(s, 0.0) for s in selfs]


def interval_union_us(events: Sequence[dict]) -> float:
    """Total covered microseconds of the events' merged intervals."""
    iv = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                for e in events)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in iv:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def summarize(trace: Dict[str, Any], top_k: int = 15) -> Dict[str, Any]:
    """One trace -> one ``profile_summary`` payload (sans the ``trace``
    path :func:`summarize_trace` adds)."""
    evs = _complete_events(trace)
    ops = op_events(trace)
    selfs = self_times(ops)
    windows = phase_windows(trace)

    agg: Dict[str, List[float]] = {}
    for e, s in zip(ops, selfs):
        a = agg.setdefault(str(e.get("name", "?")), [0.0, 0.0, 0])
        a[0] += s
        a[1] += float(e["dur"])
        a[2] += 1
    top = sorted(agg.items(), key=lambda kv: (-kv[1][0], kv[0]))[:top_k]

    phase: Dict[str, float] = {}
    for e, s in zip(ops, selfs):
        ts, dur = float(e["ts"]), float(e["dur"])
        end, covered = ts + dur, 0.0
        for name, ws, we in windows:
            ov = min(end, we) - max(ts, ws)
            if ov > 0 and dur > 0:
                phase[name] = phase.get(name, 0.0) + s * (ov / dur)
                covered += ov
        if dur > covered:
            phase["_unattributed"] = phase.get("_unattributed", 0.0) \
                + s * ((dur - covered) / dur)

    wall = busy = 0.0
    if ops:
        t0 = min(float(e["ts"]) for e in ops)
        t1 = max(float(e["ts"]) + float(e["dur"]) for e in ops)
        wall = t1 - t0
        busy = interval_union_us(ops)
    return {
        "top_k": int(top_k),
        "n_events": len(evs),
        "n_op_events": len(ops),
        "n_ops": len(agg),
        "wall_us": round(wall, 3),
        "busy_us": round(busy, 3),
        "gap_us": round(max(wall - busy, 0.0), 3),
        "busy_frac": round(busy / wall, 6) if wall > 0 else 0.0,
        "total_self_us": round(sum(selfs), 3),
        "top_ops": [{"op": n, "self_us": round(v[0], 3),
                     "total_us": round(v[1], 3), "count": int(v[2])}
                    for n, v in top],
        "phase_self_us": {n: round(v, 3) for n, v in sorted(phase.items())},
    }


def summarize_trace(path: str, top_k: int = 15) -> Dict[str, Any]:
    out = summarize(load_trace(path), top_k=top_k)
    out["trace"] = path
    return out


def emit_profile_summary(tracker, root: Optional[str],
                         top_k: int = 15) -> Optional[Dict[str, Any]]:
    """Summarize the newest trace under ``root`` into the tracker as a
    ``profile_summary`` event; returns the payload, or None when no
    trace file exists (nothing captured yet)."""
    path = find_trace_file(root) if root else None
    if path is None:
        return None
    summary = summarize_trace(path, top_k=top_k)
    tracker.log_event("profile_summary", summary)
    return summary
