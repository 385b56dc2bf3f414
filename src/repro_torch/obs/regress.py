"""Cross-run regression watch — two runs in, deltas and a verdict out.

A perf regression used to surface only when someone opened a perfetto
trace by hand.  This module makes runs self-comparing: it summarizes a
run dir's ``metrics.jsonl`` (or a ``BENCH_*.json`` verdict file) into
the handful of numbers that matter — rounds/s from the dispatch +
device-sync spans, per-phase span totals, loss, comm bytes, peak temp
memory from the ``roofline`` event — and diffs two of them against
directional relative tolerances:

  * throughput (``rounds_per_s``, any ``*_per_s`` / ``*speedup`` bench
    leaf) may only DROP by the perf tolerance;
  * phase totals, final loss, and peak temp bytes may only GROW;
  * comm bytes are two-sided (the uplink payload is deterministic —
    movement either way means the codec/schema changed);
  * boolean bench gates (``pass_*`` / ``gates``) are strict: a
    true -> false flip is always a breach, whatever the tolerances.

Schema misalignment — different ``round_metric_keys`` sets, different
round counts, a ``meta`` stamp naming a different bench/config — is a
*refusal*, not a pass or a breach: comparing apples to oranges exits 2
with a message naming the mismatched field.  The CLI wrapper is
``python -m repro_torch.obs.compare BASE CAND`` (see
``repro_torch.obs.compare``).  A stdlib copy of ``repro/obs/regress.py``:
the one difference is that a bench file's ``torch_version`` drift warns
where the JAX package's warns on ``jax_version``.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Iterable, List, Optional, Tuple

__all__ = ["Tolerances", "Delta", "read_jsonl", "summarize_run",
           "compare_run_dirs", "compare_bench_files"]

OK, INFO, WARN, BREACH, REFUSE = "ok", "info", "warn", "BREACH", "REFUSE"


@dataclasses.dataclass
class Tolerances:
    """Relative tolerances, all as fractions (0.25 = 25%).  Defaults are
    loose enough for shared CI runners; tighten locally."""
    perf_rel: float = 0.25     # rounds/s (and bench *_per_s) may drop this
    phase_rel: float = 0.25    # per-phase span totals may grow this
    loss_rel: float = 0.02     # final loss may grow this
    bytes_rel: float = 0.01    # comm_bytes delta, two-sided
    mem_rel: float = 0.10      # peak temp bytes may grow this
    pct_points: float = 10.0   # *_pct bench leaves: absolute points
    phase_abs_s: float = 0.05  # additive slack for near-zero phase totals


@dataclasses.dataclass
class Delta:
    name: str
    base: Any
    cand: Any
    status: str                # ok / info / warn / BREACH / REFUSE
    note: str = ""

    def format(self) -> str:
        return f"[{self.status:>6}] {self.name}: base={self.base!r} " \
               f"cand={self.cand!r}" + (f" — {self.note}" if self.note
                                        else "")


def read_jsonl(path: str) -> List[dict]:
    out = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def summarize_run(run_dir: str) -> Dict[str, Any]:
    """One run dir -> the comparison summary.  Reads the jsonl tracker's
    ``metrics.jsonl`` (records + events); raises FileNotFoundError with
    a hint when the run was not jsonl-tracked."""
    path = os.path.join(run_dir, "metrics.jsonl")
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"{path} not found — regression compare reads the jsonl "
            "tracker's output; run with --tracker jsonl --run-dir "
            f"{run_dir!r} (or point at a dir that has one)")
    records, events = [], []
    for rec in read_jsonl(path):
        (records if rec.get("kind") == "metrics" else events).append(rec)

    metric_keys: set = set()
    for r in records:
        metric_keys |= set(r) - {"kind"}
    losses = [r["client_loss"] for r in records if "client_loss" in r]

    phase_s: Dict[str, float] = {}
    event_counts: Dict[str, int] = {}
    roofline: Optional[dict] = None
    n_profile_summaries = 0
    for e in events:
        name = e.get("event", "?")
        event_counts[name] = event_counts.get(name, 0) + 1
        if name == "phase":
            p = e.get("phase", "?")
            phase_s[p] = phase_s.get(p, 0.0) + float(e.get("dur_s", 0.0))
        elif name == "roofline":
            roofline = e                    # keep the newest
        elif name == "profile_summary":
            n_profile_summaries += 1

    loop_s = phase_s.get("dispatch", 0.0) + phase_s.get("device_sync", 0.0)
    comm = None
    if "comm_bytes" in metric_keys:
        comm = sum(float(r.get("comm_bytes", 0.0)) for r in records)
    peak = None
    if roofline is not None:
        peak = (roofline.get("memory") or {}).get("temp_size_in_bytes")
    return {
        "run_dir": run_dir,
        "rounds": len(records),
        "metric_keys": sorted(metric_keys),
        "final_loss": losses[-1] if losses else None,
        "mean_loss": sum(losses) / len(losses) if losses else None,
        "min_loss": min(losses) if losses else None,
        "phase_s": {k: round(v, 6) for k, v in sorted(phase_s.items())},
        "rounds_per_s": (len(records) / loop_s) if loop_s > 0 else None,
        "comm_bytes": comm,
        "peak_temp_bytes": peak,
        "event_counts": dict(sorted(event_counts.items())),
        "n_profile_summaries": n_profile_summaries,
        "roofline": roofline,
    }


def _code(deltas: Iterable[Delta]) -> int:
    statuses = {d.status for d in deltas}
    if REFUSE in statuses:
        return 2
    return 1 if BREACH in statuses else 0


# ---------------------------------------------------------------------------
# run-dir mode
# ---------------------------------------------------------------------------
def compare_run_dirs(base_dir: str, cand_dir: str,
                     tol: Optional[Tolerances] = None
                     ) -> Tuple[int, List[Delta]]:
    tol = tol or Tolerances()
    b, c = summarize_run(base_dir), summarize_run(cand_dir)
    deltas: List[Delta] = []

    if b["metric_keys"] != c["metric_keys"]:
        only_b = sorted(set(b["metric_keys"]) - set(c["metric_keys"]))
        only_c = sorted(set(c["metric_keys"]) - set(b["metric_keys"]))
        deltas.append(Delta(
            "metric_keys", b["metric_keys"], c["metric_keys"], REFUSE,
            f"round_metric_keys schema differs (base-only: {only_b}, "
            f"cand-only: {only_c}) — different configs are not comparable"))
        return 2, deltas
    if b["rounds"] != c["rounds"]:
        deltas.append(Delta(
            "rounds", b["rounds"], c["rounds"], REFUSE,
            "different round counts — loss/throughput horizons differ"))
        return 2, deltas

    def rel(base, cand):
        return (cand - base) / abs(base) if base else 0.0

    # throughput: lower is a regression
    rb, rc = b["rounds_per_s"], c["rounds_per_s"]
    if rb is not None and rc is not None:
        drop = -rel(rb, rc)
        deltas.append(Delta(
            "rounds_per_s", round(rb, 4), round(rc, 4),
            BREACH if drop > tol.perf_rel else OK,
            f"{drop:+.1%} drop vs {tol.perf_rel:.0%} tol"))
    else:
        deltas.append(Delta("rounds_per_s", rb, rc, INFO,
                            "no dispatch/device_sync spans in one run"))

    # per-phase totals: growth is a regression
    for p in sorted(set(b["phase_s"]) | set(c["phase_s"])):
        pb = b["phase_s"].get(p, 0.0)
        pc = c["phase_s"].get(p, 0.0)
        limit = pb * (1.0 + tol.phase_rel) + tol.phase_abs_s
        deltas.append(Delta(
            f"phase_s.{p}", round(pb, 4), round(pc, 4),
            BREACH if pc > limit else OK,
            f"limit {limit:.4f}s ({tol.phase_rel:.0%} + "
            f"{tol.phase_abs_s}s slack)"))

    # final loss: growth is a regression (numerics, so a tight default)
    lb, lc = b["final_loss"], c["final_loss"]
    if lb is not None and lc is not None:
        limit = lb + abs(lb) * tol.loss_rel
        deltas.append(Delta(
            "final_loss", round(lb, 6), round(lc, 6),
            BREACH if lc > limit + 1e-12 else OK,
            f"limit {limit:.6f} ({tol.loss_rel:.1%})"))
    for k in ("mean_loss", "min_loss"):
        if b[k] is not None and c[k] is not None:
            deltas.append(Delta(k, round(b[k], 6), round(c[k], 6), INFO))

    # comm bytes: deterministic payload — two-sided
    cb, cc = b["comm_bytes"], c["comm_bytes"]
    if cb is not None and cc is not None:
        deltas.append(Delta(
            "comm_bytes", cb, cc,
            BREACH if abs(cc - cb) > tol.bytes_rel * max(abs(cb), 1.0)
            else OK, f"two-sided {tol.bytes_rel:.1%} tol"))

    # peak temp memory from the roofline event: growth is a regression
    mb, mc = b["peak_temp_bytes"], c["peak_temp_bytes"]
    if mb is not None and mc is not None:
        deltas.append(Delta(
            "peak_temp_bytes", mb, mc,
            BREACH if mc > mb * (1.0 + tol.mem_rel) else OK,
            f"{tol.mem_rel:.0%} growth tol"))
    elif mb is not None or mc is not None:
        deltas.append(Delta("peak_temp_bytes", mb, mc, INFO,
                            "roofline event present in only one run"))
    return _code(deltas), deltas


# ---------------------------------------------------------------------------
# bench-file mode
# ---------------------------------------------------------------------------
_HIGHER_BETTER = ("per_s", "speedup", "throughput_ratio", "relative")
_LOWER_BETTER_S = ("wall_s", "lower_s", "compile_s")


def _classify_leaf(name: str) -> str:
    leaf = name.rsplit(".", 1)[-1]
    if any(t in leaf for t in _HIGHER_BETTER):
        return "higher_better"
    if leaf.endswith("_pct"):
        return "pct"
    if any(t in leaf for t in _LOWER_BETTER_S):
        return "lower_better"
    if "bytes" in leaf:
        return "bytes"
    return "info"


def _walk(name: str, b: Any, c: Any, deltas: List[Delta],
          tol: Tolerances) -> None:
    if isinstance(b, dict) and isinstance(c, dict):
        for k in sorted(set(b) | set(c)):
            sub = f"{name}.{k}" if name else str(k)
            if k not in b or k not in c:
                deltas.append(Delta(sub, b.get(k, "<absent>"),
                                    c.get(k, "<absent>"), REFUSE,
                                    "key present in only one report — "
                                    "bench schema drift"))
                continue
            _walk(sub, b[k], c[k], deltas, tol)
        return
    if isinstance(b, bool) and isinstance(c, bool):
        if b and not c:
            deltas.append(Delta(name, b, c, BREACH,
                                "gate flipped true -> false"))
        elif c and not b:
            deltas.append(Delta(name, b, c, INFO, "gate now passes"))
        return
    if isinstance(b, (int, float)) and isinstance(c, (int, float)):
        kind = _classify_leaf(name)
        if kind == "higher_better":
            drop = (b - c) / abs(b) if b else 0.0
            if drop > tol.perf_rel:
                deltas.append(Delta(name, b, c, BREACH,
                                    f"{drop:+.1%} drop vs "
                                    f"{tol.perf_rel:.0%} tol"))
        elif kind == "lower_better":
            grow = (c - b) / abs(b) if b else 0.0
            if grow > tol.perf_rel:
                deltas.append(Delta(name, b, c, BREACH,
                                    f"{grow:+.1%} growth vs "
                                    f"{tol.perf_rel:.0%} tol"))
        elif kind == "pct":
            if c - b > tol.pct_points:
                deltas.append(Delta(name, b, c, BREACH,
                                    f"+{c - b:.2f} points vs "
                                    f"{tol.pct_points} tol"))
        elif kind == "bytes":
            if abs(c - b) > tol.bytes_rel * max(abs(b), 1.0):
                deltas.append(Delta(name, b, c, BREACH,
                                    f"two-sided {tol.bytes_rel:.1%} tol"))
        return                               # other numerics: gates own them
    if isinstance(b, (list, tuple)) and isinstance(c, (list, tuple)):
        if len(b) != len(c):
            deltas.append(Delta(name, f"len {len(b)}", f"len {len(c)}",
                                REFUSE, "sequence length differs — "
                                "bench schema drift"))
        return
    if b != c:
        deltas.append(Delta(name, b, c, REFUSE,
                            "non-numeric value differs — bench schema "
                            "drift"))


def compare_bench_files(base_path: str, cand_path: str,
                        tol: Optional[Tolerances] = None,
                        ignore_config: Iterable[str] = ()
                        ) -> Tuple[int, List[Delta]]:
    """Diff two ``BENCH_*.json`` verdict files.  The ``meta`` stamp
    (``benchmarks.common.write_bench_report``) guards apples-to-oranges:
    a different ``bench`` name or any differing ``config`` key (unless
    listed in ``ignore_config``) refuses with exit 2; host/torch_version
    drift only warns (that is exactly what CI compares across)."""
    tol = tol or Tolerances()
    ignore = set(ignore_config)
    with open(base_path, encoding="utf-8") as f:
        base = json.load(f)
    with open(cand_path, encoding="utf-8") as f:
        cand = json.load(f)
    deltas: List[Delta] = []

    bmeta, cmeta = base.pop("meta", None), cand.pop("meta", None)
    if bmeta is None or cmeta is None:
        deltas.append(Delta("meta", bool(bmeta), bool(cmeta), WARN,
                            "missing meta stamp (pre-unification bench "
                            "file) — comparing bodies unchecked"))
    else:
        if bmeta.get("bench") != cmeta.get("bench"):
            deltas.append(Delta("meta.bench", bmeta.get("bench"),
                                cmeta.get("bench"), REFUSE,
                                "different benchmarks are not comparable"))
            return 2, deltas
        bcfg = bmeta.get("config") or {}
        ccfg = cmeta.get("config") or {}
        for k in sorted(set(bcfg) | set(ccfg)):
            if k in ignore:
                continue
            if bcfg.get(k) != ccfg.get(k):
                deltas.append(Delta(
                    f"meta.config.{k}", bcfg.get(k), ccfg.get(k), REFUSE,
                    "bench configs differ — pass --ignore-config "
                    f"{k} to compare anyway"))
        if any(d.status == REFUSE for d in deltas):
            return 2, deltas
        for k in ("host", "torch_version"):
            if bmeta.get(k) != cmeta.get(k):
                deltas.append(Delta(f"meta.{k}", bmeta.get(k),
                                    cmeta.get(k), WARN,
                                    "environment differs — perf deltas "
                                    "are cross-machine"))
    # the body's own benchmark/config copies are covered by the meta
    # check above (and would re-refuse under --ignore-config otherwise)
    for rep in (base, cand):
        if bmeta is not None and cmeta is not None:
            rep.pop("benchmark", None)
            rep.pop("config", None)
    _walk("", base, cand, deltas, tol)
    return _code(deltas), deltas
