"""``python -m repro_torch.obs report <run_dir>`` — a run at a glance.

Pretty-prints the jsonl tracker's ``metrics.jsonl`` as the summary
:func:`repro_torch.obs.regress.summarize_run` computes: loss figures,
rounds/s from the dispatch + device-sync spans, per-phase span totals, comm-bytes
totals, event counts, and — when the run emitted them — the roofline
prediction and the profiled top ops.  No jq, no trace UI.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from repro_torch.obs.regress import summarize_run

__all__ = ["format_run_report", "main"]


def _fmt_bytes(n) -> str:
    if n is None:
        return "-"
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024 or unit == "TiB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024
    return f"{n:.1f} TiB"


def _row(label: str, value) -> str:
    return f"  {label:<24} {value}"


def format_run_report(s: dict) -> str:
    lines: List[str] = [f"run report: {s['run_dir']}", ""]
    lines.append(_row("rounds", s["rounds"]))
    for k in ("final_loss", "mean_loss", "min_loss"):
        v = s[k]
        lines.append(_row(k, f"{v:.6f}" if v is not None else "-"))
    rps = s["rounds_per_s"]
    lines.append(_row("rounds_per_s",
                      f"{rps:.3f} (from dispatch+device_sync spans)"
                      if rps is not None else "- (no spans logged)"))
    lines.append(_row("comm_bytes_total", _fmt_bytes(s["comm_bytes"])))
    lines.append(_row("peak_temp_bytes", _fmt_bytes(s["peak_temp_bytes"])))
    if s["phase_s"]:
        lines.append("")
        lines.append("  phase span totals:")
        for p, v in s["phase_s"].items():
            lines.append(f"    {p:<22} {v:10.4f} s")
    if s["event_counts"]:
        lines.append("")
        lines.append("  events: " + ", ".join(
            f"{k}x{v}" for k, v in s["event_counts"].items()))
    rl = s.get("roofline")
    if rl:
        lines.append("")
        lines.append("  roofline (per compiled round):")
        for k in ("rounds_per_call", "bottleneck", "flops_per_round",
                  "bytes_per_round", "collective_bytes_per_round",
                  "predicted_rounds_per_s", "measured_rounds_per_s",
                  "loop_ratio"):
            if k in rl:
                v = rl[k]
                lines.append(f"    {k:<26} "
                             + (f"{v:.6g}" if isinstance(v, float)
                                else str(v)))
    if s.get("n_profile_summaries"):
        lines.append("")
        lines.append(f"  profile summaries: {s['n_profile_summaries']} "
                     "(see profile_summary events in metrics.jsonl)")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs report",
        description="Summarize a run dir's metrics.jsonl.")
    ap.add_argument("run_dir")
    ap.add_argument("--json", action="store_true",
                    help="emit the raw summary dict as JSON instead")
    args = ap.parse_args(argv)
    try:
        s = summarize_run(args.run_dir)
    except FileNotFoundError as e:
        print(f"[report] {e}", file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(s, indent=1))
    else:
        print(format_run_report(s))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
