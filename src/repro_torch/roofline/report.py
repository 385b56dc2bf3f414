"""``python -m repro_torch.roofline.report <run_dir>`` — the roofline
view of an emitted run (PyTorch port of ``repro/roofline/report.py``).

Reads the jsonl tracker's ``metrics.jsonl`` and prints the ``roofline``
event(s) the trainer emitted (``roofline=True`` / ``train.py
--roofline``): predicted compute, memory and collective seconds per round
under the H100 SXM hardware model, the predicted bottleneck, and
predicted against measured rounds/s.  Exits 0 with events, 1 when the
run has none, 2 when the run directory has no ``metrics.jsonl``.
"""
from __future__ import annotations

import argparse
import os
from typing import List, Optional

from repro_torch.obs.regress import read_jsonl

__all__ = ["main"]


def _g(v, nd=4):
    if v is None:
        return "-"
    return f"{v:.{nd}g}" if isinstance(v, float) else str(v)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.roofline.report",
        description="Print the roofline event(s) from a run dir's "
                    "metrics.jsonl.")
    ap.add_argument("run_dir")
    args = ap.parse_args(argv)
    path = os.path.join(args.run_dir, "metrics.jsonl")
    if not os.path.isfile(path):
        print(f"{path} not found — run with --tracker jsonl --run-dir "
              f"{args.run_dir!r} --roofline")
        return 2
    events = [r for r in read_jsonl(path) if r.get("kind") == "event"]
    rooflines = [e for e in events if e.get("event") == "roofline"]
    if not rooflines:
        print(f"no roofline events in {path} — re-run with --roofline")
        return 1
    for ev in rooflines:
        k = ev.get("rounds_per_call", 1)
        print(f"roofline: rounds_per_call={k} "
              f"bottleneck={ev.get('bottleneck')} "
              f"(H100 SXM hardware model)")
        print(f"  per-round cost     flops={_g(ev.get('flops_per_round'))} "
              f"bytes={_g(ev.get('bytes_per_round'))} "
              f"collective={_g(ev.get('collective_bytes_per_round'))}")
        print(f"  predicted terms    compute={_g(ev.get('compute_s_per_round'))}s "
              f"memory={_g(ev.get('memory_s_per_round'))}s "
              f"collective={_g(ev.get('collective_s_per_round'))}s")
        print(f"  rounds/s           predicted={_g(ev.get('predicted_rounds_per_s'))} "
              f"measured={_g(ev.get('measured_rounds_per_s'))} "
              f"(over {ev.get('rounds_measured', '-')} rounds)")
        mem = ev.get("memory") or {}
        if mem:
            print("  memory_analysis    "
                  + " ".join(f"{a.replace('_size_in_bytes', '')}="
                             f"{v:,}" for a, v in sorted(mem.items())))
        pc = ev.get("per_collective") or {}
        if pc:
            print("  per-collective     "
                  + " ".join(f"{a}={_g(v)}" for a, v in sorted(pc.items())))
        print(f"  loop_ratio={_g(ev.get('loop_ratio'))} "
              f"xla_flops={_g(ev.get('xla_flops'))} "
              f"analysis_s={_g(ev.get('analysis_s'))}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
