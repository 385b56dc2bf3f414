"""``python -m repro_torch.obs.compare BASE CAND`` — the regression CLI.

BASE and CAND are either two run directories (each holding a jsonl
tracker's ``metrics.jsonl``) or two ``BENCH_*.json`` verdict files; the
mode is picked from what the paths are.  Exit codes:

  0  within tolerances
  1  regression breach (a throughput/phase/loss/bytes/memory delta past
     its tolerance, or a bench gate flipped true -> false)
  2  refusal — the two inputs are not comparable (schema / round-count /
     bench-config mismatch), named in the output

See :mod:`repro_torch.obs.regress` for the comparison semantics and
tolerance directions (a stdlib copy of ``repro/obs/compare.py``).
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

from repro_torch.obs.regress import (Tolerances, compare_bench_files,
                               compare_run_dirs)

__all__ = ["main"]


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.compare",
        description="Compare two run dirs (metrics.jsonl) or two "
                    "BENCH_*.json files; exit 1 on a regression breach, "
                    "2 on a schema refusal.")
    ap.add_argument("base", help="baseline run dir or BENCH_*.json")
    ap.add_argument("cand", help="candidate run dir or BENCH_*.json")
    ap.add_argument("--perf-rel-tol", type=float, default=0.25,
                    help="allowed fractional DROP in rounds/s and bench "
                         "*_per_s/speedup leaves (default 0.25)")
    ap.add_argument("--phase-rel-tol", type=float, default=0.25,
                    help="allowed fractional GROWTH per phase span total")
    ap.add_argument("--loss-rel-tol", type=float, default=0.02,
                    help="allowed fractional GROWTH in final loss")
    ap.add_argument("--bytes-rel-tol", type=float, default=0.01,
                    help="two-sided comm/bytes tolerance (deterministic "
                         "payloads — movement means the codec changed)")
    ap.add_argument("--mem-rel-tol", type=float, default=0.10,
                    help="allowed fractional GROWTH in peak temp bytes")
    ap.add_argument("--pct-tol", type=float, default=10.0,
                    help="allowed absolute growth of *_pct bench leaves "
                         "in percentage points")
    ap.add_argument("--ignore-config", action="append", default=[],
                    metavar="KEY",
                    help="bench meta.config key allowed to differ "
                         "(repeatable), e.g. --ignore-config fast")
    ap.add_argument("--quiet", action="store_true",
                    help="print breaches/refusals only")
    args = ap.parse_args(argv)

    tol = Tolerances(perf_rel=args.perf_rel_tol,
                     phase_rel=args.phase_rel_tol,
                     loss_rel=args.loss_rel_tol,
                     bytes_rel=args.bytes_rel_tol,
                     mem_rel=args.mem_rel_tol,
                     pct_points=args.pct_tol)

    both_files = os.path.isfile(args.base) and os.path.isfile(args.cand)
    both_dirs = os.path.isdir(args.base) and os.path.isdir(args.cand)
    if both_files:
        code, deltas = compare_bench_files(
            args.base, args.cand, tol, ignore_config=args.ignore_config)
        mode = "bench"
    elif both_dirs:
        code, deltas = compare_run_dirs(args.base, args.cand, tol)
        mode = "run-dir"
    else:
        print(f"[compare] REFUSE: {args.base!r} and {args.cand!r} must "
              "both be run directories or both be BENCH_*.json files",
              file=sys.stderr)
        return 2

    shown = 0
    for d in deltas:
        if args.quiet and d.status in ("ok", "info"):
            continue
        print("[compare] " + d.format())
        shown += 1
    n_breach = sum(d.status == "BREACH" for d in deltas)
    n_refuse = sum(d.status == "REFUSE" for d in deltas)
    verdict = ("NOT COMPARABLE" if code == 2
               else "REGRESSION" if code == 1 else "PASS")
    print(f"[compare] {mode} {args.base} vs {args.cand}: {verdict} "
          f"({len(deltas)} checks, {n_breach} breaches, "
          f"{n_refuse} refusals)")
    return code


if __name__ == "__main__":
    raise SystemExit(main())
