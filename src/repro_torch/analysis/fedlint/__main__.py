"""``python -m repro_torch.analysis.fedlint <paths...>``: run all passes
and exit 1 if anything is found."""
from __future__ import annotations

import argparse
import sys

from repro_torch.analysis.fedlint.core import format_findings, run_fedlint


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.fedlint",
        description="the port's static analysis: rng-tag discipline, "
                    "kernel wrapper / oracle contracts, registry "
                    "capability surfaces, host reads in round bodies")
    ap.add_argument("paths", nargs="+",
                    help="files or directories to analyze (e.g. "
                         "src/repro_torch)")
    args = ap.parse_args(argv)
    findings = run_fedlint(args.paths)
    if findings:
        print(format_findings(findings))
        print(f"fedlint: {len(findings)} finding(s)", file=sys.stderr)
        return 1
    print("fedlint: clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
