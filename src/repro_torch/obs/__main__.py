"""``python -m repro_torch.obs <subcommand>`` — observability CLI front door.

  report   summarize a run dir's metrics.jsonl (repro_torch.obs.report)
  compare  regression-diff two run dirs / BENCH files (repro_torch.obs.compare)

Both are also runnable directly (``python -m repro_torch.obs.report`` /
``python -m repro_torch.obs.compare``).
"""
from __future__ import annotations

import sys


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__.strip())
        return 0 if argv else 2
    cmd, rest = argv[0], argv[1:]
    if cmd == "report":
        from repro_torch.obs.report import main as sub
        return sub(rest)
    if cmd == "compare":
        from repro_torch.obs.compare import main as sub
        return sub(rest)
    print(f"unknown subcommand {cmd!r}; expected 'report' or 'compare'",
          file=sys.stderr)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
