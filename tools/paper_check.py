"""A quick card check of the paper's own models: ``chip_smoke.py`` phases
3 and 5p at the paper models' flat shapes (rows 1-3 of the fused-update
kernels against their plain versions, then timed), 6p (the CIFAR CNN,
the FEMNIST CNN and the Shakespeare GRU at their published widths,
FedMeta w/ UGA through ``experiments/common.py::train_method``, launches
held to each cohort's; the FEMNIST CNN through all six methods) and 7p
(the CNN with dropout and the GRU at smoke size, the card against the
CPU).  This script calls ``chip_smoke.py``'s functions.

Run on one card from the repo's root::

    python3 tools/paper_check.py

It exits non-zero without a CUDA device or when a check fails.
"""
from __future__ import annotations

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("paper_check: no CUDA device available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.device import strict_fp32
    from repro_torch.kernels.comm import kernel as CK
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.fused_update import kernel as K
    from repro_torch.kernels.fused_update import ops as O
    from repro_torch.kernels.fused_update import ref as R
    from repro_torch.kernels.ssd_scan import kernel as SK

    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    strict_fp32()
    cs.log(cs.card_line())
    K.LIB.build(True)
    cs.log(K.LIB.build_log.strip())
    cs.check_kernels(K, R, O, dev, list(cs.PAPER_ROWS.values()))
    cs.time_paper_kernels(K, R, dev)
    cs.paper_path(cs.Counts(K, CK, FK, SK), dev)
    cs.small_reference_paper(dev)
    cs.log(f"paper_check: done in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
