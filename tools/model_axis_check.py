"""A quick card check of the model axis (tensor-parallel client compute):
``chip_smoke.py`` phases 6x and 6y alone.  Each run's world of one in
this process, then the same runs on a (1, 2) mesh of two processes
sharing the card (one torchrun job, gloo), held to it after each round:
params 1e-5, metrics 1e-4, the ranks bitwise equal, launches exactly, a
MoE run's routing bitwise.  It prints the round walls, each rank's peak
and time in the model-axis collectives.  This script calls
``chip_smoke.py``'s functions.

Run on one card from the repo's root::

    python3 tools/model_axis_check.py [--arch A --layers N [--cohort C]
                                       [--chunk K] [--lr LR]]

With no arguments it runs every run of ``chip_smoke.MODEL_AXIS_RUNS``;
``--arch A --layers N`` runs that one architecture at full width, cut to
N layers (cohort 4 in chunks of 2 at client lr 0.01 unless
``--cohort`` / ``--chunk`` / ``--lr`` say otherwise).  It exits non-zero
without a CUDA device or when a check fails.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)
# as chip_smoke.py sets it, before torch first touches the card
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--cohort", type=int, default=4)
    ap.add_argument("--chunk", type=int, default=2)
    ap.add_argument("--lr", type=float, default=0.01)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("model_axis_check: no CUDA device available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.device import strict_fp32
    from repro_torch.kernels.comm import kernel as CK
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.fused_update import kernel as K
    from repro_torch.kernels.ssd_scan import kernel as SK

    runs = cs.MODEL_AXIS_RUNS
    if args.arch:
        runs = {f"check:{args.arch}": (args.arch, args.layers, args.cohort,
                                       args.chunk, args.lr)}
    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    strict_fp32()
    cs.log(cs.card_line())
    K.LIB.build(True)
    cs.log(f"built in {time.perf_counter() - t0:.1f} s")
    cs.model_axis_refs(cs.Counts(K, CK, FK, SK), dev, runs)
    cs.log(f"world-of-one runs done at {time.perf_counter() - t0:.1f} s")
    job = cs.start_model_axis(runs)
    try:
        cs.finish_model_axis(job)
    finally:
        cs.stop_model_axis(job)
    cs.log(f"model_axis_check: done in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
