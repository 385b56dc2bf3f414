"""A quick card check of the model axis (tensor-parallel client compute):
``chip_smoke.py`` phases 6x, 6y and 6z alone, or one run of them.  Each
run's world of one in this process, then the same runs on a (1, 2) mesh
of two processes sharing the card (one torchrun job, gloo), held to it
after each round: params 1e-5 (a codec: the flip-aware criterion),
metrics 1e-4, ``ctrl`` 1e-5, the residual stacks by the flip-aware
criterion, the ranks' whole state bitwise equal, launches exactly, a MoE
run's routing bitwise.  It prints the round walls, each rank's peak and
time in the model-axis collectives.  This script calls
``chip_smoke.py``'s functions.

Run on one card from the repo's root::

    python3 tools/model_axis_check.py [--arch A --layers N] [--cohort C]
        [--chunk K] [--lr LR]
        [--mode {post,post+rows,through_aggregation,int8,sign1bit,topk,
                 legacy_tree} [--error-feedback]]

With no arguments it runs every run of ``chip_smoke.MODEL_AXIS_RUNS``
(``post+rows``: the residual stream split over the axis by batch rows,
each rank's peak printed beside the replicated run's).
``--arch A --layers N`` or ``--mode M`` runs one: architecture A at full
width cut to N layers (by default 6z's smollm-360m at 2 layers) in mode M
(by default post; ``--error-feedback`` with a codec), cohort 4 in chunks
of 2 at client lr 0.01 unless ``--cohort`` / ``--chunk`` / ``--lr`` say
otherwise.  It exits non-zero without a CUDA device or when a check
fails.
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

MODES = ("post", "post+rows", "through_aggregation", "int8", "sign1bit",
         "topk", "legacy_tree")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--cohort", type=int, default=4)
    ap.add_argument("--chunk", type=int, default=2)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--mode", choices=MODES)
    ap.add_argument("--error-feedback", action="store_true",
                    help="with --mode int8|sign1bit|topk: the codec with "
                         "error feedback")
    args = ap.parse_args()
    codecs = ("int8", "sign1bit", "topk")
    if args.error_feedback and args.mode not in codecs:
        ap.error("--error-feedback needs --mode int8, sign1bit or topk")
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
    if args.arch or args.mode:
        mode = (args.mode or "post") + ("+ef" if args.error_feedback else "")
        arch = args.arch or "smollm-360m"
        layers = args.layers or (0 if args.arch else 2)
        runs = {f"check:{arch}:{mode}": (arch, layers, args.cohort,
                                         args.chunk, args.lr, mode)}
    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    strict_fp32()
    cs.log(cs.card_line())
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(2) as pool:           # one nvcc per source
        for f in [pool.submit(lib.build, True) for lib in (K.LIB, CK.LIB)]:
            f.result()
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
