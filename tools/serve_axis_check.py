"""A quick card check of serving over the model axis: ``chip_smoke.py``
phase 6v alone.  Each request's world of one in this process (full
width, depth cut, batch 8, prefill 1024 into a cache of 1040, 8 greedy
decode steps), then the same requests on a (1, 2) mesh of two processes
sharing the card (one torchrun job, gloo), held to it: the prefill's and
every step's logits and each rank's cache part within 1e-5, the greedy
tokens equal, the launches exactly (flash one a layer of attention on the
rank's heads, the SSD scan one a mamba layer, none in decode).  It prints
the prefill and decode walls, each rank's peak and time in the
collectives.  This script calls ``chip_smoke.py``'s functions.

Run on one card from the repo's root::

    python3 tools/serve_axis_check.py [--arch A --layers N]

With no arguments it runs every request of
``chip_smoke.SERVE_AXIS_RUNS``; ``--arch A --layers N`` one, at full
width cut to N layers.  It exits non-zero without a CUDA device or when
a check fails.
"""
from __future__ import annotations

import argparse
import json
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
    ap.add_argument("--layers", type=int, default=1)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("serve_axis_check: no CUDA device available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.device import strict_fp32
    from repro_torch.kernels.comm import kernel as CK
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.fused_update import kernel as K
    from repro_torch.kernels.ssd_scan import kernel as SK

    runs = cs.SERVE_AXIS_RUNS
    if args.arch:
        runs = {f"check:{args.arch}": (args.arch, args.layers)}
    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    strict_fp32()
    cs.log(cs.card_line())
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(2) as pool:           # one nvcc per source
        for f in [pool.submit(lib.build, True) for lib in (FK.LIB, SK.LIB)]:
            f.result()
    cs.log(f"built in {time.perf_counter() - t0:.1f} s")
    cs.serve_axis_refs(cs.Counts(K, CK, FK, SK), dev, runs)
    with open(os.path.join(cs.MODEL_AXIS_DIR, "runs.json"), "w") as f:
        json.dump({}, f)                           # no training runs
    cs.log(f"worlds of one done at {time.perf_counter() - t0:.1f} s")
    job = cs.start_model_axis({}, serve=runs)
    try:
        cs.finish_model_axis(job)
    finally:
        cs.stop_model_axis(job)
    cs.log(f"serve_axis_check: done in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
