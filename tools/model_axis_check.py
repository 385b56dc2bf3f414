"""A quick card check of the model axis (tensor-parallel client compute):
``chip_smoke.py`` phase 6c's chunked post run alone (smollm-360m at full
width, cohort 10 in chunks of 4, 2 rounds), then phase 6x, the same run
on a (1, 2) mesh of two processes sharing the card (torchrun, gloo; in
chunks of 2), held to it after each round: params 1e-5, metrics 1e-4,
the ranks bitwise equal, launches exactly.  It prints the round walls,
each rank's peak and time in the model-axis collectives.  This script
calls ``chip_smoke.py``'s functions.

Run on one card from the repo's root::

    python3 tools/model_axis_check.py [--chunk C]

``--chunk C`` runs the two ranks at cohort chunk C instead of 6x's 2.
It exits non-zero without a CUDA device or when a check fails.
"""
from __future__ import annotations

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)
# as chip_smoke.py sets it, before torch first touches the card
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")


def main() -> int:
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

    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    strict_fp32()
    cs.log(cs.card_line())
    K.LIB.build(True)
    cs.log(f"built in {time.perf_counter() - t0:.1f} s")
    _, post_rounds = cs.chunked_path(cs.Counts(K, CK, FK, SK), dev,
                                     runs={"chunked:post"})
    cs.log(f"6c's chunked post run done at {time.perf_counter() - t0:.1f} s")
    chunk = int(sys.argv[sys.argv.index("--chunk") + 1]) \
        if "--chunk" in sys.argv else cs.MODEL_AXIS_CHUNK
    cs.finish_model_axis(cs.start_model_axis(post_rounds, chunk))
    cs.log(f"model_axis_check: done in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
