"""A quick card check of the chunked streaming cohort and the sharded
executor: ``chip_smoke.py`` phases 6c (smollm-360m at full width, cohort
10 in chunks of 4: post, through_aggregation and int8 + error feedback,
and the sharded executor on a world of one against the chunked round,
launches held exactly) and 7c (the same at smoke size, chunk sizes
against one another, against scan and vmap, and the card against the
CPU).  This script calls ``chip_smoke.py``'s functions.

Run on one card from the repo's root::

    python3 tools/chunked_check.py

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
        print("chunked_check: no CUDA device available", file=sys.stderr)
        return 2
    from concurrent.futures import ThreadPoolExecutor

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
    with ThreadPoolExecutor(2) as pool:               # one nvcc per source
        for f in [pool.submit(lib.build, True) for lib in (K.LIB, CK.LIB)]:
            f.result()
    cs.log(f"built in {time.perf_counter() - t0:.1f} s")
    cs.chunked_path(cs.Counts(K, CK, FK, SK), dev)
    cs.log(f"6c done at {time.perf_counter() - t0:.1f} s")
    cs.small_reference_chunked(dev)
    cs.log(f"chunked_check: done in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
