"""A quick card check of the encoder-decoder and hybrid serving path: flash
attention non-causal over encoder keys, the smoke configs card against
CPU, and whisper-large-v3 served at full width.

Builds the flash-attention and SSD-scan kernels (one ``nvcc`` each, both
started together), then runs ``chip_smoke.py``'s own functions for
phase 3b's flash checks (every form, non-causal at Sq != Skv, every call
shape of a served prefill, against the plain version at 1e-5), phase
5d's flash timings (in turns with scaled_dot_product_attention), phase
7s (every smoke config's prefill, cache and 4 decode steps on the card
against the CPU plain versions, MoE routing asserted equal first) and
phase 6u on whisper-large-v3 alone (``serve.main`` at batch 8, 1500
frames, prompt 416, 32 tokens: 64 flash launches a prefill, the warm
prefill, its rate and flash's share).  About 40 s, where
``chip_smoke.py`` takes about six minutes.

Run on one card from the repo's root::

    python3 tools/encdec_check.py

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
        print("encdec_check: no CUDA device available", file=sys.stderr)
        return 2
    from concurrent.futures import ThreadPoolExecutor

    import chip_smoke as cs
    from repro_torch.device import strict_fp32
    from repro_torch.kernels.comm import kernel as CK
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention import ref as FR
    from repro_torch.kernels.fused_update import kernel as K
    from repro_torch.kernels.ssd_scan import kernel as SK

    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    strict_fp32()
    cs.log(cs.card_line())
    with ThreadPoolExecutor(2) as pool:
        for f in [pool.submit(lib.build, True) for lib in (FK.LIB, SK.LIB)]:
            f.result()
    cs.log("[3b] flash attention against its plain version:")
    cs.check_flash_forms(FK, FR, dev)
    cs.log("[5d] flash attention at every served call shape:")
    forms = cs.time_flash_prefills(FK, FR, dev)
    cs.log("[7s] smoke configs, card against the CPU plain versions:")
    cs.small_reference_serve(dev)
    cs.log("[6u] whisper-large-v3 at full width:")
    cs.FLASH_SERVE = ("whisper-large-v3",)
    cs.serve_flash_models(cs.Counts(K, CK, FK, SK), dev, forms)
    cs.log(f"done in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
