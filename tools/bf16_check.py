"""A quick card check of the bf16 forms of the two prefill kernels
(flash attention, the SSD scan): build, hold against the plain versions
at bf16, time.

Builds both CUDA sources (``nvcc``, ``-Xptxas -v`` printed), runs
``chip_smoke.py``'s bf16 checks (phase 3b at bf16: every flash form and
mask, non-causal at Sq != Skv, every served prefill's call shape; the
SSD scan at both decay regimes and mamba2-780m's prefill shape) and
times both at the served prefill shapes beside their bounds, plain
versions and, for flash, scaled_dot_product_attention at bf16 (phase
5d at bf16); then serves smollm-360m and mamba2-780m built at bf16 at
full width (phase 6w).

Run on one card from the repo's root::

    python3 tools/bf16_check.py

It exits non-zero without a CUDA device or when a shape is off.
"""
from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("bf16_check: no CUDA device available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.device import strict_fp32
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention import ref as FR
    from repro_torch.kernels.ssd_scan import kernel as SK
    from repro_torch.kernels.ssd_scan import ref as SR

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    strict_fp32()
    cs.log(cs.card_line())
    for lib in (FK.LIB, SK.LIB):
        lib.build(True)
        cs.log(lib.build_log.strip())
    cs.check_bf16_kernels(FK, FR, SK, SR, dev)
    if "--no-time" not in sys.argv:
        cs.time_bf16_kernels(FK, FR, SK, SR, dev)
    from repro_torch.kernels.comm import kernel as CK
    from repro_torch.kernels.fused_update import kernel as K
    cs.serve_bf16_path(cs.Counts(K, CK, FK, SK), dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
