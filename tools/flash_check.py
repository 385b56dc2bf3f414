"""A quick card check of the flash-attention kernel at every form it is
built for: build, hold against the plain version, time.

Builds ``src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu``
(``nvcc``, ``-Xptxas -v`` printed), holds ``flash_attention_fwd`` against
``ref.attention_ref`` at 1e-5 (max |a-b| over max |b|) at each (Dk, Dv)
form, (64, 64), (96, 96), (128, 128) and (192, 128) (S 1 to 1025, causal
on and off, window 0 and 256, group 1 and 3; non-causal at Sq != Skv,
queries against an encoder's keys, and S 1500, group 1 and 8), and at
every call shape of a served prefill (B 8: the decoder-only models' S
1024, causal; whisper-large-v3's encoder, decoder self- and
cross-attention; llama-3.2-vision-90b's cross-attention), then times it
there in turns with scaled_dot_product_attention.  The same
checks run in ``chip_smoke.py`` phases 3b and 5d (this script calls its
functions), among everything else.

Run on one card from the repo's root::

    python3 tools/flash_check.py

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
        print("flash_check: no CUDA device available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.device import strict_fp32
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention import ref as FR

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    strict_fp32()
    cs.log(cs.card_line())
    FK.LIB.build(True)
    cs.log(FK.LIB.build_log.strip())
    cs.check_flash_forms(FK, FR, dev)
    cs.time_flash_prefills(FK, FR, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
