#!/usr/bin/env python3
"""The legacy tree engine and multi-round calls on one NVIDIA GPU: the
fused-update kernels built and checked at smollm-360m's full-width flat
shape, then ``chip_smoke.py``'s phases 6g (legacy_tree against fused_flat
at full width — the fused vmap/sgd run is phase 6's post vmap/sgd run,
run here first — the server step alone timed), 6r (K-round calls against
K = 1, bitwise) and its phase-7 check of the legacy engine, K = 2, the
``--plugin`` launcher and ``train_method``'s defaults at smoke size, card
against CPU; then the sync pair of 6r again in turns (K = 1, K = 4,
K = 4, K = 1), for the per-round wall of the two forms.

    python3 tools/legacy_check.py

About 5 minutes on one H100; exits non-zero without a card.
"""
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("legacy_check: no CUDA device available", file=sys.stderr)
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
    CK.LIB.build(True)
    cs.check_kernels(K, R, O, dev, [cs.FULL_ROWS])
    counts_of = cs.Counts(K, CK, FK, SK)
    cs.legacy_path(counts_of, dev, cs.post_vmap_reference(counts_of, dev))
    cs.rounds_per_call_path(counts_of, dev)
    cs.small_reference_legacy_rpc(counts_of, dev)
    per_round = {1: [], 4: []}
    for k in (1, 4, 4, 1):
        tr, _, walls, total, _ = cs._full_train(
            dev, cs._full_fed(fused_update=True), 4, k=k)
        per_round[k].append(total / 4)
        cs.log(f"  turns, vmap/sgd K={k}: calls {[round(w, 4) for w in walls]}"
               f" s, per round {total / 4:.4f} s")
        del tr
        torch.cuda.empty_cache()
    cs.log(f"  turns: per round K=1 {per_round[1]}, K=4 {per_round[4]}")
    cs.log(f"legacy_check: done in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
