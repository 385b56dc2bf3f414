#!/usr/bin/env python3
"""Where one training round of mamba2-780m at full width peaks, on the card.

    python3 tools/mamba_train_memory.py [vmap|scan ...]

Runs one round of ``run_training`` (UGA + FedMeta, fused engine, cohort 4,
client batch 8, seq 128: ``chip_smoke.py`` phase 6m's shape) and prints,
for each stage of each client's UGA update (the local-step gradient, the
evaluation gradient on the whole client batch, the jvp-of-grad reverse
sweep, whose own inner gradient prints first as a local-step gradient)
and for the FedMeta step, the memory allocated before it, its peak
(``torch.cuda.max_memory_allocated``, reset at the stage's start) and
after it.  Needs one CUDA device; about 30 s a strategy.
"""
from __future__ import annotations

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "src"))

GIB = 2 ** 30


def stage(name, fn):
    """``fn`` wrapped to print its memory before, at its peak and after."""
    import torch

    def wrapped(*args, **kwargs):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        print(f"  {name}: before {before / GIB:.2f} GiB, peak "
              f"{torch.cuda.max_memory_allocated() / GIB:.2f} GiB, after "
              f"{torch.cuda.memory_allocated() / GIB:.2f} GiB", flush=True)
        return out

    return wrapped


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("mamba_train_memory: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.core import client as C
    from repro_torch.core import round as R
    from repro_torch.device import strict_fp32
    from repro_torch.launch.train import run_training

    strict_fp32()
    grad, grad_and_value, jvp = C.grad, C.grad_and_value, C.jvp
    C.grad = lambda f, *a, **k: stage("local-step gradient",
                                      grad(f, *a, **k))
    C.grad_and_value = lambda f, *a, **k: stage(
        "evaluation gradient (whole client batch)",
        grad_and_value(f, *a, **k))
    C.jvp = stage("reverse sweep (jvp-of-grad)", jvp)
    R.meta_update = stage("FedMeta step (meta batch 16)", R.meta_update)
    for strategy in argv or ["vmap"]:
        print(f"{strategy}: one round of mamba2-780m", flush=True)
        torch.cuda.reset_peak_memory_stats()
        run_training("mamba2-780m", rounds=1, cohort=4, client_batch=8,
                     seq=128, fused=True, strategy=strategy, log_every=1,
                     device="cuda")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
