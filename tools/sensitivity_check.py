"""How far a training run moves when only its initial parameters are
perturbed at the size of fp32 rounding: the bound below which no
implementation of the same run (another summation order, a model axis)
can be held to it.

For each run of ``RUNS`` (full width, depth cut, UGA + FedMeta post,
cohort 4 in chunks of 2, client batch 8, seq 128, sgd, 2 rounds), three
runs of ``run_training`` on one card: from a seeded init, from the same
init with every element scaled by (1 +- 1e-7) (the sign drawn from a
seed), and the first again.  Printed after each round: the parameters'
max |a-b| over max |b| of the perturbed run (the twin) and of the repeat
against the first, and the runs' grad_norm and meta_loss.

Run on one card from the repo's root::

    python3 tools/sensitivity_check.py [ARCH:LAYERS:LR ...]

The arguments replace ``RUNS``.  It exits non-zero without a CUDA
device.
"""
from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

# (arch, layers, client lr)
RUNS = [("mamba2-780m", 8, 0.01), ("mamba2-780m", 8, 0.001),
        ("mamba2-780m", 16, 0.001), ("mamba2-780m", 4, 0.001),
        ("whisper-large-v3", 2, 0.01), ("deepseek-v2-lite-16b", 1, 0.01),
        ("smollm-360m", 8, 0.01)]
EPS = 1e-7


def run(arch, layers, lr, params, dev):
    """Two rounds from ``params``: the flat parameters and the record
    after each round."""
    from repro_torch.core import flat as F
    from repro_torch.launch.train import run_training
    flats, recs = [], []

    def on_records(r, trainer):
        p = trainer.state["params"]
        (f,) = F.flatten_tree(F.make_flat_spec(p), p)
        flats.append(f.clone())
        recs.append(dict(r[0]))
    run_training(arch, layers=layers, rounds=2, cohort=4, client_batch=8,
                 seq=128, algorithm="uga", meta=True, fused=True,
                 cohort_chunk=2, server_opt="sgd", client_lr=lr, seed=0,
                 log_every=100, device=dev, params=params,
                 on_records=on_records)
    return flats, recs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("sensitivity_check: no CUDA device available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.configs import get_arch, with_depth
    from repro_torch.device import strict_fp32
    from repro_torch.kernels.fused_update import kernel as K
    from repro_torch.models.model import build_model

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    strict_fp32()
    cs.log(cs.card_line())
    K.LIB.build(True)
    runs = [(a, int(n), float(lr)) for a, n, lr in
            (x.split(":") for x in sys.argv[1:])] or RUNS
    for arch, layers, lr in runs:
        p = build_model(with_depth(get_arch(arch), layers)).init(
            torch.Generator(dev).manual_seed(0))
        g = torch.Generator(dev).manual_seed(1)
        twin = {k: v * (1 + EPS * (torch.randint(
            0, 2, v.shape, generator=g, device=dev) * 2 - 1))
            for k, v in p.items()}
        a, ra = run(arch, layers, lr, {k: v.clone() for k, v in p.items()},
                    dev)
        b, rb = run(arch, layers, lr, twin, dev)
        c, _ = run(arch, layers, lr, p, dev)

        def rel(xs):
            return [float((x - y).abs().max() / y.abs().max())
                    for x, y in zip(xs, a)]
        cs.log(f"{arch} at {layers} layers, lr {lr}: params rel after each "
               f"round, twin {rel(b)}, repeat {rel(c)}; grad_norm "
               f"{[r['grad_norm'] for r in ra]} (twin "
               f"{[r['grad_norm'] for r in rb]}); meta_loss "
               f"{[r['meta_loss'] for r in ra]} (twin "
               f"{[r['meta_loss'] for r in rb]})")
        del a, b, c, p, twin
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
