"""The two-tier sharded executor over the cards of one host against the
chunked cohort on one card: smollm-360m at full width, UGA + FedMeta,
sgd, post, client batch 8, seq 128, the paper's cohort of 10, chunk 4,
seed 0.  Each run prints rank 0's round walls, peak memory and launches
and saves its history and every 997th row of its final flat parameters
under ``build/sharded_scaling/``; ``--compare`` holds the sharded run to
the chunked one (max |a-b| over max |b|; 1e-6 on the CPU, where the
partial sums only reassociate).

Run from the repo's root, on one card and then on four::

    python3 tools/sharded_scaling.py --tag chunked
    torchrun --nproc-per-node 4 tools/sharded_scaling.py --tag sharded4 \\
        --executor sharded
    python3 tools/sharded_scaling.py --compare chunked sharded4

``--arch smollm-360m-smoke --device cpu`` rehearses it on the CPU (gloo).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
OUT = os.path.join(ROOT, "build", "sharded_scaling")


def _run(args) -> None:
    import torch
    import torch.distributed as dist
    from repro_torch.core import flat as F
    from repro_torch.device import strict_fp32
    from repro_torch.kernels.comm import kernel as CK
    from repro_torch.kernels.fused_update import kernel as K
    from repro_torch.launch.train import run_training

    strict_fp32()
    cuda = args.device != "cpu"
    marks = [time.perf_counter()]

    def on_records(recs, trainer):
        if cuda:
            torch.cuda.synchronize()
        marks.append(time.perf_counter())

    for m in (K, CK):
        m.reset_launch_counts()
    state, hist = run_training(
        args.arch, rounds=args.rounds, cohort=args.cohort,
        client_batch=args.client_batch, seq=args.seq, fused=True,
        cohort_chunk=args.chunk, executor=args.executor, seed=0,
        log_every=0, device=args.device, on_records=on_records)
    main_rank = not dist.is_initialized() or dist.get_rank() == 0
    if not main_rank:
        dist.destroy_process_group()
        return
    launches = {k: v for m in (K, CK) for k, v in m.launch_counts().items()
                if v}
    world = dist.get_world_size() if dist.is_initialized() else 1
    card = (f"{torch.cuda.get_device_name(0)} x {world}" if cuda
            else f"cpu x {world}")
    peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else 0.0
    walls = [round(b - a, 4) for a, b in zip(marks, marks[1:])]
    print(f"[{args.tag}] {card}: round wall s {walls} (round 0 includes "
          f"init and data); rank 0 max_memory_allocated {peak:.2f} GiB; "
          f"rank 0 launches {json.dumps(launches)}")
    params = state["params"]
    (flat,) = F.flatten_tree(F.make_flat_spec(params), params)
    os.makedirs(OUT, exist_ok=True)
    torch.save({"hist": hist, "sample": flat[::997].cpu()},
               os.path.join(OUT, f"{args.tag}.pt"))
    if dist.is_initialized():
        dist.destroy_process_group()


def _compare(a: str, b: str) -> int:
    import torch
    ra, rb = (torch.load(os.path.join(OUT, f"{t}.pt")) for t in (a, b))
    pe = float((ra["sample"] - rb["sample"]).abs().max()
               / rb["sample"].abs().max())
    he = max(abs(x[k] - y[k]) / max(abs(y[k]), 1e-30)
             for x, y in zip(ra["hist"], rb["hist"]) for k in y
             if k != "round")
    print(f"[compare] {a} vs {b}: params (every 997th row) rel {pe:.3e}, "
          f"history rel {he:.3e}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tag", default="run")
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--executor", default=None)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--cohort", type=int, default=10)
    ap.add_argument("--chunk", type=int, default=4)
    ap.add_argument("--client-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default=None)
    ap.add_argument("--compare", nargs=2, default=None)
    args = ap.parse_args(argv)
    if args.compare:
        return _compare(*args.compare)
    _run(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
