"""Which collectives gloo carries for CUDA tensors, and what they cost,
when two processes share one card (the model axis of a (1, 2) mesh on one
H100, ``repro_torch.launch.mesh``'s shared-card rule).

Each of ``--ranks`` processes (default 2) opens ``cuda:0`` and joins a
gloo group at a free localhost port.  It tries every collective the
tensor-parallel path could use on CUDA tensors (all_reduce SUM / MAX /
MIN on fp32 and int64, broadcast, all_gather into a list,
all_gather_into_tensor, reduce_scatter_tensor, reduce), checks each
result, then times all_reduce and all_gather at the sizes a full-width
smollm-360m client chunk hands them, and the round's 1.447 GB flat
buffer, each on the CUDA tensor (gloo's own staging) and staged by hand
(a copy to a host tensor, the collective on it, a copy back); host
clock around the call after a synchronize, median of ``--reps``.  Rank 0 prints one JSON object.

Run on one card from the repo's root::

    python3 tools/tp_collectives.py [--ranks 2] [--reps 5]
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import statistics
import sys
import time

SIZES_MB = (0.004, 1.0, 8.0, 16.0, 64.0)
FLAT_BYTES = 2_826_728 * 128 * 4          # smollm-360m's flat group


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _try(name, fn, out):
    import torch
    try:
        ok = bool(fn())
        torch.cuda.synchronize()
        out[name] = "ok" if ok else "wrong result"
    except Exception as e:          # a form gloo lacks raises; record it
        out[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"


def _forms(rank, world, dev):
    import torch
    import torch.distributed as dist
    out = {}
    x = torch.full((1000,), float(rank + 1), device=dev)

    def ar(op, dtype, want):
        t = torch.full((1000,), rank + 1, device=dev, dtype=dtype)
        dist.all_reduce(t, op=op)
        return bool((t == want).all())
    _try("all_reduce SUM fp32", lambda: ar(dist.ReduceOp.SUM, torch.float32,
                                           world * (world + 1) / 2), out)
    _try("all_reduce MAX fp32", lambda: ar(dist.ReduceOp.MAX, torch.float32,
                                           world), out)
    _try("all_reduce MIN int64", lambda: ar(dist.ReduceOp.MIN, torch.int64,
                                            1), out)
    _try("all_reduce MAX int64", lambda: ar(dist.ReduceOp.MAX, torch.int64,
                                            world), out)

    def bc():
        t = x.clone()
        dist.broadcast(t, src=world - 1)
        return bool((t == world).all())
    _try("broadcast", bc, out)

    def ag_list():
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x)
        return all(bool((p == r + 1).all()) for r, p in enumerate(parts))
    _try("all_gather (list)", ag_list, out)

    def ag_tensor():
        o = torch.empty(world * x.numel(), device=dev)
        dist.all_gather_into_tensor(o, x)
        return all(bool((o[r * 1000:(r + 1) * 1000] == r + 1).all())
                   for r in range(world))
    _try("all_gather_into_tensor", ag_tensor, out)

    def rs():
        i = torch.arange(world * 10, device=dev, dtype=torch.float32)
        o = torch.empty(10, device=dev)
        dist.reduce_scatter_tensor(o, i)
        return bool((o == world * i[rank * 10:(rank + 1) * 10]).all())
    _try("reduce_scatter_tensor", rs, out)

    def red():
        t = x.clone()
        dist.reduce(t, dst=0)
        return rank != 0 or bool((t == world * (world + 1) / 2).all())
    _try("reduce", red, out)
    return out


def _time(fn, reps):
    import torch
    ts = []
    for i in range(reps + 1):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        if i:
            ts.append((time.perf_counter() - t) * 1e3)
    return statistics.median(ts)


def _times(rank, world, dev, reps):
    import torch
    import torch.distributed as dist
    out = {}
    def staged_all_reduce(t):
        h = t.cpu()
        dist.all_reduce(h)
        t.copy_(h)

    def staged_all_gather(parts, t):
        hp = [torch.empty(t.shape, dtype=t.dtype) for _ in range(world)]
        dist.all_gather(hp, t.cpu())
        for p, h in zip(parts, hp):
            p.copy_(h)

    for mb in SIZES_MB + (FLAT_BYTES / 2**20,):
        n = int(mb * 2**20) // 4
        t = torch.ones(n, device=dev)
        row = {"all_reduce_ms": _time(lambda: dist.all_reduce(t), reps),
               "staged_all_reduce_ms": _time(lambda: staged_all_reduce(t),
                                             reps)}
        if mb < 100:
            parts = [torch.empty_like(t) for _ in range(world)]
            row["all_gather_ms"] = _time(lambda: dist.all_gather(parts, t),
                                         reps)
            row["staged_all_gather_ms"] = _time(
                lambda: staged_all_gather(parts, t), reps)
        out[f"{mb:.3f} MiB"] = row
        del t
    return out


def body(rank, world, port, reps):
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port))
    import torch
    import torch.distributed as dist
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    forms = _forms(rank, world, dev)
    times = _times(rank, world, dev, reps)
    if rank == 0:
        print(json.dumps({"ranks": world, "device": torch.cuda.get_device_name(0),
                          "torch": torch.__version__, "forms": forms,
                          "times": times}), flush=True)
    dist.barrier()
    dist.destroy_process_group()


def main() -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("tp_collectives: no CUDA device available", file=sys.stderr)
        return 2
    torch.multiprocessing.spawn(body, args=(args.ranks, _free_port(),
                                            args.reps), nprocs=args.ranks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
