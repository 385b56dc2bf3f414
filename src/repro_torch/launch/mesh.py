"""Mesh construction over ``torch.distributed`` (PyTorch port of
``repro/launch/mesh.py``).  Functions, not module-level constants:
importing this module starts no process group.

Under ``torchrun`` (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and the
rendezvous address in the environment) the default process group is
initialized from ``env://``.  Without a launcher the process makes a
world of one in-process, at a free ``localhost`` port.  A group that
cannot start raises; nothing falls back to one process.

The backend rule, chosen up front (nothing tries NCCL and catches its
failure):

  * on the CPU, gloo;
  * on ``cuda`` with a card for each of the node's ranks
    (``LOCAL_WORLD_SIZE <= torch.cuda.device_count()``), NCCL, each rank
    on ``cuda:LOCAL_RANK``;
  * on ``cuda`` with more ranks on the node than cards, the ranks share
    the cards round-robin (``cuda:LOCAL_RANK % device_count``) and the
    group is gloo, which carries CUDA tensors through host memory (NCCL
    refuses two ranks on one card).  A (1, 2) mesh of two processes runs
    on one H100 so.

Rank 0 of a launched job prints the rule it chose.

:func:`make_production_mesh` is the JAX package's v5e pod shapes, (16,
16) and (2, 16, 16), as rank 0 of torch's ``fake`` backend: every
collective dispatches and none communicates, which is what a dry run on
those meshes traces (``launch/dryrun.py --mesh 16x16``, ``--multi-pod``).
"""
from __future__ import annotations

import math
import os
import socket
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.sharding.specs import Mesh

AXES = ("data", "model")


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def backend_rule(dev: torch.device, local_rank: int, local_world: int
                 ) -> Tuple[str, torch.device, str]:
    """(backend, this rank's device, why) for a rank of a job with
    ``local_world`` ranks on this node."""
    if dev.type != "cuda":
        return "gloo", dev, f"gloo on {dev.type}"
    n = torch.cuda.device_count()
    if local_world > n:
        return ("gloo", torch.device("cuda", local_rank % n),
                f"gloo: {local_world} ranks on this node share {n} card(s), "
                f"rank r on cuda:(r % {n}); CUDA tensors cross through host "
                "memory")
    return ("nccl", torch.device("cuda", local_rank),
            f"nccl: one card a rank ({local_world} ranks, {n} cards)")


def init_process_group(device=None) -> torch.device:
    """Start the default process group if none is running; returns this
    process's device (by :func:`backend_rule` under ``torchrun``)."""
    dev = resolve_device(device)
    launched = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if launched:
        local_world = int(os.environ.get(
            "LOCAL_WORLD_SIZE", os.environ["WORLD_SIZE"]))
        backend, placed, why = backend_rule(
            dev, int(os.environ.get("LOCAL_RANK", 0)), local_world)
        if dev.index is None:         # a card the caller named stays
            dev = placed
        if int(os.environ["RANK"]) == 0 and not dist.is_initialized():
            print(f"[mesh] backend {why}", flush=True)
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        if launched:
            dist.init_process_group(backend, init_method="env://")
        else:
            dist.init_process_group(
                backend, init_method=f"tcp://localhost:{_free_port()}",
                world_size=1, rank=0)
    return dev


def _grid_mesh(axes: Sequence[str], sizes: Sequence[int], dev: torch.device,
               *, all_groups: bool = True) -> Mesh:
    """The mesh of ``axes`` x ``sizes`` over the default group's ranks,
    row-major.  Each axis's group holds the ranks that share this one's
    other coordinates; on a mesh with a ``pod`` axis the batch axes
    ``("pod", "data")`` have a group too, keyed by that tuple (the
    sharded executor's cohort sum runs over both).  Every process builds
    every group, in the same order, as ``dist.new_group`` requires;
    ``all_groups=False`` builds only this process's (a fake group, where
    no other process calls)."""
    axes, sizes = tuple(axes), tuple(int(s) for s in sizes)
    rank = dist.get_rank()
    coords, rem = {}, rank
    for a, n in reversed(list(zip(axes, sizes))):
        coords[a] = rem % n
        rem //= n
    coords = {a: coords[a] for a in axes}
    strides = {a: math.prod(sizes[i + 1:]) for i, a in enumerate(axes)}
    size = dict(zip(axes, sizes))
    keys = list(axes) + ([("pod", "data")] if "pod" in axes else [])
    groups = {}
    for key in keys:
        span = (key,) if isinstance(key, str) else key
        others = [(b, n) for b, n in zip(axes, sizes) if b not in span]
        for flat in range(math.prod(n for _, n in others)):
            c, rem = {}, flat
            for b, n in reversed(others):
                c[b] = rem % n
                rem //= n
            mine = all(c[b] == coords[b] for b, _ in others)
            if not (all_groups or mine):
                continue
            base = sum(c[b] * strides[b] for b, _ in others)
            members = [base]
            for a in span:           # row-major over the spanned axes
                members = [m + k * strides[a] for m in members
                           for k in range(size[a])]
            g = dist.new_group(sorted(members))
            if mine:
                groups[key] = g
    return Mesh(axes, size, coords, groups, dev)


def _mesh(data: int, model: int, dev: torch.device) -> Mesh:
    """The (data, model) mesh over the default group's ranks, row-major."""
    return _grid_mesh(AXES, (data, model), dev)


def make_auto_mesh(model: int = 1, *, device=None) -> Mesh:
    """Every process of the job as one (data, model) mesh — the default
    for ``train.py --executor sharded``: the data axis (the cohort split
    of the two-tier aggregation) takes every process the model axis
    (tensor-parallel client compute) does not."""
    dev = init_process_group(device)
    n = dist.get_world_size()
    if model < 1 or n % model:
        raise ValueError(
            f"model={model} must be >= 1 and divide the process count {n}")
    return _mesh(n // model, model, dev)


def make_debug_mesh(data: int = 1, model: int = 1, *,
                    device: Optional[str] = None) -> Mesh:
    """A (data, model) mesh that must match the job's process count (a
    world of one without a launcher: ``make_debug_mesh(1, 1)``)."""
    dev = init_process_group(device)
    n = dist.get_world_size()
    if data * model != n:
        raise ValueError(
            f"a ({data}, {model}) mesh needs {data * model} processes; the "
            f"job has {n} (launch it with torchrun --nproc-per-node "
            f"{data * model})")
    return _mesh(data, model, dev)


def fake_mesh(sizes: Sequence[int], device=None) -> Mesh:
    """Rank 0 of a mesh of ``sizes`` — (data, model), or (pod, data,
    model) for three — under torch's ``fake`` process-group backend,
    which it starts: every collective dispatches and none communicates
    (a dry run's trace).  Raises if a process group is already
    running."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    sizes = tuple(int(n) for n in sizes)
    axes = ("pod",) + AXES if len(sizes) == 3 else AXES
    if len(sizes) != len(axes):
        raise ValueError(f"a mesh of {sizes}: (data, model) or (pod, data, "
                         "model)")
    if dist.is_initialized():
        raise RuntimeError(
            f"a fake mesh of {math.prod(sizes)} ranks starts a fake process "
            "group; a process group is already running")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(sizes))
    return _grid_mesh(axes, sizes, torch.device(device or "cpu"),
                      all_groups=False)


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """The production v5e meshes: one pod = 256 chips as (data=16,
    model=16); two pods = 512 as (pod=2, data=16, model=16) — as rank 0
    of torch's ``fake`` process-group backend (:func:`fake_mesh`)."""
    return fake_mesh((2, 16, 16) if multi_pod else (16, 16), device)
