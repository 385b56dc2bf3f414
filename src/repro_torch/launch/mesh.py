"""Mesh construction over ``torch.distributed`` (PyTorch port of
``repro/launch/mesh.py``).  Functions, not module-level constants:
importing this module starts no process group.

Under ``torchrun`` (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and the
rendezvous address in the environment) the default process group is
initialized from ``env://``, each process on ``cuda:LOCAL_RANK``.
Without a launcher the process makes a world of one in-process, at a
free ``localhost`` port.  The backend follows the device: NCCL on
``cuda``, gloo on ``cpu``.  A group that cannot start raises; nothing
falls back to one process.

``make_production_mesh`` (the JAX package's v5e pod shapes) has no
meaning on H100 processes and goes with the dry run, ROADMAP Queue 1
item 8.
"""
from __future__ import annotations

import os
import socket
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.sharding.specs import Mesh

AXES = ("data", "model")


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_process_group(device=None) -> torch.device:
    """Start the default process group if none is running; returns this
    process's device (``cuda:LOCAL_RANK`` under ``torchrun``)."""
    dev = resolve_device(device)
    launched = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if dev.type == "cuda":
        if launched and dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        if dev.index is not None:
            torch.cuda.set_device(dev)
    if not dist.is_initialized():
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if launched:
            dist.init_process_group(backend, init_method="env://")
        else:
            dist.init_process_group(
                backend, init_method=f"tcp://localhost:{_free_port()}",
                world_size=1, rank=0)
    return dev


def _mesh(data: int, model: int, dev: torch.device) -> Mesh:
    """The (data, model) mesh over the default group's ranks, row-major.
    Every process builds every axis group, in the same order, as
    ``dist.new_group`` requires."""
    rank = dist.get_rank()
    coords = {"data": rank // model, "model": rank % model}
    groups = {}
    for d in range(data):                         # model-axis groups
        g = dist.new_group([d * model + m for m in range(model)])
        if d == coords["data"]:
            groups["model"] = g
    for m in range(model):                        # data-axis groups
        g = dist.new_group([d * model + m for d in range(data)])
        if m == coords["model"]:
            groups["data"] = g
    return Mesh(AXES, {"data": data, "model": model}, coords, groups, dev)


def make_auto_mesh(model: int = 1, *, device=None) -> Mesh:
    """Every process of the job as one (data, model) mesh — the default
    for ``train.py --executor sharded``: the data axis (the cohort split
    of the two-tier aggregation) takes every process the model axis
    does not."""
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
