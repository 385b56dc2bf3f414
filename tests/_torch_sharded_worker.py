"""The process body of ``tests/test_torch_sharded.py``: one rank of a gloo
job on the CPU, launched as ``torchrun`` would launch it (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR`` / ``MASTER_PORT`` in the environment).
It imports torch and the port only, never JAX.

Each rank runs the sharded round (2 chained rounds of a small MLP at
cohort 5, chunk 3) in three modes, rank 0 also the single-process
chunked round on the same inputs, then ``sharded_flash_decode`` over its
half of a cache, and, on a world of two, a round of the MLP on a (1, 2)
mesh, which must refuse (the model axis runs the dense GQA stacks).  Results go to ``<out>/rank<r>.pt``."""
import os

import numpy as np
import torch

COHORT = 5
CASES = {"post": dict(), "through_aggregation": dict(
    meta_mode="through_aggregation"), "int8+ef": dict(codec="int8",
                                                      error_feedback=True)}
DECODE = dict(B=2, S=64, H=4, Hkv=2, D=16, index=40)


def mlp_loss(w, batch, rng=None):
    logits = torch.tanh(batch["x"] @ w["w1"]) @ w["w2"]
    return -torch.mean(torch.gather(
        torch.log_softmax(logits, -1), 1, batch["y"][:, None])), {}


def inputs(seed=0):
    rng = np.random.default_rng(seed)
    batch = {"x": torch.from_numpy(
        rng.normal(0, 1, (COHORT, 8, 10)).astype(np.float32)),
        "y": torch.from_numpy(rng.integers(0, 4, (COHORT, 8)))}
    meta = {"x": torch.from_numpy(rng.normal(0, 1, (8, 10)).astype(
        np.float32)), "y": torch.from_numpy(rng.integers(0, 4, 8))}
    wts = torch.from_numpy(rng.uniform(1.0, 5.0, COHORT).astype(np.float32))
    params = {"w1": torch.from_numpy(
        (0.3 * rng.standard_normal((10, 16))).astype(np.float32)),
        "w2": torch.from_numpy(
        (0.3 * rng.standard_normal((16, 4))).astype(np.float32))}
    return batch, meta, wts, params


def fed_kw(**kw):
    return dict(algorithm="uga", meta=True, cohort=COHORT, local_steps=2,
                client_lr=0.05, server_lr=0.1, meta_lr=0.05, clip_norm=1.0,
                lr_decay=0.9, fused_update=True, cohort_chunk=3, **kw)


def decode_inputs():
    c = DECODE
    rng = np.random.default_rng(1)
    q = rng.standard_normal((c["B"], c["H"], c["D"])).astype(np.float32)
    k = rng.standard_normal((c["B"], c["S"], c["Hkv"], c["D"])).astype(
        np.float32)
    v = rng.standard_normal((c["B"], c["S"], c["Hkv"], c["D"])).astype(
        np.float32)
    return q, k, v


def run_rounds(fed, mesh):
    from repro_torch.core.round import (init_server_state,
                                        make_federated_round)
    from repro_torch.models.model import Model
    model = Model(name="mlp", init=None, loss=mlp_loss)
    batch, meta, wts, params = inputs()
    state = init_server_state(model, fed, params=params)
    rf = make_federated_round(model, fed, mesh=mesh)
    hist = []
    for _ in range(2):
        state, m = rf(state, batch, meta, wts)
        hist.append({k: float(v) for k, v in m.items()})
    return state, hist


def main(rank: int, world: int, port: int, out: str) -> None:
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    import _torch_parity  # noqa: F401  (one torch thread a rank)
    import torch.distributed as dist
    from repro_torch.configs import FedConfig
    from repro_torch.launch.mesh import make_auto_mesh, make_debug_mesh
    from repro_torch.sharding.longctx import sharded_flash_decode
    from repro_torch.sharding.tensor_parallel import SeqSplit

    mesh = make_auto_mesh(device="cpu")
    res = {"mesh": (dict(mesh.shape), dict(mesh.coords))}
    for case, kw in CASES.items():
        fed = FedConfig(**fed_kw(**kw))
        res[f"sharded:{case}"] = run_rounds(fed, mesh)
        if rank == 0:
            res[f"chunked:{case}"] = run_rounds(fed, None)
    q, k, v = (torch.from_numpy(a) for a in decode_inputs())
    loc = DECODE["S"] // world
    sl = slice(rank * loc, (rank + 1) * loc)
    # the cache's sequence split over the data axis, as cache_shardings
    # splits it at B = 1
    seq = SeqSplit(mesh.groups["data"], world, rank, loc)
    res["decode"] = sharded_flash_decode(
        q, k[:, sl], v[:, sl], torch.tensor(DECODE["index"]), seq)
    if world == 2:
        # the model axis runs the transformer configs; a round of this MLP
        # on a (1, 2) mesh still refuses
        from repro_torch.core.round import make_federated_round
        from repro_torch.models.model import Model
        try:
            make_federated_round(Model(name="mlp", init=None, loss=mlp_loss),
                                 FedConfig(**fed_kw()),
                                 mesh=make_debug_mesh(1, 2, device="cpu"))
            res["model_axis"] = "accepted"
        except NotImplementedError as e:
            res["model_axis"] = str(e)
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()
