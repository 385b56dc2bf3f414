"""The process body of ``tests/test_torch_tp_layers.py``,
``tests/test_torch_tp_mamba.py`` and ``tests/test_torch_tp_encoder.py``:
one rank of a gloo job on the CPU, launched as ``torchrun`` would launch
it.  It imports torch and the port only, never JAX: the parent hands it
JAX's parameters (bridged), inputs and JAX's first local step in
``<out>/inputs.pt``, and compares what each rank writes to
``<out>/rank<r>.pt``.

For each architecture of the job, on this rank's shards of JAX's
parameters: the loss and metrics, the gradient and one ``uga_update``
gathered whole, the same update with its first local step pinned to
JAX's where the parent sends that step (``pinned``), the gradient of
every leaf a process slices to its part (``A_log``, ``D``, ``dt_bias``,
``b_in``) as this rank holds it, the routing of every MoE layer (in each
dispatch form of ``forms``), the shards' shapes, and whether
``gather_params`` of the shards is the parameters bitwise.  Then
``ROUNDS`` chained sharded rounds of the trainer for each (name, chunk)
of ``rounds``, or (name, chunk, act spec, client batch): the residual
stream split over the model axis by rows (``"on"``) or replicated.
"""
import os

import torch

COHORT, BATCH, SEQ, ROUNDS = 4, 4, 16, 2
LR = 0.05
FED = dict(algorithm="uga", meta=True, cohort=COHORT, local_steps=2,
           client_lr=0.05, server_lr=0.05, meta_lr=0.05, lr_decay=0.992,
           fused_update=True, clip_norm=1.0, server_opt="sgd")
DATA = dict(num_clients=8, examples=64, seq=SEQ, iid=False, seed=0)
# leaves a process slices to its part of a whole leaf (tp.split)
SLICED = ("mamba.A_log", "mamba.D", "mamba.dt_bias", "mlp.b_in")


def run_rounds(name, p0, chunk, mesh=None, batch=BATCH):
    """ROUNDS rounds of the trainer on ``name`` from ``p0``, ``batch``
    rows a client; returns (state, history)."""
    from repro_torch.configs import FedConfig, get_arch
    from repro_torch.core.trainer import FederatedTrainer
    from repro_torch.launch.train import build_synthetic_fed_data
    from repro_torch.models.model import build_model
    tt = FederatedTrainer(build_model(get_arch(name), loss_chunk=256),
                          FedConfig(**FED, cohort_chunk=chunk),
                          device="cpu", params=p0, mesh=mesh)
    hist = tt.run(build_synthetic_fed_data(get_arch(name), **DATA),
                  rounds=ROUNDS, cohort=COHORT, batch=batch,
                  meta_batch=2 * batch)
    return tt.state, hist


def _routes(fn):
    """``fn()`` with the port's ``_route`` recording (expert_idx, keep) of
    every MoE call; returns (fn's result, records)."""
    from repro_torch.models import moe as TMOE
    recs, orig = [], TMOE._route

    def route(xg, p, cfg):
        out = orig(xg, p, cfg)
        recs.append((out[1].numpy().copy(), out[3].numpy().copy()))
        return out
    TMOE._route = route
    try:
        return fn(), recs
    finally:
        TMOE._route = orig


def model(arch, mesh):
    """One architecture on this rank's shards (see the module
    docstring)."""
    from functools import partial
    from repro_torch.configs import get_arch
    from repro_torch.core import client as TC
    from repro_torch.models import moe as TMOE
    from repro_torch.models.model import build_model
    from repro_torch.sharding.tensor_parallel import model_axis
    name, p0 = arch["name"], arch["p0"]
    m = build_model(get_arch(name), loss_chunk=256)
    axis = model_axis(mesh, p0)
    loc = axis.shard(p0)
    batch = arch["batch"]
    loss = partial(m.loss, tp=axis)
    out = {"shapes": {k: tuple(v.shape) for k, v in loc.items()}}
    for form in arch["forms"]:
        TMOE.set_moe_impl(form)
        (value, metrics), routes = _routes(lambda: loss(loc, batch))
        out[f"loss:{form}"] = (value, metrics, routes)
        if form == arch["forms"][0]:
            g = torch.func.grad(lambda w: loss(w, batch)[0])(loc)
            out["sliced"] = {k: v for k, v in g.items()
                             if k.endswith(SLICED)}
            out["grad"] = axis.gather_params(g)
            G, l_eval = TC.uga_update(loss, loc, batch, LR)
            out["uga"] = (axis.gather_params(G), l_eval)
            if arch["w1"] is not None:
                w1 = axis.shard(arch["w1"])
                orig = TC._sgd
                TC._sgd = lambda w, g, lr: w1
                try:
                    G, l_eval = TC.uga_update(loss, loc, batch, LR)
                finally:
                    TC._sgd = orig
                out["pinned"] = (axis.gather_params(G), l_eval)
    TMOE.set_moe_impl("gather")
    whole = axis.gather_params(loc)
    out["gather_bitwise"] = all(torch.equal(whole[k], p0[k]) for k in whole)
    return out


def main(rank: int, world: int, model_size: int, port: int,
         out: str) -> None:
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    import _torch_parity  # noqa: F401  (one torch thread a rank)
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_auto_mesh

    inputs = torch.load(os.path.join(out, "inputs.pt"), weights_only=False)
    mesh = make_auto_mesh(model_size, device="cpu")
    res = {"mesh": (dict(mesh.shape), dict(mesh.coords))}
    for arch in inputs["archs"]:
        res[arch["name"]] = model(arch, mesh)
    from repro_torch.sharding.tensor_parallel import set_activation_spec
    for name, chunk, *opt in inputs.get("rounds", []):
        # opt: (act spec "on" / "off", client batch), or none: off, BATCH
        act, batch = opt or ("off", BATCH)
        set_activation_spec(act == "on")
        key = f"rounds:{name}:{chunk}" + ("" if not opt else
                                          f":{act}:{batch}")
        try:
            res[key] = run_rounds(name, inputs["p0"][name], chunk, mesh,
                                  batch)
        finally:
            set_activation_spec(False)
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()
