"""The process body of ``tests/test_torch_tp_meta.py``,
``tests/test_torch_tp_legacy.py`` and ``tests/test_torch_tp_codecs*.py``:
one rank of a gloo job on the CPU, launched as ``torchrun`` would launch
it.  It imports torch and the port only, never JAX: the parent hands it
JAX's parameters (bridged) in ``<out>/inputs.pt`` and compares what each
rank writes to ``<out>/rank<r>.pt``.

``inputs.pt`` names the job's runs, ``(mode, chunk)`` pairs of
:data:`MODES` (``ROUNDS`` chained rounds of the trainer on
smollm-360m-smoke each, from JAX's parameters; an adam mode from
:func:`warm_adam`'s state, a mode tagged ``ckpt`` writes its checkpoint),
and its probes (:func:`probe`).  The parent runs the same functions with
no mesh for the port's world of one.
"""
import os

import numpy as np
import torch

SMOKE = "smollm-360m-smoke"
COHORT, BATCH, SEQ, ROUNDS = 4, 4, 16, 2
FED = dict(algorithm="uga", meta=True, cohort=COHORT, local_steps=2,
           client_lr=0.05, server_lr=0.05, meta_lr=0.05, lr_decay=0.992,
           fused_update=True, clip_norm=1.0)
DATA = dict(num_clients=8, examples=64, seq=SEQ, iid=False, seed=0)
THROUGH = dict(meta_mode="through_aggregation", ctrl_lr=1.0)
# mode -> its FedConfig fields beside FED
MODES = {
    "through:sgd": dict(THROUGH, server_opt="sgd"),
    "through:adam": dict(THROUGH, server_opt="adam"),
    "legacy_tree:sgd": dict(fused_update=False, server_opt="sgd"),
    **{f"{codec}{'+ef' if ef else ''}": dict(
        codec=codec, error_feedback=ef, server_opt="sgd",
        **({"topk_ratio": 0.05} if codec == "topk" else {}))
       for codec in ("int8", "sign1bit", "topk") for ef in (False, True)},
}


def fed_config(mode, chunk):
    from repro_torch.configs import FedConfig
    return FedConfig(**{**FED, **MODES[mode], "cohort_chunk": chunk})


def warm_adam(rows):
    """A warm adam state (t = 5, random m, v > 0), the same on every
    rank, in the parent and in JAX's trainer."""
    rng = np.random.default_rng(5)
    m = (0.01 * rng.standard_normal((rows, 128))).astype(np.float32)
    v = (1e-3 * rng.random((rows, 128)) + 1e-4).astype(np.float32)
    return {"m": (torch.from_numpy(m),), "v": (torch.from_numpy(v),),
            "t": torch.tensor(5, dtype=torch.int32)}


def run_rounds(p0, mode, chunk, mesh=None, ckpt=None):
    """ROUNDS rounds of the trainer under ``mode`` from ``p0`` (adam
    warm); returns (state, history)."""
    from repro_torch.configs import get_arch
    from repro_torch.core.flat import make_flat_spec
    from repro_torch.core.trainer import FederatedTrainer
    from repro_torch.launch.train import build_synthetic_fed_data
    from repro_torch.models.model import build_model
    fed = fed_config(mode, chunk)
    tt = FederatedTrainer(build_model(get_arch(SMOKE), loss_chunk=256), fed,
                          device="cpu", params=p0, mesh=mesh)
    if fed.server_opt == "adam":
        tt.state["opt"] = warm_adam(make_flat_spec(p0).groups[0].rows)
    hist = tt.run(build_synthetic_fed_data(get_arch(SMOKE), **DATA),
                  rounds=ROUNDS, cohort=COHORT, batch=BATCH,
                  meta_batch=2 * BATCH)
    if ckpt is not None and tt.is_main:
        tt.save(ckpt)
    return tt.state, hist


def _probe_inputs():
    """One round's inputs, made with numpy: the cohort's tokens, the meta
    batch's and the client weights."""
    rng = np.random.default_rng(11)
    toks = lambda *s: torch.from_numpy(rng.integers(0, 512, s)).long()
    return ({"tokens": toks(COHORT, BATCH, SEQ + 1)},
            {"tokens": toks(2 * BATCH, SEQ + 1)},
            torch.from_numpy(rng.integers(8, 64, COHORT).astype(np.float32)))


def _cohort_stage(p0, mode, mesh):
    """(model, fed, the round's executor with its client update bound,
    the engine): what ``make_federated_round`` wires, over ``mesh``'s
    model axis where there is one."""
    from functools import partial
    from repro_torch.configs import get_arch
    from repro_torch.core.algorithms import get_algorithm
    from repro_torch.core.engines import resolve_engine
    from repro_torch.core.executors import resolve_executor
    from repro_torch.models.model import build_model
    from repro_torch.sharding.specs import model_size
    from repro_torch.sharding.tensor_parallel import model_axis
    model = build_model(get_arch(SMOKE), loss_chunk=256)
    fed = fed_config(mode, 2)
    loss, axis = model.loss, None
    if model_size(mesh) > 1:
        axis = model_axis(mesh, p0)
        loss = partial(model.loss, tp=axis)
    update = get_algorithm(fed.algorithm).build(
        loss, local_steps=fed.local_steps, local_epochs=fed.local_epochs,
        prox_mu=fed.prox_mu)
    exe = resolve_executor(fed, mesh=mesh)
    if axis is not None:
        exe.bind_model_axis(axis)
    return model, fed, exe, update, resolve_engine(fed)


def probe(p0, what, mesh=None):
    """One round's pieces of the traps the model axis sets, on the
    probe's inputs:

      * ``"hypergrads"``: the through-aggregation objective's gradients
        w.r.t. ``w_logits``, ``log_lr`` and the aggregate G (whole), from
        ``ctrl`` at its initial value, sgd, clip on;
      * a codec mode: the aggregate G and the residual stacks of one
        ``run_coded`` from zero residuals."""
    from repro_torch.comm import init_comm_state, resolve_codec
    from repro_torch.core.flat import make_flat_spec
    cohort_batch, meta_batch, w = _probe_inputs()
    hyper = what == "hypergrads"
    model, fed, exe, update, eng = _cohort_stage(
        p0, "through:sgd" if hyper else what, mesh)
    lr = fed.client_lr
    if not hyper:
        comm = (init_comm_state(fed, make_flat_spec(p0))
                if fed.error_feedback else None)
        handle, loss, comm = exe.run_coded(
            update, p0, cohort_batch, w, lr, codec=resolve_codec(fed),
            comm=comm)
        return {"G": handle.groups, "loss": loss,
                "residual": None if comm is None else comm["residual"]}
    w_logits = torch.zeros(COHORT, requires_grad=True)
    log_lr = torch.log(torch.tensor(fed.server_lr)).requires_grad_(True)
    rw = exe.reweightable(update, p0, cohort_batch, w, lr)
    handle, _ = rw.aggregate(w * torch.exp(w_logits))
    new_p, _, _ = eng.apply(p0, handle, eng.init_state(p0),
                            lr=torch.exp(log_lr))
    meta = model.loss(new_p, meta_batch)[0]
    d = torch.autograd.grad(meta, [w_logits, log_lr, *handle.groups])
    return {"d_w_logits": d[0], "d_log_lr": d[1], "dG": list(d[2:]),
            "G": [g.detach() for g in handle.groups]}


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
    p0 = inputs["p0"]
    res = {"mesh": (dict(mesh.shape), dict(mesh.coords))}
    for what in inputs.get("probes", []):
        res[f"probe:{what}"] = probe(p0, what, mesh)
    for mode, chunk, ckpt in inputs.get("runs", []):
        res[f"rounds:{mode}:{chunk}"] = run_rounds(
            p0, mode, chunk, mesh,
            os.path.join(out, f"{mode}.msgpack") if ckpt else None)
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()
