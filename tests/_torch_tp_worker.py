"""The process body of ``tests/test_torch_tensor_parallel.py``: one rank of
a gloo job on the CPU, launched as ``torchrun`` would launch it.  It
imports torch and the port only, never JAX: the parent hands it JAX's
parameters (bridged) and inputs in ``<out>/inputs.pt``, and compares
what each rank writes to ``<out>/rank<r>.pt``.

Jobs by world size (the mesh is (world / model, model)):

  * 2, model 2 — the autograd Functions against the unsharded
    computation (value, ``grad``, ``jvp`` of ``grad``, ``vmap``), the
    vocab-split cross-entropy and argmax, the model (loss, gradient, one
    ``uga_update`` on smollm-360m-smoke's shards), the (1, 2) rounds, a
    checkpoint, the layer kinds that build and the buffered-async
    runtime's refusal;
  * 3, model 3 — the model (M = 3 leaves ``wk``/``wv``, the MLP and the
    vocab whole);
  * 4, model 2 — the (2, 2) rounds.
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
# (world, model) -> the round cases: (optimizer, chunk)
ROUND_CASES = {(2, 2): [("sgd", 1), ("adam", 2)],
               (4, 2): [("sgd", 2), ("adam", 1)]}
MODEL_JOBS = {(2, 2), (3, 3)}


def warm_adam(rows):
    """A warm adam state (t = 5, random m, v > 0), the same on every
    rank and in the parent."""
    rng = np.random.default_rng(5)
    m = (0.01 * rng.standard_normal((rows, 128))).astype(np.float32)
    v = (1e-3 * rng.random((rows, 128)) + 1e-4).astype(np.float32)
    return {"m": (torch.from_numpy(m),), "v": (torch.from_numpy(v),),
            "t": torch.tensor(5, dtype=torch.int32)}


def run_rounds(p0, opt, chunk, mesh=None, ckpt=None):
    """ROUNDS rounds of the trainer from ``p0`` (adam warm); returns
    (state, history)."""
    from repro_torch.configs import FedConfig, get_arch
    from repro_torch.core.flat import make_flat_spec
    from repro_torch.core.trainer import FederatedTrainer
    from repro_torch.launch.train import build_synthetic_fed_data
    from repro_torch.models.model import build_model
    fed = FedConfig(**FED, server_opt=opt, cohort_chunk=chunk)
    tt = FederatedTrainer(build_model(get_arch(SMOKE), loss_chunk=256), fed,
                          device="cpu", params=p0, mesh=mesh)
    if opt == "adam":
        tt.state["opt"] = warm_adam(make_flat_spec(p0).groups[0].rows)
    hist = tt.run(build_synthetic_fed_data(get_arch(SMOKE), **DATA),
                  rounds=ROUNDS, cohort=COHORT, batch=BATCH,
                  meta_batch=2 * BATCH)
    if ckpt is not None and tt.is_main:
        tt.save(ckpt)
    return tt.state, hist


def functions(axis):
    """Each collective Function against the unsharded computation: values
    and the derivatives of f(W1, W2, x) = sum(tanh(x W1) W2)^2, where W1's
    columns and W2's rows split over the axis, in two forms (copy /
    reduce; gather / split), their grad, the jvp of their grad (an HVP)
    and a vmap over a batch of x; then the vocab-split cross-entropy and
    the argmax's first-index rule across processes."""
    from torch.func import grad, jvp, vmap
    from repro_torch.sharding import tensor_parallel as TP
    rng = np.random.default_rng(3)
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(
        np.float32))
    W1, W2, x, xs = t(6, 8), t(8, 6), t(3, 6), t(5, 3, 6)
    dW1, dW2 = t(6, 8), t(8, 6)
    n, c = axis.size, axis.coord
    w1, w2 = W1[:, c * 8 // n:(c + 1) * 8 // n], W2[c * 8 // n:(c + 1) * 8 // n]
    d1, d2 = dW1[:, c * 8 // n:(c + 1) * 8 // n], dW2[c * 8 // n:(c + 1) * 8 // n]

    def ref(a, b, x):
        return torch.sum((torch.tanh(x @ a) @ b) ** 2)

    def f_reduce(a, b, x):
        return torch.sum(axis.reduce(torch.tanh(axis.copy(x) @ a) @ b) ** 2)

    def f_gather(a, b, x):
        h = axis.gather(torch.tanh(axis.copy(x) @ a), -1)
        return torch.sum(axis.reduce(axis.split(h, -1) @ b) ** 2)

    out = {"ref": {}, "tp": {}}
    for name, f in (("reduce", f_reduce), ("gather", f_gather)):
        hvp = lambda fn, a, b, da, db, x: jvp(
            lambda a_, b_: grad(fn, argnums=(0, 1, 2))(a_, b_, x),
            (a, b), (da, db))[1]
        out["tp"][name] = {
            "value": f(w1, w2, x),
            "grad": grad(f, argnums=(0, 1, 2))(w1, w2, x),
            "hvp": hvp(f, w1, w2, d1, d2, x),
            "vmap": vmap(lambda x_: grad(f, argnums=(0, 1))(w1, w2, x_))(xs),
            "vmap_hvp": vmap(lambda x_: hvp(f, w1, w2, d1, d2, x_))(xs)}
    out["ref"] = {
        "value": ref(W1, W2, x), "grad": grad(ref, argnums=(0, 1, 2))(
            W1, W2, x),
        "hvp": jvp(lambda a_, b_: grad(ref, argnums=(0, 1, 2))(a_, b_, x),
                   (W1, W2), (dW1, dW2))[1],
        "vmap": vmap(lambda x_: grad(ref, argnums=(0, 1))(W1, W2, x_))(xs),
        "vmap_hvp": vmap(lambda x_: jvp(
            lambda a_, b_: grad(ref, argnums=(0, 1, 2))(a_, b_, x_),
            (W1, W2), (dW1, dW2))[1])(xs)}
    # the vocab-split cross-entropy and argmax: a tie between the two
    # halves' maxima at position 0 (index 3 and V/2 + 3), which the first
    # index rule gives to 3
    V = 8 * n
    h, head = t(2, 3, 4), t(4, V)
    head[:, 3] = 5 * h[0, 0]
    head[:, V // 2 + 3] = head[:, 3]
    labels = torch.tensor([[3, 1, V - 1], [0, V // 2, 5]])
    mask = torch.tensor([[1.0, 1.0, 1.0], [1.0, 0.0, 1.0]])
    loc = head[:, c * V // n:(c + 1) * V // n]
    nll, hit = TP.vocab_xent(h, loc, labels, mask, axis)
    g = grad(lambda hh, w: TP.vocab_xent(hh, w, labels, mask, axis)[0],
             argnums=(0, 1))(h, loc)
    out["xent"] = {"nll": nll, "hit": hit, "grad_h": g[0], "grad_w": g[1],
                   "h": h, "head": head, "labels": labels, "mask": mask}
    return out


def model(inputs, mesh, axis):
    """smollm-360m-smoke's loss, gradient and one UGA update on this
    rank's shards of JAX's parameters; the gradients gathered whole."""
    from functools import partial
    from repro_torch.configs import get_arch
    from repro_torch.core.client import uga_update
    from repro_torch.models.model import build_model
    from repro_torch.sharding.tensor_parallel import (gather_params,
                                                      shard_params)
    m = build_model(get_arch(SMOKE), loss_chunk=256)
    loc = shard_params(inputs["p0"], mesh)
    batch = {"tokens": inputs["tokens"]}
    loss = partial(m.loss, tp=axis)
    value, metrics = loss(loc, batch)
    g = torch.func.grad(lambda w: loss(w, batch)[0])(loc)
    G, l_eval = uga_update(loss, loc, batch, 0.05)
    whole = gather_params(loc, mesh, inputs["p0"])
    return {"loss": value, "metrics": metrics,
            "grad": axis.gather_params(g), "uga": axis.gather_params(G),
            "uga_loss": l_eval, "shapes": {k: tuple(v.shape)
                                           for k, v in loc.items()},
            "gather_bitwise": all(torch.equal(whole[k], inputs["p0"][k])
                                  for k in whole)}


def refusals(mesh, p0):
    """What the model axis builds and what still refuses on it: the
    layer kinds, through_aggregation, a lossy codec and legacy_tree build
    (``"accepted"``); the buffered-async runtime raises JAX's
    ValueError (its replicated delta pool)."""
    from repro_torch.configs import FedConfig, get_arch
    from repro_torch.core.round import make_federated_round
    from repro_torch.models.model import build_model
    dense = build_model(get_arch(SMOKE))
    cases = {
        "mamba": (build_model(get_arch("mamba2-780m-smoke")), {}),
        "moe": (build_model(get_arch("llama4-scout-17b-a16e-smoke")), {}),
        "mla": (build_model(get_arch("deepseek-v2-lite-16b-smoke")), {}),
        "encoder": (build_model(get_arch("whisper-large-v3-smoke")), {}),
        "through_aggregation": (dense, {"meta_mode": "through_aggregation"}),
        "codec": (dense, {"codec": "int8"}),
        "buffered_async": (dense, {"engine": "buffered_async"}),
        "legacy_tree": (dense, {"fused_update": False}),
    }
    out = {}
    for name, (mdl, kw) in cases.items():
        fed = FedConfig(**{**FED, "cohort_chunk": 2, **kw})
        try:
            make_federated_round(mdl, fed, mesh=mesh)
            out[name] = "accepted"
        except (NotImplementedError, ValueError) as e:
            out[name] = str(e)
    return out


def main(rank: int, world: int, model_size: int, port: int,
         out: str) -> None:
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    import _torch_parity  # noqa: F401  (one torch thread a rank)
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_auto_mesh
    from repro_torch.sharding.tensor_parallel import model_axis

    inputs = torch.load(os.path.join(out, "inputs.pt"), weights_only=False)
    mesh = make_auto_mesh(model_size, device="cpu")
    axis = model_axis(mesh, inputs["p0"])
    res = {"mesh": (dict(mesh.shape), dict(mesh.coords))}
    if (world, model_size) == (2, 2):
        res["functions"] = functions(axis)
        res["refusals"] = refusals(mesh, inputs["p0"])
    if (world, model_size) in MODEL_JOBS:
        res["model"] = model(inputs, mesh, model_axis(mesh, inputs["p0"]))
    for opt, chunk in ROUND_CASES.get((world, model_size), []):
        ckpt = (os.path.join(out, "ckpt.msgpack")
                if (opt, chunk) == ("sgd", 1) else None)
        res[f"rounds:{opt}:{chunk}"] = run_rounds(inputs["p0"], opt, chunk,
                                                 mesh, ckpt)
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()
