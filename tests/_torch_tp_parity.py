"""Shared pieces of the layer-kind tests of the model axis
(``test_torch_tp_layers.py``, ``test_torch_tp_mamba.py``,
``test_torch_tp_rounds.py``, ``test_torch_tp_encoder.py``): JAX's reference for one smoke config, in
two parts (:func:`prepare`, what the ranks need; :func:`complete`, the
rest, computed while they run), the gloo job of ranks
(``_torch_tp_layers_worker.py``, which imports no JAX), and the checks
every architecture is held to.

Tolerances, max |a-b| over max |b| per leaf: the loss and metrics 1e-6 of
JAX's; the gradient 1e-5 of JAX's and of the unsharded port's; one
``uga_update`` 1e-4 of JAX's and 1e-5 of the unsharded port's;
``gather_params`` of the shards bitwise the parameters.  An architecture
prepared with ``pin`` is held with its update's first
local step pinned to JAX's,
in every process and in the unsharded reference alike, and its gradient
to 1e-5 of the unsharded port's and 1e-4 of JAX's (the JAX suite's
tolerance): see ``test_torch_tp_mamba.py``.
"""
import socket

import jax
import jax.numpy as jnp
import numpy as np
import torch

import _torch_tp_layers_worker as W
from _torch_parity import jax_params_to_torch, max_tree_rel_err, routes_jax
from repro.configs import get_arch as jax_get_arch
from repro.core import client as JCL
from repro.models.model import build_model as jax_build_model
from repro_torch.configs import get_arch
from repro_torch.core import client as TC
from repro_torch.models.model import build_model


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _pinned_update(tm, tp, tb, w1):
    orig = TC._sgd
    TC._sgd = lambda w, g, lr: w1
    try:
        return TC.uga_update(tm.loss, tp, tb, W.LR)
    finally:
        TC._sgd = orig


def prepare(name, seed, *, pin=False):
    """What the ranks need of ``name``'s smoke config: JAX's parameters
    (bridged), a batch made with numpy (``enc_embeds`` where the config
    has an encoder) and, with ``pin``, JAX's first local step (SGD on the
    first of the two microbatches)."""
    cfg = jax_get_arch(name)
    jm = jax_build_model(cfg, dtype=jnp.float32, loss_chunk=256)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, 512, (2, 17)).astype(np.int32)}
    if cfg.encoder is not None:
        batch["enc_embeds"] = rng.standard_normal(
            (2, cfg.encoder.enc_len, cfg.encoder.enc_dim)).astype(np.float32)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tb["tokens"] = tb["tokens"].long()
    ref = dict(name=name, cfg=cfg, jm=jm, jp=jp, jb=jb, batch=tb,
               p0=jax_params_to_torch(jp), w1=None,
               vg=jax.jit(jax.value_and_grad(jm.loss, has_aux=True)))
    if pin:
        _, g0 = ref["vg"](jp, {k: v[:1] for k, v in jb.items()})
        ref["w1"] = jax_params_to_torch(jax.tree.map(
            lambda a, b: a - W.LR * b, jp, g0))
    return ref


def complete(ref):
    """JAX's loss, metrics, gradient, routing and one UGA update (a jit
    of value-and-grad, one of the update and, with MoE, one of the loss),
    the port's unsharded gradient and update (pinned too where
    :func:`prepare` pinned), into ``ref``; returns it."""
    jm, jp, jb, tb = ref["jm"], ref["jp"], ref["jb"], ref["batch"]
    (loss, metrics), g = ref["vg"](jp, jb)
    # the routing of one forward (the gradient's rematerialized forward
    # would route every layer twice)
    jrecs = (routes_jax(lambda: jax.jit(jm.loss)(jp, jb))[1]
             if ref["cfg"].moe is not None else [])
    G, l_eval = jax.jit(lambda w: JCL.uga_update(jm.loss, w, jb, W.LR))(jp)
    tm = build_model(get_arch(ref["name"]), loss_chunk=256)
    tp = ref["p0"]
    ref.update(
        loss=float(loss), metrics={k: float(v) for k, v in metrics.items()},
        grad=jax_params_to_torch(g), routes=jrecs,
        uga=(jax_params_to_torch(G), float(l_eval)), tm=tm,
        port_uga=TC.uga_update(tm.loss, tp, tb, W.LR),
        port_grad=torch.func.grad(lambda w: tm.loss(w, tb)[0])(tp))
    if ref["w1"] is not None:
        ref["port_pinned"] = _pinned_update(tm, tp, tb, ref["w1"])
    return ref


def start(world, model, tmp, archs, forms=None, rounds=(), p0=None):
    """Start a gloo job of ``world`` ranks on a (world / model, model)
    mesh over ``archs`` (:func:`prepare`'s dicts), MoE loss in each of
    ``forms[name]``'s dispatch forms, then ``rounds`` ((name, chunk)
    pairs, from ``p0[name]``, by default the arch's parameters).  The
    parent goes on (the JAX references) while they run; :func:`join`
    waits and returns each rank's results."""
    forms = forms or {}
    p0 = p0 or {a["name"]: a["p0"] for a in archs}
    torch.save({"archs": [dict(name=a["name"], p0=a["p0"], batch=a["batch"],
                               w1=a["w1"],
                               forms=forms.get(a["name"], ("gather",)))
                          for a in archs],
                "rounds": list(rounds), "p0": p0},
               tmp / "inputs.pt")
    ctx = torch.multiprocessing.start_processes(
        W.main, args=(world, model, _free_port(), str(tmp)), nprocs=world,
        join=False, start_method="spawn")
    return ctx, tmp, world


def join(job):
    ctx, tmp, world = job
    while not ctx.join():
        pass
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def hold_model(ranks, ref):
    """Every rank's loss, metrics, gradient, update and gather against
    JAX's and the unsharded port's (the module docstring's
    tolerances)."""
    name = ref["name"]
    pinned = ref["w1"] is not None
    for res in ranks:
        r = res[name]
        assert r["gather_bitwise"]
        value, metrics, _ = r["loss:gather"]
        assert abs(float(value) - ref["loss"]) <= 1e-6 * abs(ref["loss"])
        for k, v in ref["metrics"].items():
            assert abs(float(metrics[k]) - v) <= 1e-6 * max(abs(v), 1.0), k
        assert max_tree_rel_err(r["grad"], ref["port_grad"]) <= 1e-5
        assert max_tree_rel_err(r["grad"], ref["grad"]) <= (
            1e-4 if pinned else 1e-5)
        G, l_eval = r["pinned" if pinned else "uga"]
        port_G, port_l = ref["port_pinned" if pinned else "port_uga"]
        assert max_tree_rel_err(G, port_G) <= 1e-5
        assert abs(float(l_eval) - float(port_l)) <= 1e-6 * abs(
            float(port_l))
        assert max_tree_rel_err(G, ref["uga"][0]) <= 1e-4
        assert abs(float(l_eval) - ref["uga"][1]) <= 1e-5 * abs(
            ref["uga"][1])


def leaves(tree, prefix=""):
    """(path, leaf) of a nested state, in a fixed order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in leaves(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (tuple, list)):
        return [x for i, t in enumerate(tree)
                for x in leaves(t, f"{prefix}/{i}")]
    return [(prefix, tree)]
