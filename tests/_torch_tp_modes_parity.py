"""Shared pieces of the tests of the modes on the mesh's model axis
(``test_torch_tp_meta.py``, ``test_torch_tp_legacy.py``,
``test_torch_tp_codecs*.py``): JAX's parameters, the gloo jobs of ranks
(``_torch_tp_modes_worker.py``, which imports no JAX), JAX's unsharded
trainer under a mode, and the checks every run is held to.

Tolerances (ROADMAP's): metrics 1e-4 relative; parameters, optimizer
slots and ``ctrl`` 1e-5 of max |b| per leaf; under a lossy codec the
parameters and the error-feedback residuals by the flip-aware criterion
of ``test_torch_comm_rounds.py`` (FLIP_FRACTION, FLIP_CAP: a code at a
rounding boundary, a sign near 0 or a topk pick at the threshold may
move with the last bits of a client's gradient, which sharded compute
moves by about 1e-7); every rank's state and history bitwise the same.
"""
import socket

import jax
import jax.numpy as jnp
import numpy as np
import torch

import _torch_tp_modes_worker as W
from _torch_parity import jax_params_to_torch, max_tree_rel_err, rel_err
from repro.configs import FedConfig as JaxFedConfig
from repro.configs import get_arch as jax_get_arch
from repro.core import FederatedTrainer as JaxTrainer
from repro.launch.train import build_synthetic_fed_data as jax_fed_data
from repro.models.model import build_model as jax_build_model
from test_torch_comm_rounds import FLIP_CAP, flip_aware

TOL, TOL_METRIC = 1e-5, 1e-4
CTRL_KEYS = ("w_logits", "log_lr")


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def jax_init():
    """JAX's smollm-360m-smoke init (seed 2): (JAX's tree, the port's
    dict)."""
    jm = jax_build_model(jax_get_arch(W.SMOKE), dtype=jnp.float32,
                         loss_chunk=256)
    jp = jm.init(jax.random.PRNGKey(2))
    return jp, jax_params_to_torch(jp)


def start(world, model, tmp, p0, *, runs=(), probes=()):
    """Start a gloo job of ``world`` ranks on a (world / model, model)
    mesh: ``runs`` ((mode, chunk, ckpt) triples) and ``probes``.  The
    parent goes on while they run; :func:`join` waits and returns each
    rank's results."""
    torch.save({"p0": p0, "runs": list(runs), "probes": list(probes)},
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


def run_modes(tmp_path_factory, name, runs_1x2, runs_2x2=(), probes=()):
    """Start the (1, 2) job over ``runs_1x2`` and ``probes`` and the (2, 2)
    job over ``runs_2x2`` (if any), compute the references while they
    run, join them.  Returns ({"1x2": ranks, "2x2": ranks}, {mode: JAX's
    reference}, {(mode, chunk): the port's world of one}, {probe: its
    world of one}, the checkpoints' directory)."""
    jp, p0 = jax_init()
    tmp = tmp_path_factory.mktemp(f"{name}_1x2")
    jobs = {"1x2": start(2, 2, tmp, p0, runs=runs_1x2, probes=probes)}
    if runs_2x2:
        jobs["2x2"] = start(4, 2, tmp_path_factory.mktemp(f"{name}_2x2"),
                            p0, runs=runs_2x2)
    runs = list(runs_1x2) + list(runs_2x2)
    jax_ref = {mode: jax_rounds(mode, jp)
               for mode in dict.fromkeys(m for m, _, _ in runs)}
    port = {(mode, chunk): port_reference(*W.run_rounds(p0, mode, chunk))
            for mode, chunk, _ in runs}
    probed = {what: W.probe(p0, what) for what in probes}
    return ({k: join(j) for k, j in jobs.items()}, jax_ref, port, probed,
            tmp)


def jax_rounds(mode, jp):
    """JAX's unsharded trainer, ``W.ROUNDS`` rounds under ``mode`` from
    ``jp`` (adam from the warm state): (history, params, opt, ctrl, comm)
    on the host."""
    kw = {**W.FED, **W.MODES[mode]}
    jt = JaxTrainer(jax_build_model(jax_get_arch(W.SMOKE), dtype=jnp.float32,
                                    loss_chunk=256), JaxFedConfig(**kw),
                    seed=0)
    # a copy: the trainer donates its state's buffers
    jt.state["params"] = jax.tree.map(lambda x: jnp.array(x, copy=True), jp)
    if kw["server_opt"] == "adam":
        warm = W.warm_adam(jt.state["opt"]["m"][0].shape[0])
        jt.state["opt"] = {k: (tuple(jnp.asarray(x.numpy()) for x in v)
                               if k != "t" else jnp.asarray(5, jnp.int32))
                           for k, v in warm.items()}
    hist = jt.run(jax_fed_data(jax_get_arch(W.SMOKE), **W.DATA),
                  rounds=W.ROUNDS, cohort=W.COHORT, batch=W.BATCH,
                  meta_batch=2 * W.BATCH)
    host = lambda t: jax.tree.map(np.asarray, t)
    opt = {k: v for k, v in host(jt.state["opt"]).items()
           if k in ("m", "v")} if isinstance(jt.state["opt"], dict) else {}
    return (hist, jax_params_to_torch(jt.state["params"]), opt,
            host(jt.state.get("ctrl")), host(jt.state.get("comm")))


def port_reference(state, hist):
    """The port's world of one in :func:`jax_rounds`' form."""
    opt = {k: v for k, v in state["opt"].items() if k in ("m", "v")}
    return hist, state["params"], opt, state.get("ctrl"), state.get("comm")


def _slot(opt, slot):
    """An optimizer slot as a list of arrays: the flat engine's tuple of
    group buffers, or the tree engine's dict, in name order."""
    v = opt[slot]
    return [v[k] for k in sorted(v)] if isinstance(v, dict) else list(v)


def hold_run(state, hist, ref, mode, what):
    """One run's state and history against a reference of
    :func:`jax_rounds`' form; returns the flip counts (parameters,
    residuals)."""
    ref_hist, ref_params, ref_opt, ref_ctrl, ref_comm = ref
    assert [r["round"] for r in hist] == list(range(W.ROUNDS))
    for tr, jr in zip(hist, ref_hist):
        assert set(tr) == set(jr), (what, set(tr) ^ set(jr))
        for k in set(jr) - {"round"}:
            assert abs(tr[k] - jr[k]) <= TOL_METRIC * abs(jr[k]), \
                (what, k, tr[k], jr[k])
    codec = W.MODES[mode].get("codec")
    n_p = n_r = 0
    if codec is None:
        assert max_tree_rel_err(state["params"], ref_params) <= TOL, what
    else:
        for k, b in ref_params.items():
            scale = float(torch.as_tensor(b).abs().max())
            n_p += flip_aware(state["params"][k], b, ref_scale=scale,
                              cap=FLIP_CAP * scale, what=(what, k))
    for slot in ref_opt:
        for a, b in zip(_slot(state["opt"], slot), _slot(ref_opt, slot)):
            assert rel_err(a, b) <= TOL, (what, slot)
    if ref_ctrl is not None:
        for k in CTRL_KEYS:
            assert rel_err(state["ctrl"][k], ref_ctrl[k]) <= TOL, (what, k)
    if ref_comm is not None:
        # int8: |r| <= amax(e) / 254, held against the size of e; a flip
        # moves a residual by one codec step, at most once a round
        res = np.asarray(state["comm"]["residual"][0])
        ref_res = np.asarray(ref_comm["residual"][0])
        r_max = float(np.max(np.abs(ref_res)))
        n_r = flip_aware(
            res, ref_res, ref_scale=r_max * (254 if codec == "int8" else 1),
            cap=W.ROUNDS * 2 * r_max * (1 + TOL), what=(what, "residual"))
    return n_p, n_r


def leaves(tree, prefix=""):
    """(path, leaf) of a nested state, in a fixed order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in leaves(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (tuple, list)):
        return [x for i, t in enumerate(tree)
                for x in leaves(t, f"{prefix}/{i}")]
    return [(prefix, tree)]


def hold_ranks_equal(ranks, key):
    """Every rank's state and history of ``key`` bitwise rank 0's."""
    state, hist = ranks[0][key]
    for res in ranks[1:]:
        other, ohist = res[key]
        assert ohist == hist, key
        for (n, a), (_, b) in zip(leaves(other), leaves(state)):
            assert torch.equal(torch.as_tensor(a), torch.as_tensor(b)), \
                (key, n)


def codec_rounds_test(run, mesh, mode, chunk, against):
    """``test_torch_tp_codecs*.py``'s round test: rank 0's run against
    JAX's trainer or the port's world of one, the ranks bitwise equal;
    prints the flip counts (``-s``)."""
    ranks, jax_ref, port = run[0][mesh], run[1], run[2]
    key = f"rounds:{mode}:{chunk}"
    ref = jax_ref[mode] if against == "jax" else port[(mode, chunk)]
    state, hist = ranks[0][key]
    n_p, n_r = hold_run(state, hist, ref, mode, (mesh, key, against))
    print(f"{mesh} {key} against {against}: parameter elements off by more "
          f"than 1e-5: {n_p} of "
          f"{sum(v.numel() for v in state['params'].values())}; residual "
          f"elements: {n_r}")
    hold_ranks_equal(ranks, key)
