"""The chunked streaming cohort (``cohort_chunk``, the ``chunked``
executor) in the port against the JAX package, and its invariants within
the port.

The model is a small MLP written for both packages (the JAX suite's
``tests/test_chunked_executor.py`` model), so each JAX round compiles in
seconds: three JAX compiles in this file (post, through_aggregation, int8
+ error feedback, each at cohort 5, chunk 3 — the ragged case).
Parameters start from the JAX init; inputs are numpy.

Tolerances, max |a-b| over max |b| per array: against JAX, parameters
and ctrl 1e-5, metrics 1e-4 (the JAX suite's across engines), the int8
error-feedback residuals 1e-5 of the encoded gradient's size (``e -
decode(encode(e))`` is a cancellation, held as
``test_torch_comm_round.py`` holds it).  Within the port the
accumulation order is exact, so:

  * chunk = 1 equals the scan cohort bitwise (it runs each client
    unbatched, under the scan's grad mode);
  * chunk 3 equals chunk = cohort bitwise (both ``torch.func.vmap`` their
    clients);
  * chunk 1 against a vmapped chunk: the aggregate is held to 1e-6, the
    rounds built on it to the JAX tolerances.  On the CPU the client's
    weight-gradient product under vmap is ``torch.bmm``, whose kernel at
    a reduction length of 4 (a local step's microbatch of 4 rows) gives
    other last bits than the unbatched ``torch.mm`` (ROADMAP Queue 3 item
    6; ``test_vmap_width_changes_only_bmm_bits`` pins the op); the
    hypergradient metrics amplify that (``ctrl_lr_grad`` 1.7e-6 apart);
  * chunk = cohort against the vmap executor 1e-5, as the JAX suite holds
    it (the aggregate kernel sums in another order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import rel_err
from repro.configs import FedConfig as JaxFedConfig
from repro.core.round import init_server_state as jax_init_state
from repro.core.round import make_federated_round as jax_make_round
from repro.models.model import Model as JaxModel
from repro_torch.configs import FedConfig
from repro_torch.core.executors import get_executor, resolve_executor
from repro_torch.core.round import (draw_round, init_server_state,
                                    make_federated_round)
from repro_torch.models.model import Model

COHORT = 5          # chunk 3 is the ragged case: 5 % 3 != 0
TOL = 1e-5
TOL_METRIC = 1e-4
TOL_VMAP_WIDTH = 1e-6


def _jax_mlp():
    def init(k):
        k1, k2 = jax.random.split(k)
        return {"w1": jax.random.normal(k1, (10, 16)) * 0.3,
                "w2": jax.random.normal(k2, (16, 4)) * 0.3}

    def loss(w, batch, rng=None):
        logits = jnp.tanh(batch["x"] @ w["w1"]) @ w["w2"]
        return -jnp.mean(jnp.take_along_axis(
            jax.nn.log_softmax(logits), batch["y"][:, None], 1)), {}

    return JaxModel(name="mlp", init=init, loss=loss)


def _torch_mlp():
    def loss(w, batch, rng=None):
        logits = torch.tanh(batch["x"] @ w["w1"]) @ w["w2"]
        return -torch.mean(torch.gather(
            torch.log_softmax(logits, -1), 1, batch["y"][:, None])), {}

    return Model(name="mlp", init=None, loss=loss)


def _inputs(seed=0, cohort=COHORT, b=8):
    rng = np.random.default_rng(seed)
    batch = {"x": rng.normal(0, 1, (cohort, b, 10)).astype(np.float32),
             "y": rng.integers(0, 4, (cohort, b)).astype(np.int32)}
    meta = {"x": rng.normal(0, 1, (8, 10)).astype(np.float32),
            "y": rng.integers(0, 4, 8).astype(np.int32)}
    wts = rng.uniform(1.0, 5.0, cohort).astype(np.float32)
    return batch, meta, wts


def _kw(chunk=None, *, mode="post", cohort=COHORT, **kw):
    return dict(algorithm="uga", meta=True, cohort=cohort, local_steps=2,
                client_lr=0.05, server_lr=0.1, meta_lr=0.05, clip_norm=1.0,
                lr_decay=0.9, fused_update=True, meta_mode=mode,
                cohort_chunk=chunk, **kw)


def _t(batch):
    return {k: (torch.from_numpy(v) if v.dtype.kind == "f"
                else torch.from_numpy(v).long()) for k, v in batch.items()}


def _params0():
    return _jax_mlp().init(jax.random.PRNGKey(0))


def _run_port(fed, *, rounds=2, wts=None, draws=False, **round_kw):
    """Chained rounds of the port from the JAX init -> (state, metrics of
    every round, as numpy)."""
    batch, meta, w = _inputs(cohort=fed.cohort)
    w = w if wts is None else wts
    params = {k: torch.from_numpy(np.array(v)) for k, v in _params0().items()}
    state = init_server_state(_torch_mlp(), fed, params=params)
    rf = make_federated_round(_torch_mlp(), fed, **round_kw)
    hist = []
    for r in range(rounds):
        d = draw_round(fed, 0, r, fed.cohort) if draws else None
        state, m = rf(state, _t(batch), _t(meta), torch.from_numpy(w), d)
        hist.append({k: np.asarray(v.detach() if isinstance(v, torch.Tensor)
                                   else v, np.float32)
                     for k, v in m.items()})
    return state, hist


def _run_jax(fed, rounds=2):
    model = _jax_mlp()
    batch, meta, wts = _inputs(cohort=fed.cohort)
    key = jax.random.PRNGKey(0)
    state = jax_init_state(model, fed, key)
    state = {**state, "params": _params0()}
    rf = jax.jit(jax_make_round(model, fed))
    hist = []
    for r in range(rounds):
        state, m = rf(state, jax.tree.map(jnp.asarray, batch),
                      jax.tree.map(jnp.asarray, meta), jnp.asarray(wts),
                      jax.random.fold_in(key, r))
        hist.append({k: np.asarray(v) for k, v in m.items()})
    return state, hist


def _leaves(tree, prefix=""):
    """(name, array) of a server state's tensors, in name order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _leaves(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (tuple, list)):
        return [x for i, t in enumerate(tree)
                for x in _leaves(t, f"{prefix}/{i}")]
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree.detach().numpy())]
    return [(prefix, np.asarray(tree))]


def _assert_bitwise(a, b):
    (sa, ha), (sb, hb) = a, b
    la, lb = _leaves(sa), _leaves(sb)
    assert [n for n, _ in la] == [n for n, _ in lb]
    for (n, x), (_, y) in zip(la, lb):
        np.testing.assert_array_equal(x, y, err_msg=n)
    for ma, mb in zip(ha, hb):
        assert sorted(ma) == sorted(mb)
        for k in ma:
            np.testing.assert_array_equal(ma[k], mb[k], err_msg=k)


def _residual_err(x, y):
    """An int8 error-feedback residual's error, over the size of the
    encoded gradient (max |e| = 254 max |r|)."""
    return rel_err(x, y) / 254


def _assert_close(a, b, tol, tol_metric):
    (sa, ha), (sb, hb) = a, b
    la, lb = _leaves(sa), _leaves(sb)
    assert [n for n, _ in la] == [n for n, _ in lb]
    for (n, x), (_, y) in zip(la, lb):
        e = (_residual_err(x, y) if n.startswith("/comm/residual")
             else rel_err(x, y))
        assert e <= tol, (n, e)
    for ma, mb in zip(ha, hb):
        assert sorted(ma) == sorted(mb)
        for k in ma:
            assert rel_err(ma[k], mb[k]) <= tol_metric, (k, ma[k], mb[k])


CASES = {"post": dict(), "through_aggregation": dict(
    mode="through_aggregation"), "int8+ef": dict(codec="int8",
                                                 error_feedback=True)}


@pytest.mark.parametrize("case", list(CASES))
def test_chunked_round_matches_jax(case):
    """Two chained rounds at cohort 5, chunk 3 (one weight-0 pad slot):
    params, opt, ctrl, the error-feedback residuals and every metric."""
    kw = _kw(3, **CASES[case])
    t_state, t_hist = _run_port(FedConfig(**kw))
    j_state, j_hist = _run_jax(JaxFedConfig(**kw))
    for k in ("w1", "w2"):
        e = rel_err(t_state["params"][k], j_state["params"][k])
        assert e <= TOL, (k, e)
    if "ctrl" in j_state:
        for k in ("w_logits", "log_lr"):
            e = rel_err(t_state["ctrl"][k], j_state["ctrl"][k])
            assert e <= TOL, (k, e)
    if "comm" in j_state:
        # e - decode(encode(e)) is a cancellation: held against the size of
        # the encoded e (int8: max |e| = 254 max |r|), as
        # test_torch_comm_round.py holds residuals; no code flips here
        (tr,), (jr,) = t_state["comm"]["residual"], j_state["comm"]["residual"]
        assert tr.shape == jr.shape
        assert _residual_err(tr, jr) <= TOL, _residual_err(tr, jr)
    for tm, jm in zip(t_hist, j_hist):
        assert sorted(tm) == sorted(jm)
        for k in jm:
            assert rel_err(tm[k], jm[k]) <= TOL_METRIC, (k, tm[k], jm[k])


@pytest.mark.parametrize("case", list(CASES))
def test_chunk_sizes_agree(case):
    """Within the port: chunk 3 and chunk = cohort bitwise, chunk 1
    within the JAX tolerances (its aggregate within the vmap-width
    bound, below), chunk 1 bitwise the scan cohort."""
    kw = _kw(**CASES[case])
    outs = {c: _run_port(FedConfig(**{**kw, "cohort_chunk": c}))
            for c in (1, 3, COHORT)}
    _assert_bitwise(outs[3], outs[COHORT])
    _assert_close(outs[1], outs[3], TOL, TOL_METRIC)
    scan = _run_port(FedConfig(**{**kw, "cohort_strategy": "scan"}))
    _assert_bitwise(outs[1], scan)


@pytest.mark.parametrize("mode", ["post", "through_aggregation"])
def test_chunk_eq_cohort_matches_vmap(mode):
    """chunk = cohort against the vmap executor: the same math, summed in
    another order by the aggregate kernel."""
    a = _run_port(FedConfig(**_kw(COHORT, mode=mode)))
    b = _run_port(FedConfig(**_kw(None, mode=mode)))
    _assert_close(a, b, TOL, TOL_METRIC)


def test_ragged_pad_weighs_nothing():
    """The pad slot replicates client 0; with client 0 weighing 100 the
    ragged chunk 3 still equals chunk = cohort bitwise, so the pad added
    nothing to the mean."""
    w = _inputs()[2].copy()
    w[0] = 100.0
    _assert_bitwise(_run_port(FedConfig(**_kw(3)), rounds=1, wts=w),
                    _run_port(FedConfig(**_kw(COHORT)), rounds=1, wts=w))


@pytest.mark.parametrize("knobs", [dict(participation=0.6),
                                   dict(fault_profile="flaky"),
                                   dict(participation=0.6,
                                        fault_profile="flaky")],
                         ids=["participation", "flaky", "both"])
def test_draws_are_chunking_invariant(knobs):
    """The participation mask and fault streams are drawn before the
    executor runs (weights zeroed), so the counts and the state cannot
    depend on the chunk size."""
    kw = _kw(cohort=8, **knobs)
    outs = {c: _run_port(FedConfig(**{**kw, "cohort_chunk": c}),
                         draws=True, rounds=3) for c in (1, 3, 8)}
    _assert_bitwise(outs[3], outs[8])
    _assert_close(outs[1], outs[3], TOL, TOL_METRIC)
    counts = {"participants", "arrivals", "fault_crashed", "fault_dropped"}
    for r in range(3):
        got = counts & set(outs[8][1][r])
        assert got, sorted(outs[8][1][r])
        for k in got:
            assert outs[1][1][r][k] == outs[3][1][r][k] == outs[8][1][r][k]


@pytest.mark.parametrize("codec", ["none", "int8"])
def test_vmap_width_bound_on_the_aggregate(codec):
    """One cohort through the executor at chunk 1 (unbatched clients)
    and chunk 3 (vmapped): the Eq. (14) aggregate and the loss agree to
    1e-6."""
    fed = FedConfig(**_kw(codec=codec))
    batch, _, w = _inputs()
    params = {k: torch.from_numpy(np.array(v)) for k, v in _params0().items()}
    from repro_torch.comm import resolve_codec
    out = {}
    for c in (1, 3):
        exe = get_executor("chunked")(dataclasses.replace(fed, cohort_chunk=c))
        cu = lambda w_, b, lr, rng: _uga(w_, b, lr)  # noqa: E731
        if codec == "none":
            h, loss = exe.run(cu, params, _t(batch), torch.from_numpy(w), 0.05)
        else:
            h, loss, _ = exe.run_coded(cu, params, _t(batch),
                                       torch.from_numpy(w), 0.05,
                                       codec=resolve_codec(fed), comm=None)
        out[c] = (h.groups[0], loss)
    assert rel_err(out[1][0], out[3][0]) <= TOL_VMAP_WIDTH
    assert rel_err(out[1][1], out[3][1]) <= TOL_VMAP_WIDTH


def _uga(w, batch, lr):
    from repro_torch.core.client import uga_update
    return uga_update(_torch_mlp().loss, w, batch, lr, local_steps=2)


def test_vmap_width_changes_only_bmm_bits():
    """The op behind the 1e-6 bound: on the CPU ``torch.bmm`` at a
    reduction length of 4 gives other bits than ``torch.mm`` on the same
    rows, bounded by a few ulps, while at 8 it agrees."""
    rng = np.random.default_rng(0)
    worst = {}
    for k in (4, 8):
        a = torch.from_numpy(rng.normal(0, 1, (3, k, 16)).astype(np.float32))
        b = torch.from_numpy(rng.normal(0, 1, (3, k, 4)).astype(np.float32))
        batched = torch.bmm(a.transpose(1, 2), b)
        single = torch.stack([a[i].T @ b[i] for i in range(3)])
        worst[k] = rel_err(batched, single)
    assert worst[8] == 0.0
    assert worst[4] <= TOL_VMAP_WIDTH


def test_executors_and_resolution():
    fed = FedConfig(**_kw(3))
    for name in ("chunked", "scan", "sharded"):
        ex = get_executor(name)(fed)
        assert ex.supports_reweight
        assert "lossy" in ex.codec_capabilities
    assert resolve_executor(fed).name == "chunked"
    assert resolve_executor(FedConfig(**_kw(None))).name == "vmap"
    assert resolve_executor(FedConfig(**_kw(
        None, cohort_strategy="scan"))).name == "scan"
    assert resolve_executor(fed, executor="scan").name == "scan"
    with pytest.raises(ValueError, match="only the 'sharded' executor"):
        resolve_executor(fed, executor="chunked", mesh=object())
    with pytest.raises(ValueError, match="cohort_chunk"):
        make_federated_round(_torch_mlp(), dataclasses.replace(
            fed, meta=False, engine="buffered_async", async_buffer=2))


@pytest.mark.parametrize("kw", [
    dict(cohort_chunk=0), dict(cohort_chunk=-2),
    dict(cohort_chunk=2, cohort_strategy="scan"),
    dict(cohort_strategy="chunked"), dict(cohort_strategy="tree")],
    ids=["zero", "negative", "with-scan", "chunked-without-chunk",
         "unknown"])
def test_config_guards_as_in_jax(kw):
    with pytest.raises(ValueError) as ours:
        FedConfig(fused_update=True, **kw)
    with pytest.raises(ValueError) as ref:
        JaxFedConfig(fused_update=True, **kw)
    if "cohort_chunk" in kw:
        assert str(ours.value) == str(ref.value)
    if kw.get("cohort_strategy") == "scan":
        assert "cohort_chunk" in str(ours.value)
        assert "cohort_strategy" in str(ours.value)
    assert FedConfig(fused_update=True, cohort_chunk=7).cohort_chunk == 7


def test_cli_cohort_chunk(tmp_path):
    """``--executor chunked --cohort-chunk 1`` on the CPU gives the
    ``--strategy scan`` history."""
    import json
    from repro_torch.launch.train import main
    base = ["--arch", "smollm-360m-smoke", "--fused", "--rounds", "1",
            "--cohort", "2", "--client-batch", "4", "--seq", "8",
            "--device", "cpu", "--log-every", "0"]
    hist = {}
    for tag, extra in (("chunked", ["--executor", "chunked",
                                    "--cohort-chunk", "1"]),
                       ("scan", ["--strategy", "scan"])):
        out = tmp_path / f"{tag}.json"
        main(base + extra + ["--history-out", str(out)])
        hist[tag] = json.load(open(out))
    assert hist["chunked"] == hist["scan"] and len(hist["scan"]) == 1
