"""The ``legacy_tree`` engine — the tree-map server step with no kernel,
the fused engine's oracle — in the port against the JAX package:
``core/server_opt.py``, the tree form of Eq. (14) (``weighted_mean``,
``cohort_gradient`` on both strategies), ``LegacyTreeEngine.apply``, two
chained legacy rounds against JAX's ``make_federated_round`` with
``fused_update=False``, legacy against fused within the port, the
capability refusals, and the tree optimizer state's checkpoints.

The model is the small MLP of ``test_torch_faults.py`` (written for both
packages), so each JAX program compiles in about a second; parameters
start from the JAX init; inputs are numpy.  Tolerances, max |a-b| over
max |b| per array: parameters and optimizer state 1e-5, round metrics
1e-4 (the JAX suite's legacy-vs-fused tolerances,
``tests/test_fused_update.py:180-188``).  Adam runs from a warm state
(t = 5, random m, v > 0): from a cold start its step is about
lr * sign(G), unstable in the last ulp in both packages (ROADMAP Queue 3
item 1).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import max_tree_rel_err, rel_err
from repro import checkpoint as JC
from repro.configs import FedConfig as JaxFedConfig
from repro.core import aggregate as JA
from repro.core import server_opt as JS
from repro.core.algorithms import get_algorithm as jax_get_algorithm
from repro.core.engines import resolve_engine as jax_resolve_engine
from repro.core.executors import TreeAggregate as JaxTree
from repro.core.round import init_server_state as jax_init_state
from repro.core.round import make_federated_round as jax_make_round
from repro_torch import checkpoint as TC
from repro_torch.configs import FedConfig
from repro_torch.core import aggregate as TA
from repro_torch.core import flat as F
from repro_torch.core import server_opt as TS
from repro_torch.core.algorithms import get_algorithm
from repro_torch.core.engines import resolve_engine
from repro_torch.core.executors import TreeAggregate
from repro_torch.core.round import init_server_state, make_federated_round
from test_torch_faults import BASE, COHORT, _jax_mlp, _params0, _to_t
from test_torch_faults import _torch_mlp

TOL, TOL_METRIC = 1e-5, 1e-4
OPTS = ("sgd", "sgdm", "adam", "yogi")
LEGACY = dict(BASE, fused_update=False, clip_norm=1.0, lr_decay=0.9,
              server_lr=0.1, server_momentum=0.9)


def _inputs(seed=0, cohort=COHORT, b=8):
    rng = np.random.default_rng(seed)
    batch = {"x": rng.normal(0, 1, (cohort, b, 10)).astype(np.float32),
             "y": rng.integers(0, 4, (cohort, b)).astype(np.int32)}
    meta = {"x": rng.normal(0, 1, (8, 10)).astype(np.float32),
            "y": rng.integers(0, 4, 8).astype(np.int32)}
    wts = rng.uniform(1.0, 5.0, cohort).astype(np.float32)
    return batch, meta, wts


def _warm_tree(opt, params, seed):
    """A warm tree optimizer state (numpy): random m, v > 0, t = 5."""
    rng = np.random.default_rng(seed)
    m = {k: (0.01 * rng.standard_normal(v.shape)).astype(np.float32)
         for k, v in params.items()}
    v = {k: (1e-3 * rng.random(x.shape) + 1e-4).astype(np.float32)
         for k, x in params.items()}
    return {"sgd": {}, "sgdm": {"m": m},
            "adam": {"m": m, "v": v, "t": np.int32(5)},
            "yogi": {"m": m, "v": v, "t": np.int32(5)}}[opt]


def _jax_opt(opt_np):
    return jax.tree.map(jnp.asarray, opt_np)


def _torch_opt(opt_np):
    out = {}
    for k, v in opt_np.items():
        out[k] = (torch.tensor(int(v), dtype=torch.int32) if k == "t"
                  else {n: torch.from_numpy(x.copy()) for n, x in v.items()})
    return out


def _check_opt(topt, jopt):
    assert set(topt) == set(jopt)
    for k in topt:
        if k == "t":
            assert topt[k].dtype == torch.int32 and topt[k].dim() == 0
            assert int(topt[k]) == int(jopt[k])
        else:
            assert max_tree_rel_err(topt[k], jax.tree.map(
                np.asarray, jopt[k])) <= TOL, k


@pytest.mark.parametrize("opt", OPTS)
def test_server_opt_matches_jax(opt):
    """``init_state`` builds JAX's tree (fp32 slots, int32 ``t``) and one
    ``apply`` from a warm state gives JAX's params and state."""
    jp, tp = _params0()
    rng = np.random.default_rng(1)
    g = {k: (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
         for k, v in jp.items()}
    init_t, init_j = TS.init_state(opt, tp), JS.init_state(opt, jp)
    assert set(init_t) == set(init_j)
    if "t" in init_t:
        assert init_t["t"].dtype == torch.int32 and int(init_t["t"]) == 0
    opt_np = _warm_tree(opt, jp, 2)
    tnp, topt = TS.apply(opt, _torch_opt(opt_np), tp,
                         {k: torch.from_numpy(v) for k, v in g.items()}, 0.05,
                         momentum=0.9)
    jnp_, jopt = jax.jit(lambda s, p, gg: JS.apply(
        opt, s, p, gg, 0.05, momentum=0.9))(_jax_opt(opt_np), jp,
                                            _jax_opt(g))
    assert max_tree_rel_err(tnp, jax.tree.map(np.asarray, jnp_)) <= TOL
    _check_opt(topt, jopt)


@pytest.fixture(scope="module")
def jax_client_update():
    return jax_get_algorithm("uga").build(
        _jax_mlp().loss, local_steps=2, local_epochs=1, prox_mu=0.0,
        remat=True)


@pytest.mark.parametrize("strategy", ["vmap", "scan"])
def test_weighted_mean_and_cohort_gradient_match_jax(strategy,
                                                     jax_client_update):
    """``cohort_gradient`` on both strategies, and ``weighted_mean`` of the
    vmap form's stack, against JAX's over the same clients."""
    jp, tp = _params0()
    batch, _, wts = _inputs(3)
    jG, jl = jax.jit(lambda p, b, w: JA.cohort_gradient(
        jax_client_update, p, b, w, 0.05, None, strategy=strategy))(
        jp, jax.tree.map(jnp.asarray, batch), jnp.asarray(wts))
    cu = get_algorithm("uga").build(_torch_mlp().loss, local_steps=2,
                                    local_epochs=1, prox_mu=0.0)
    tG, tl = TA.cohort_gradient(cu, tp, _to_t(batch), torch.from_numpy(wts),
                                0.05, strategy=strategy)
    assert max_tree_rel_err(tG, jax.tree.map(np.asarray, jG)) <= TOL
    assert rel_err(tl, np.asarray(jl)) <= TOL_METRIC
    if strategy == "vmap":
        stack, _ = TA.cohort_gradient(cu, tp, _to_t(batch),
                                      torch.from_numpy(wts), 0.05,
                                      strategy="vmap", aggregate=False)
        assert all(torch.equal(a, b) for a, b in zip(
            TA.weighted_mean(stack, torch.from_numpy(wts)).values(),
            tG.values()))
        jm = JA.weighted_mean({k: jnp.asarray(v.numpy())
                               for k, v in stack.items()}, jnp.asarray(wts))
        assert max_tree_rel_err(TA.weighted_mean(
            stack, torch.from_numpy(wts)), jax.tree.map(np.asarray, jm)
        ) <= TOL
    else:
        with pytest.raises(NotImplementedError, match="scan"):
            TA.cohort_gradient(cu, tp, _to_t(batch), torch.from_numpy(wts),
                               0.05, strategy="scan", aggregate=False)


@pytest.mark.parametrize("opt,clip", [("sgd", 0.05), ("adam", 0.0),
                                      ("yogi", 10.0)])
def test_legacy_engine_apply_matches_jax(opt, clip):
    """``LegacyTreeEngine.apply`` (clip scale, fp32 cast, the optimizer)
    on one aggregate; clip 0.05 binds, 10 does not."""
    jp, tp = _params0()
    rng = np.random.default_rng(4)
    G = {k: (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
         for k, v in jp.items()}
    kw = dict(LEGACY, server_opt=opt, clip_norm=clip)
    opt_np = _warm_tree(opt, jp, 5)
    teng, jeng = resolve_engine(FedConfig(**kw)), jax_resolve_engine(
        JaxFedConfig(**kw))
    assert teng.name == jeng.name == "legacy_tree"
    assert teng.accepts == jeng.accepts == {"tree"}
    assert teng.meta_capabilities == jeng.meta_capabilities == {"post"}
    assert teng.codec_capabilities == jeng.codec_capabilities == {"none"}
    tnp, topt, tgn = teng.apply(
        tp, TreeAggregate({k: torch.from_numpy(v) for k, v in G.items()}),
        _torch_opt(opt_np), lr=0.1)
    jnp_, jopt, jgn = jax.jit(lambda p, g, s: jeng.apply(
        p, JaxTree(g), s, lr=0.1))(jp, _jax_opt(G), _jax_opt(opt_np))
    assert max_tree_rel_err(tnp, jax.tree.map(np.asarray, jnp_)) <= TOL
    assert rel_err(tgn, np.asarray(jgn)) <= TOL
    _check_opt(topt, jopt)


def _run_port(fed, opt_np=None, rounds=2):
    batch, meta, wts = _inputs()
    model = _torch_mlp()
    state = init_server_state(model, fed, params=_params0()[1])
    if opt_np is not None:
        state["opt"] = opt_np
    rf = make_federated_round(model, fed)
    hist = []
    for _ in range(rounds):
        state, m = rf(state, _to_t(batch), _to_t(meta),
                      torch.from_numpy(wts))
        hist.append({k: float(v) for k, v in m.items()})
    return state, hist


def _port_opt(fed, opt_np):
    """The warm numpy tree state in the form ``fed``'s engine keeps: the
    tree itself (legacy), or its flat buffers (fused)."""
    if opt_np == {} or not fed.fused_update:
        return _torch_opt(opt_np)
    spec = F.make_flat_spec(_params0()[1])
    t = _torch_opt(opt_np)
    return {k: (v if k == "t" else tuple(F.flatten_tree(spec, v)))
            for k, v in t.items()}


CASES = {"vmap-sgd": ("vmap", "sgd"), "scan-sgd": ("scan", "sgd"),
         "vmap-adam-warm": ("vmap", "adam"),
         "scan-adam-warm": ("scan", "adam")}


@pytest.mark.parametrize("case", list(CASES))
def test_two_legacy_rounds_match_jax(case):
    """Two chained legacy rounds (UGA + FedMeta post, clip 1.0) against
    JAX's ``make_federated_round(fused_update=False)``.  The JAX suite's
    own checks of this engine against its pre-registry round
    (``test_plugin_api.py::test_equivalence_matrix_bit_identical[False-
    scan-post-sgd]``) and against the fused round
    (``test_fused_update.py::test_fused_round_matches_legacy_round[adam]``)
    are among the reference's five failures (ROADMAP Queue 3 item 2);
    this compares with JAX's output under the tolerances instead."""
    strategy, opt = CASES[case]
    kw = dict(LEGACY, cohort_strategy=strategy, server_opt=opt)
    jfed = JaxFedConfig(**kw)
    jmodel = _jax_mlp()
    jst = jax_init_state(jmodel, jfed, jax.random.PRNGKey(0))
    jst["params"] = _params0()[0]
    opt_np = _warm_tree(opt, _params0()[0], 6)
    if opt != "sgd":
        jst["opt"] = _jax_opt(opt_np)
    jrf = jax.jit(jax_make_round(jmodel, jfed))
    batch, meta, wts = _inputs()
    jb, jm = jax.tree.map(jnp.asarray, batch), jax.tree.map(jnp.asarray,
                                                            meta)
    jhist = []
    for r in range(2):
        jst, m = jrf(jst, jb, jm, jnp.asarray(wts), jax.random.PRNGKey(r))
        jhist.append({k: float(v) for k, v in m.items()})
    fed = FedConfig(**kw)
    tst, thist = _run_port(fed, _torch_opt(opt_np) if opt != "sgd" else None)
    for jr, tr in zip(jhist, thist):
        assert set(tr) == set(jr)
        for k in jr:
            assert abs(tr[k] - jr[k]) <= TOL_METRIC * abs(jr[k]), (k, tr, jr)
    assert max_tree_rel_err(tst["params"], jax.tree.map(
        np.asarray, jst["params"])) <= TOL
    _check_opt(tst["opt"], jst["opt"])
    assert tst["round"] == int(jst["round"]) == 2


@pytest.mark.parametrize("case", ["vmap-sgd", "scan-adam-warm"])
def test_legacy_matches_fused_in_the_port(case):
    """Within the port, the legacy engine against the fused one over two
    rounds from the same state (the fused engine's oracle), at the JAX
    suite's legacy-vs-fused tolerances.  JAX's own form of this check at
    a cold adam start,
    ``test_fused_update.py::test_fused_round_matches_legacy_round[adam]``,
    is a reference failure (ROADMAP Queue 3 item 2)."""
    strategy, opt = CASES[case]
    out = {}
    opt_np = _warm_tree(opt, _params0()[0], 7)
    for fused in (False, True):
        fed = FedConfig(**dict(LEGACY, cohort_strategy=strategy,
                               server_opt=opt, fused_update=fused))
        out[fused] = _run_port(fed, _port_opt(fed, opt_np)
                               if opt != "sgd" else None)
    (ls, lh), (fs, fh) = out[False], out[True]
    for a, b in zip(lh, fh):
        for k in b:
            assert abs(a[k] - b[k]) <= TOL_METRIC * abs(b[k]), (k, a, b)
    assert max_tree_rel_err(ls["params"], fs["params"]) <= TOL
    if opt == "adam":
        spec = F.make_flat_spec(fs["params"])
        for slot in ("m", "v"):
            assert max_tree_rel_err(ls["opt"][slot], F.unflatten_tree(
                spec, fs["opt"][slot])) <= TOL, slot
        assert int(ls["opt"]["t"]) == int(fs["opt"]["t"]) == 7


@pytest.mark.parametrize("kw,err,match", [
    (dict(meta_mode="through_aggregation"), ValueError,
     "needs a server engine declaring the capability"),
    (dict(codec="int8"), ValueError, "'lossy' codec capability"),
    (dict(engine="legacy_tree", fused_update=True, codec="sign1bit",
          error_feedback=True), ValueError, "'lossy' codec capability"),
], ids=["through_aggregation", "int8", "sign1bit-ef-explicit"])
def test_legacy_refusals_as_in_jax(kw, err, match):
    """``legacy_tree`` has no backward and consumes trees: FedConfig and
    the round refuse ``through_aggregation`` and a lossy codec with JAX's
    messages; the round re-checks a config that went round
    ``__post_init__``."""
    base = dict(LEGACY, **kw)
    msgs = []
    for cls in (FedConfig, JaxFedConfig):
        with pytest.raises(err, match=match) as e:
            cls(**base)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    ok = FedConfig(**LEGACY)
    jok = JaxFedConfig(**LEGACY)
    for name, value in kw.items():
        object.__setattr__(ok, name, value)
        object.__setattr__(jok, name, value)
    round_msgs = []
    for make, model, cfg in ((make_federated_round, _torch_mlp(), ok),
                             (jax_make_round, _jax_mlp(), jok)):
        with pytest.raises(ValueError) as e:
            make(model, cfg)
        round_msgs.append(str(e.value))
    assert round_msgs[0] == round_msgs[1]


@pytest.mark.parametrize("opt", ["sgdm", "adam"])
def test_legacy_state_checkpoints_cross_load(opt, tmp_path):
    """A JAX ``legacy_tree`` server state (after one round) saves, restores
    into the port bitwise, and the port writes the same bytes back; the
    port's state after its round restores into JAX bitwise."""
    kw = dict(LEGACY, server_opt=opt)
    jfed, fed = JaxFedConfig(**kw), FedConfig(**kw)
    jmodel = _jax_mlp()
    jst = jax_init_state(jmodel, jfed, jax.random.PRNGKey(0))
    jst["params"] = _params0()[0]
    batch, meta, wts = _inputs()
    jst, _ = jax.jit(jax_make_round(jmodel, jfed))(
        jst, jax.tree.map(jnp.asarray, batch), jax.tree.map(jnp.asarray,
                                                            meta),
        jnp.asarray(wts), jax.random.PRNGKey(0))
    jpath, tpath = str(tmp_path / "j.msgpack"), str(tmp_path / "t.msgpack")
    JC.save(jpath, jst)
    like = init_server_state(_torch_mlp(), fed, params=_params0()[1])
    tree, _ = TC.restore(jpath, like)
    assert tree["round"] == 1
    if opt == "adam":
        assert tree["opt"]["t"].dtype == torch.int32
        assert int(tree["opt"]["t"]) == 1
    for k, v in tree["opt"]["m"].items():
        assert np.array_equal(v.numpy(), np.asarray(jst["opt"]["m"][k]))
    TC.save(tpath, tree)
    assert open(tpath, "rb").read() == open(jpath, "rb").read()
    tst, _ = _run_port(fed, rounds=1)
    TC.save(tpath, tst)
    back, _ = JC.restore(tpath, jst)
    assert int(back["round"]) == 1
    for slot in [s for s in ("m", "v") if s in back["opt"]]:
        for k, v in back["opt"][slot].items():
            assert np.array_equal(np.asarray(v),
                                  tst["opt"][slot][k].numpy()), (slot, k)
    assert dataclasses.asdict(fed) == dataclasses.asdict(jfed)
