"""Controllable meta updating through the aggregation
(``meta_mode='through_aggregation'``) in the port against the JAX package,
at smoke size.  The 3-round trainer parity is
``test_torch_meta_through_rounds.py`` and
``test_torch_meta_through_rounds_scan.py``, in files of their own so that
a parallel run (``-n N --dist loadfile``) puts them on separate workers.

The same numpy inputs, and parameters and server state bridged from the
JAX package, go through both.  Tolerances (max |a-b| over max |b| per
array): the hypergradient step (``ctrl``) and parameters <= 1e-5, round
metrics <= 1e-4 — the JAX suite's tolerances across engines, which its own
vmap-vs-scan ctrl gate uses too (``tests/test_ctrl_meta_and_resume.py``).

Adam runs from a warm state (t = 5, random m, v > 0): from a cold start
the step is about lr * sign(G) and its hypergradient is fp32 cancellation
in both packages (ROADMAP Queue 3).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (SMOKE, jax_params_to_torch, max_tree_rel_err,
                           rel_err)
from repro.configs import FedConfig as JaxFedConfig
from repro.configs import get_arch as jax_get_arch
from repro.core import meta as JM
from repro.core.algorithms import get_algorithm as jax_get_algorithm
from repro.core.engines import resolve_engine as jax_resolve_engine
from repro.core.executors import resolve_executor as jax_resolve_executor
from repro.models.model import build_model as jax_build_model
from repro_torch import bridge
from repro_torch.configs import FedConfig, get_arch
from repro_torch.core import meta as TM
from repro_torch.core.algorithms import get_algorithm
from repro_torch.core.engines import resolve_engine
from repro_torch.core.executors import (CohortExecutor, register_executor,
                                        resolve_executor)
from repro_torch.core.round import init_server_state, make_federated_round
from repro_torch.launch.train import main
from repro_torch.models.model import build_model

TOL = 1e-5
TOL_METRIC = 1e-4
COHORT = 3
CTRL_KEYS = ("w_logits", "log_lr")
META_KEYS = ("meta_loss", "ctrl_w_gnorm", "ctrl_lr_grad", "server_lr_eff")


@pytest.fixture(scope="module")
def lm():
    jm = jax_build_model(jax_get_arch(SMOKE), dtype=jnp.float32,
                         loss_chunk=256)
    jp = jm.init(jax.random.PRNGKey(1))
    tm = build_model(get_arch(SMOKE), loss_chunk=256)
    return jm, jp, tm, jax_params_to_torch(jp)


def _fed_kw(strategy, opt, **kw):
    return dict(algorithm="uga", meta=True, cohort=COHORT, local_steps=2,
                client_lr=0.01, server_lr=0.05, meta_lr=0.01,
                server_opt=opt, cohort_strategy=strategy, fused_update=True,
                meta_mode="through_aggregation", ctrl_lr=1.0, **kw)


def _flat_state(opt, tspec_rows, seed):
    """Warm flat optimizer state (numpy), t = 5 for adam/yogi."""
    rng = np.random.default_rng(seed)
    m = (0.01 * rng.standard_normal((tspec_rows, 128))).astype(np.float32)
    v = (1e-3 * rng.random((tspec_rows, 128)) + 1e-4).astype(np.float32)
    return {"sgd": {}, "sgdm": {"m": (m,)},
            "adam": {"m": (m,), "v": (v,), "t": np.int32(5)},
            "yogi": {"m": (m,), "v": (v,), "t": np.int32(5)}}[opt]


def _ctrl(seed):
    rng = np.random.default_rng(seed)
    return {"w_logits": (0.3 * rng.standard_normal(COHORT)).astype(
        np.float32), "log_lr": np.float32(np.log(0.05))}


def _jax_state(opt_np, ctrl_np):
    opt = {k: (tuple(jnp.asarray(b) for b in v) if isinstance(v, tuple)
               else jnp.asarray(v)) for k, v in opt_np.items()}
    return opt, {k: jnp.asarray(v) for k, v in ctrl_np.items()}


def _check_step(t_out, j_out, *, tol=TOL, tol_meta=TOL):
    """(new_params, new_opt, gn, new_ctrl, metrics) of both packages."""
    tp, topt, tgn, tctrl, tmet = t_out
    jp, jopt, jgn, jctrl, jmet = j_out
    for k in CTRL_KEYS:
        assert rel_err(tctrl[k], np.asarray(jctrl[k])) <= tol, k
    for k in META_KEYS:
        assert rel_err(tmet[k], np.asarray(jmet[k])) <= tol_meta, k
    assert rel_err(tgn, np.asarray(jgn)) <= tol
    assert max_tree_rel_err(tp, jax_params_to_torch(jp)) <= tol
    for slot in ("m", "v"):
        if slot in jopt:
            assert rel_err(topt[slot][0], np.asarray(jopt[slot][0])) <= tol


def _batches(seed, n_clients, batch, seq):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 512, (n_clients, batch, seq + 1)).astype(np.int32)
    meta = rng.integers(0, 512, (8, seq + 1)).astype(np.int32)
    w = (rng.random(n_clients) + 0.5).astype(np.float32)
    return toks, meta, w


@pytest.mark.parametrize("opt,clip", [("sgd", 0.0), ("sgdm", 0.5),
                                      ("adam", 0.0), ("yogi", 0.5)])
def test_reference_form_matches_jax(lm, opt, clip):
    """meta_update_through_aggregation over one numpy gradient stack, so
    the two packages differentiate the same function of the same inputs."""
    jm, jp, tm, tp = lm
    rng = np.random.default_rng(7)
    gstack = {k: (0.05 * rng.standard_normal((COHORT,) + tuple(v.shape))
                  ).astype(np.float32) for k, v in tp.items()}
    jstack = bridge.to_numpy({k: torch.from_numpy(v)
                              for k, v in gstack.items()})
    _, meta, w = _batches(8, COHORT, 4, 32)
    rows = -(-sum(v.numel() for v in tp.values()) // 128)
    rows = -(-rows // 8) * 8
    opt_np, ctrl_np = _flat_state(opt, rows, 9), _ctrl(10)
    kw = dict(opt=opt, clip_norm=clip, momentum=0.9, ctrl_lr=1.0)
    st = bridge.server_state_to_torch(opt_np, ctrl_np)
    t_out = TM.meta_update_through_aggregation(
        tm.loss, tp, {k: torch.from_numpy(v) for k, v in gstack.items()},
        torch.from_numpy(w), st["opt"],
        {"tokens": torch.from_numpy(meta).long()}, st["ctrl"], **kw)
    jopt, jctrl = _jax_state(opt_np, ctrl_np)
    j_out = JM.meta_update_through_aggregation(
        jm.loss, jp, jax.tree.map(jnp.asarray, jstack), jnp.asarray(w), jopt,
        {"tokens": jnp.asarray(meta)}, jctrl, **kw)
    _check_step(t_out, j_out)


@pytest.mark.parametrize("strategy,opt", [("vmap", "sgd"), ("scan", "sgd"),
                                          ("scan", "adam")])
def test_meta_update_through_cohort_matches_jax(lm, strategy, opt):
    """The round's form: the clients run inside (UGA, two local steps),
    through each package's reweightable cohort and fused engine.

    The client gradients of the two packages agree to 1e-4
    (``test_torch_client.py``), and the weight-logit hypergradient is a
    difference of near-equal <g_k, dG> (the clients share w_t), so the
    hypergradient metrics are held to the metric tolerance; the stepped
    ctrl and the parameters to 1e-5."""
    jm, jp, tm, tp = lm
    toks, meta, w = _batches(11, COHORT, 4, 32)
    rows = -(-sum(v.numel() for v in tp.values()) // 128)
    rows = -(-rows // 8) * 8
    opt_np, ctrl_np = _flat_state(opt, rows, 12), _ctrl(13)
    jfed, tfed = (JaxFedConfig(**_fed_kw(strategy, opt)),
                  FedConfig(**_fed_kw(strategy, opt)))

    jcu = jax_get_algorithm("uga").build(jm.loss, local_steps=2,
                                         local_epochs=1, prox_mu=0.0,
                                         remat=True)

    @jax.jit
    def jax_step(params, batch, weights, opt_state, meta_batch, ctrl):
        rw = jax_resolve_executor(jfed).reweightable(
            jcu, params, batch, weights, 0.01, jax.random.PRNGKey(0))
        return JM.meta_update_through_cohort(
            jm.loss, rw, weights, params, opt_state, meta_batch, ctrl,
            engine=jax_resolve_engine(jfed), ctrl_lr=1.0)

    jopt, jctrl = _jax_state(opt_np, ctrl_np)
    jnp_, jnopt, jgn, jloss, jnctrl, jmet = jax_step(
        jp, {"tokens": jnp.asarray(toks)}, jnp.asarray(w), jopt,
        {"tokens": jnp.asarray(meta)}, jctrl)

    tcu = get_algorithm("uga").build(tm.loss, local_steps=2, local_epochs=1,
                                     prox_mu=0.0)
    trw = resolve_executor(tfed).reweightable(
        tcu, tp, {"tokens": torch.from_numpy(toks).long()},
        torch.from_numpy(w), 0.01)
    st = bridge.server_state_to_torch(opt_np, ctrl_np)
    tnp, tnopt, tgn, tloss, tnctrl, tmet = TM.meta_update_through_cohort(
        tm.loss, trw, torch.from_numpy(w), tp, st["opt"],
        {"tokens": torch.from_numpy(meta).long()}, st["ctrl"],
        engine=resolve_engine(tfed), ctrl_lr=1.0)
    assert rel_err(tloss, np.asarray(jloss)) <= TOL_METRIC
    _check_step((tnp, tnopt, tgn, tnctrl, tmet),
                (jnp_, jnopt, jgn, jnctrl, jmet), tol_meta=TOL_METRIC)


def test_reference_scan_form_equals_round_form(lm):
    """meta_update_through_aggregation_scan is the scan executor's
    reweightable cohort under meta_update_through_cohort, written out."""
    _, _, tm, tp = lm
    toks, meta, w = _batches(14, COHORT, 4, 32)
    fed = FedConfig(**_fed_kw("scan", "sgd"))
    cu = get_algorithm("uga").build(tm.loss, local_steps=2, local_epochs=1,
                                    prox_mu=0.0)
    batch = {"tokens": torch.from_numpy(toks).long()}
    mb = {"tokens": torch.from_numpy(meta).long()}
    ctrl = bridge.server_state_to_torch({}, _ctrl(15))["ctrl"]
    a = TM.meta_update_through_aggregation_scan(
        tm.loss, cu, tp, batch, torch.from_numpy(w), 0.01, {}, mb, ctrl,
        opt="sgd", clip_norm=0.0, momentum=0.0, ctrl_lr=1.0)
    b = TM.meta_update_through_cohort(
        tm.loss, resolve_executor(fed).reweightable(
            cu, tp, batch, torch.from_numpy(w), 0.01),
        torch.from_numpy(w), tp, {}, mb, ctrl, engine=resolve_engine(fed),
        ctrl_lr=1.0)
    for k in CTRL_KEYS:
        assert torch.equal(a[4][k], b[4][k]), k
    assert all(torch.equal(a[0][k], b[0][k]) for k in tp)


def test_scan_hypergrads_match_vmap_in_the_port(lm):
    """Within the port: two rounds of vmap and scan agree on ctrl, params
    and the round's metrics (the JAX suite's vmap-vs-scan gate)."""
    _, _, tm, tp = lm
    toks, meta, w = _batches(16, COHORT, 4, 32)
    batch = {"tokens": torch.from_numpy(toks).long()}
    mb = {"tokens": torch.from_numpy(meta).long()}
    out = {}
    for strategy in ("vmap", "scan"):
        fed = FedConfig(**_fed_kw(strategy, "sgdm", server_momentum=0.9,
                                  clip_norm=1.0))
        st = init_server_state(tm, fed, params=tp)
        rf = make_federated_round(tm, fed)
        for _ in range(2):
            st, met = rf(st, batch, mb, torch.from_numpy(w))
        out[strategy] = st, met
    (sv, mv), (ss, ms) = out["vmap"], out["scan"]
    for k in CTRL_KEYS:
        assert rel_err(ss["ctrl"][k], sv["ctrl"][k]) <= TOL, k
    assert max_tree_rel_err(ss["params"], sv["params"]) <= TOL
    for k in ("client_loss", *META_KEYS):
        assert rel_err(ms[k], mv[k]) <= TOL, k


@pytest.mark.parametrize("strategy", ["vmap", "scan"])
def test_cli_runs_through_aggregation_on_cpu(tmp_path, strategy):
    out = tmp_path / "hist.json"
    main(["--arch", SMOKE, "--fused", "--meta", "--meta-mode",
          "through_aggregation", "--rounds", "3", "--cohort", "2",
          "--client-batch", "4", "--seq", "32", "--device", "cpu",
          "--strategy", strategy, "--log-every", "0", "--history-out",
          str(out)])
    hist = json.loads(out.read_text())
    assert [r["round"] for r in hist] == [0, 1, 2]
    for rec in hist:
        assert set(META_KEYS) <= set(rec)
        assert all(np.isfinite(v) for v in rec.values())
    assert hist[-1]["ctrl_w_gnorm"] > 0


def test_init_server_state_seeds_ctrl():
    fed = FedConfig(**_fed_kw("vmap", "adam"))
    tm = build_model(get_arch(SMOKE))
    st = init_server_state(tm, fed, generator=torch.Generator().manual_seed(0))
    assert torch.equal(st["ctrl"]["w_logits"], torch.zeros(COHORT))
    assert float(st["ctrl"]["log_lr"]) == pytest.approx(np.log(0.05),
                                                        rel=1e-6)
    post = init_server_state(tm, FedConfig(fused_update=True),
                             generator=torch.Generator().manual_seed(0))
    assert "ctrl" not in post


def test_through_aggregation_needs_a_positive_server_lr():
    for lr in (0.0, -0.1):
        with pytest.raises(ValueError, match="server_lr must be > 0"):
            FedConfig(fused_update=True, meta_mode="through_aggregation",
                      server_lr=lr)
        with pytest.raises(ValueError, match="server_lr must be > 0"):
            JaxFedConfig(fused_update=True, meta_mode="through_aggregation",
                         server_lr=lr)


@register_executor("test_no_reweight")
class _NoReweight(CohortExecutor):
    name = "test_no_reweight"

    def __init__(self, fed):
        del fed


def test_round_refuses_an_executor_without_reweight():
    """The round re-checks what FedConfig checks, against the resolved
    executor (a config that went round __post_init__)."""
    fed = FedConfig(**_fed_kw("vmap", "sgd"))
    object.__setattr__(fed, "cohort_strategy", "test_no_reweight")
    tm = build_model(get_arch(SMOKE))
    with pytest.raises(ValueError, match="reweightable"):
        make_federated_round(tm, fed)
