"""The port's plugin surface against the JAX package's: a client algorithm
written against ``repro_torch`` alone (``examples/plugins/fedagg_torch.py``)
through the launcher's ``--plugin``; a server engine registered by a test
consuming the tree handle on the vmap and scan cohorts (as
``tests/test_plugin_api.py::test_registered_toy_engine_runs_end_to_end``);
the fused engine taking a tree handle from an executor that produces only
trees; the ``repro_torch.core`` facade; and fednova against fedavg at the
tau server step size.

The model is the small MLP of ``test_torch_faults.py``; parameters start
from the JAX init.  Tolerances against JAX, max |a-b| over max |b|:
parameters 1e-5, metrics 1e-4.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import SMOKE, max_tree_rel_err, rel_err
from repro.configs import FedConfig as JaxFedConfig
from repro.core.round import init_server_state as jax_init_state
from repro.core.round import make_federated_round as jax_make_round
from repro_torch.configs import FedConfig
from repro_torch.core import engines as TE
from repro_torch.core import executors as TX
from repro_torch.core.round import init_server_state, make_federated_round
from repro_torch.launch.train import main
from test_torch_faults import COHORT, _jax_mlp, _params0, _to_t, _torch_mlp

TOL, TOL_METRIC = 1e-5, 1e-4


def _inputs(seed=0, cohort=COHORT, b=16):
    rng = np.random.default_rng(seed)
    batch = {"x": rng.normal(0, 1, (cohort, b, 10)).astype(np.float32),
             "y": rng.integers(0, 4, (cohort, b)).astype(np.int32)}
    meta = {"x": rng.normal(0, 1, (8, 10)).astype(np.float32),
            "y": rng.integers(0, 4, 8).astype(np.int32)}
    wts = rng.uniform(1.0, 5.0, cohort).astype(np.float32)
    return batch, meta, wts


def _port_round(fed, **round_kw):
    batch, meta, wts = _inputs()
    model = _torch_mlp()
    st = init_server_state(model, fed, params=_params0()[1],
                           engine=round_kw.get("engine"))
    return make_federated_round(model, fed, **round_kw)(
        st, _to_t(batch), _to_t(meta), torch.from_numpy(wts))


def _jax_round(fed):
    batch, meta, wts = _inputs()
    model = _jax_mlp()
    st = jax_init_state(model, fed, jax.random.PRNGKey(0))
    st["params"] = _params0()[0]
    return jax.jit(jax_make_round(model, fed))(
        st, jax.tree.map(jnp.asarray, batch), jax.tree.map(jnp.asarray,
                                                           meta),
        jnp.asarray(wts), jax.random.PRNGKey(0))


def test_fedagg_plugin_matches_jax_and_runs_the_cli(tmp_path):
    """The port's FedAgg plugin gives the JAX plugin's client update on
    the same inputs, and ``--plugin examples.plugins.fedagg_torch
    --algorithm fedagg`` trains through the launcher under an int8 uplink
    with error feedback."""
    import examples.plugins.fedagg as JP
    import examples.plugins.fedagg_torch as TP
    from repro_torch.core.algorithms import available_algorithms
    assert "fedagg" in available_algorithms()
    batch, _, _ = _inputs()
    jg, jl = jax.jit(lambda p, b: JP.fedagg_update(
        _jax_mlp().loss, p, b, 0.05, None, local_steps=2))(
        _params0()[0], jax.tree.map(lambda x: jnp.asarray(x[0]), batch))
    tg, tl = TP.fedagg_update(_torch_mlp().loss, _params0()[1],
                              {k: v[0] for k, v in _to_t(batch).items()},
                              0.05, local_steps=2)
    assert max_tree_rel_err(tg, jax.tree.map(np.asarray, jg)) <= TOL
    assert rel_err(tl, np.asarray(jl)) <= TOL_METRIC
    out = tmp_path / "hist.json"
    main(["--plugin", "examples.plugins.fedagg_torch", "--algorithm",
          "fedagg", "--arch", SMOKE, "--rounds", "2", "--cohort", "2",
          "--client-batch", "4", "--seq", "16", "--no-meta", "--fused",
          "--codec", "int8", "--error-feedback", "--device", "cpu",
          "--log-every", "0", "--history-out", str(out)])
    hist = json.loads(out.read_text())
    assert [r["round"] for r in hist] == [0, 1]
    assert all(np.isfinite(v) for r in hist for v in r.values())
    assert all(r["comm_bytes"] > 0 for r in hist)


@TE.register_engine("_test_sign_sgd")
class _SignSgdEngine(TE.ServerEngine):
    """Tree-consuming sign-SGD engine (test only): w <- w - lr * sign(G)."""
    name = "_test_sign_sgd"
    accepts = frozenset({"tree"})
    preferred = "tree"
    meta_capabilities = frozenset({"post"})

    def __init__(self, fed):
        del fed

    def init_state(self, params):
        return {}

    def apply(self, params, handle, opt_state, *, lr):
        G = handle.tree
        new_p = {k: (p.to(torch.float32) - lr * torch.sign(
            G[k].to(torch.float32))).to(p.dtype) for k, p in params.items()}
        return new_p, opt_state, TE.tree_global_norm(G)


@pytest.mark.parametrize("strategy", ["vmap", "scan"])
def test_registered_toy_engine_consumes_a_tree_handle(strategy):
    """An engine registered by name alone runs on both cohorts through the
    tree handle (vmap: the tree-map weighted mean; scan: the streamed flat
    buffers viewed as a tree): every parameter moves by exactly lr."""
    fed = FedConfig(algorithm="uga", meta=False, cohort=COHORT,
                    local_steps=2, client_lr=0.05, server_lr=0.01,
                    cohort_strategy=strategy)
    st, m = _port_round(fed, engine="_test_sign_sgd")
    for k, p0 in _params0()[1].items():
        np.testing.assert_allclose((st["params"][k] - p0).abs().numpy(),
                                   0.01, rtol=1e-5)
    assert np.isfinite(float(m["client_loss"]))
    with pytest.raises(ValueError, match="unknown server engine"):
        make_federated_round(_torch_mlp(), fed, engine="_test_nope")


@TX.register_executor("_test_tree_only")
class _TreeOnly(TX.VmapExecutor):
    """An executor that yields only pre-aggregated trees (test only)."""
    name = "_test_tree_only"
    produces = frozenset({"tree"})


def test_fused_engine_takes_a_tree_handle():
    """The fused engine runs a tree handle as a one-client stack through
    both its passes: the round of a tree-only executor against the fused
    vmap round, at the JAX suite's tolerances (the aggregate is summed in
    another order)."""
    kw = dict(algorithm="uga", meta=True, cohort=COHORT, local_steps=2,
              client_lr=0.05, server_lr=0.1, meta_lr=0.05, clip_norm=1.0,
              fused_update=True, server_opt="adam")
    (sa, ma), (sb, mb) = (_port_round(FedConfig(**kw), executor=e)
                          for e in ("_test_tree_only", None))
    assert max_tree_rel_err(sa["params"], sb["params"]) <= TOL
    for k in ma:
        assert rel_err(ma[k], mb[k]) <= TOL_METRIC, k
    with pytest.raises(ValueError, match="no common aggregate-handle kind"):
        make_federated_round(_torch_mlp(), FedConfig(**kw),
                             executor="buffered_async", engine="legacy_tree")


def test_facade_import_surface():
    """Every name of the JAX package's ``repro.core`` facade is importable
    from ``repro_torch.core`` and from its module, with working call
    signatures (as ``tests/test_plugin_api.py::
    test_backcompat_import_surface``)."""
    import repro.core as JCORE
    import repro_torch.core as TCORE
    from repro_torch.core import (RoundFnCache, available_algorithms,
                                  grad_global_norm, make_client_update,
                                  stack_round_inputs)
    from repro_torch.core.round import RoundFnCache as r_cache
    assert sorted(TCORE.__all__) == sorted(JCORE.__all__)
    for name in TCORE.__all__:
        assert getattr(TCORE, name) is not None, name
    assert RoundFnCache is r_cache
    assert set(dir(TCORE)) >= set(TCORE.__all__)
    model = _torch_mlp()
    for algo in available_algorithms():
        assert callable(make_client_update(algo, model.loss, local_steps=2))
    with pytest.raises(ValueError, match="register_algorithm"):
        make_client_update("nope", model.loss, local_steps=2)
    g = {"a": torch.tensor([3.0, 4.0])}
    assert float(grad_global_norm(g)) == pytest.approx(5.0, rel=1e-6)
    fed = FedConfig(algorithm="uga", meta=False, cohort=2, local_steps=2)
    assert callable(RoundFnCache(model, fed)(1))
    cb, mb, w, d = stack_round_inputs(
        [{"x": np.ones((2, 4))}] * 2, [None, None], [np.ones(2)] * 2,
        [None, None])
    assert cb["x"].shape == (2, 2, 4) and mb is None and w.shape == (2, 2)
    assert d is None
    with pytest.raises(AttributeError):
        TCORE.not_a_name


def test_fednova_matches_fedavg_at_tau_server_lr():
    """fednova divides the delta by tau = local_steps * local_epochs = 2;
    at server_lr = tau under plain SGD its round is fedavg's (unit step)
    when both run the same local steps.  With ``prox_mu=0`` the two
    rounds agree bitwise in the port (both halvings are exact in fp32).

    The JAX suite's own check at the default config,
    ``tests/test_plugin_api.py::test_fednova_matches_fedavg_at_tau_server_lr``,
    is a reference failure (ROADMAP Queue 3 item 2), and not from
    rounding: fednova hands ``FedConfig.prox_mu`` (2e-4 by default) to its
    local steps and fedavg drops it, in both packages.  At that default
    config each of the port's two rounds matches JAX's within 1e-5."""
    states = {}
    for prox in (0.0, FedConfig().prox_mu):
        for algo, slr in (("fedavg", 0.123), ("fednova", 2.0)):
            kw = dict(algorithm=algo, meta=False, cohort=COHORT,
                      local_steps=2, local_epochs=1, client_lr=0.05,
                      server_lr=slr, prox_mu=prox)
            states[prox, algo], _ = _port_round(FedConfig(**kw))
            if prox:
                jst, _ = _jax_round(JaxFedConfig(**kw))
                assert max_tree_rel_err(
                    states[prox, algo]["params"],
                    jax.tree.map(np.asarray, jst["params"])) <= TOL, algo
    a, b = states[0.0, "fedavg"]["params"], states[0.0, "fednova"]["params"]
    for k in a:
        assert torch.equal(a[k], b[k]), k
