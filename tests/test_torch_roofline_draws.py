"""The roofline event under draws: ``FederatedTrainer(roofline=True)``
under participation < 1, an active fault config and the buffered-async
engine, which the round's host all-failed test allows (it reads the host
weights the trainer hands the round, never a device value).

On ``test_torch_faults.py``'s MLP, on the CPU:

  * a traced run emits one ``roofline`` event per distinct K with JAX's
    keys and is bitwise the run without the trace, parameters, optimizer
    state, pool and history;
  * a ``cuda`` trace (kernels charging their declared costs) of a round
    charges the kernels the round's draws call for, and nothing for a
    round whose clients all failed;
  * the all-failed round with a zero base weight beside the surviving
    clients (JAX's ``sum(w * mask) > 0`` is false though the draws alone
    have survivors) is JAX's no-op round: the same keys and values and
    the parameters byte-identical to JAX's."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (one torch thread)
from repro.configs import FedConfig as JaxFedConfig
from repro.core.round import init_server_state as jax_init_state
from repro.core.round import make_federated_round as jax_make_round
from repro.core.rngtags import round_key
from repro_torch.configs import FedConfig
from repro_torch.core.round import (RoundDraws, host_weights,
                                    init_server_state, make_federated_round)
from repro_torch.core.trainer import FederatedTrainer
from repro_torch.data.pipeline import FederatedData
from repro_torch.obs import ROOFLINE_EVENT_KEYS
from repro_torch.roofline.live import round_cost_summary
from test_torch_faults import (BASE, COHORT, _arrays, _jax_draws, _jax_mlp,
                               _leaves, _params0, _to_t, _torch_mlp)

RUN = dict(rounds=3, cohort=COHORT, batch=8, meta_batch=8)
CONFIGS = {
    "participation": dict(participation=0.5),
    "faults": dict(fault_profile="flaky", round_deadline=3.0),
    "async": dict(engine="buffered_async", cohort_strategy="scan",
                  async_buffer=2, async_capacity=4, participation=0.75,
                  fault_profile="flaky"),
}


def _trainer(kw, run_dir=None, **extra):
    return FederatedTrainer(_torch_mlp(), FedConfig(**BASE, **kw), seed=0,
                            device="cpu", params=_params0()[1],
                            rounds_per_call=2, run_dir=run_dir, **extra)


def _same(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    return a == b


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def runs(request, tmp_path_factory):
    """3 rounds (a K = 2 call and a K = 1 tail) without and with the
    roofline event."""
    kw = CONFIGS[request.param]
    d = str(tmp_path_factory.mktemp("roofline_draws"))
    plain = _trainer(kw)
    hp = plain.run(FederatedData(**_arrays()), **RUN)
    traced = _trainer(kw, d, tracker="jsonl", roofline=True)
    ht = traced.run(FederatedData(**_arrays()), **RUN)
    traced.finish()
    return request.param, plain, hp, traced, ht, d


def test_traced_run_is_bitwise_the_plain_run(runs):
    name, plain, hp, traced, ht, _ = runs
    assert ht == hp, name
    a, b = _leaves(plain.state), _leaves(traced.state)
    assert len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b)), name


def test_one_event_per_distinct_k(runs):
    name, _, _, traced, ht, d = runs
    with open(os.path.join(d, "metrics.jsonl")) as f:
        evs = [json.loads(ln) for ln in f]
    evs = [{k: v for k, v in e.items() if k not in ("kind", "event", "t")}
           for e in evs if e.get("event") == "roofline"]
    assert sorted(e["rounds_per_call"] for e in evs) == [1, 2], name
    for e in evs:
        assert set(e) == set(ROOFLINE_EVENT_KEYS), name
        assert e["rounds_measured"] == 3 and e["flops_per_round"] > 0
    # the draws did act on these runs
    keys = {"participants", "arrivals", "fault_crashed"} & set(ht[0])
    assert keys, name
    assert any(rec[k] < COHORT for rec in ht for k in keys), name


def _round_inputs(fed, draws):
    data = FederatedData(**_arrays())
    s, meta = data.sample_round(0, cohort=COHORT, batch=8), \
        data.sample_meta(0, 8)
    state = init_server_state(_torch_mlp(), fed, params=_params0()[1])
    return (state, _to_t(s["cohort_batch"]), _to_t(meta),
            np.asarray(s["client_weights"], np.float32), draws)


@pytest.mark.parametrize("strategy,launches", [
    ("vmap", {"aggregate_pass": 1, "update_pass": 1}),
    ("scan", {"accumulate_pass": COHORT, "update_pass": 1}),
])
def test_cuda_trace_charges_what_the_draws_call_for(strategy, launches):
    """A round with survivors charges its kernels; one whose clients all
    crashed charges none (it runs nothing)."""
    kw = dict(BASE, cohort_strategy=strategy, fault_crash=0.5)
    fed = FedConfig(**kw)
    crashed = np.array([True, False, True, False])
    fs = _jax_draws(JaxFedConfig(**kw), round_key(jax.random.PRNGKey(0), 0)
                    ).faults
    some = RoundDraws(faults=fs._replace(
        crashed=crashed, alive=(~crashed).astype(np.float32)))
    every = RoundDraws(faults=fs._replace(
        crashed=np.ones(COHORT, bool), alive=np.zeros(COHORT, np.float32)))
    fn = make_federated_round(_torch_mlp(), fed)
    s = round_cost_summary(fn, _round_inputs(fed, some), device="cuda")
    assert s["launches"] == launches
    s = round_cost_summary(fn, _round_inputs(fed, every), device="cuda")
    assert s["launches"] == {} and s["flops"] == 0


def test_async_tick_trace_charges_its_flushes():
    """A tick whose arrivals fill the buffer charges one accumulate per
    flushed delta and one update; a tick without arrivals charges
    nothing."""
    kw = dict(BASE, engine="buffered_async", cohort_strategy="scan",
              async_buffer=2, async_capacity=4, participation=0.5)
    fed = FedConfig(**kw)
    fn = make_federated_round(_torch_mlp(), fed)
    two = RoundDraws(participation=np.array([1, 0, 1, 0], np.float32))
    none = RoundDraws(participation=np.zeros(COHORT, np.float32))
    s = round_cost_summary(fn, _round_inputs(fed, two), device="cuda")
    assert s["launches"] == {"accumulate_pass": 2, "update_pass": 1}
    s = round_cost_summary(fn, _round_inputs(fed, none), device="cuda")
    assert s["launches"] == {}


def test_host_weights_reads_arrays_and_tensors():
    w = np.array([1.0, 2.0], np.float64)
    assert host_weights(w).dtype == np.float32
    assert np.array_equal(host_weights(torch.tensor([1.0, 2.0])),
                          np.array([1, 2], np.float32))
    assert np.array_equal(host_weights([3, 4]), np.array([3, 4], np.float32))


@pytest.mark.parametrize("weights_as", ["numpy", "tensor"])
def test_zero_base_weight_all_failed_matches_jax(weights_as):
    """Participation 0.5 at a JAX round key whose mask keeps some clients:
    each kept client gets base weight 0, the others a positive one.  JAX's
    ``sum(w * mask)`` is 0, so its round is the no-op; the port's is too,
    whether the weights come as a host array or a tensor."""
    kw = dict(BASE, participation=0.5)
    jfed = JaxFedConfig(**kw)
    key = next(k for k in (round_key(jax.random.PRNGKey(0), r)
                           for r in range(200))
               if 0 < np.sum(_jax_draws(jfed, k).participation) < COHORT)
    draws = _jax_draws(jfed, key)
    kept = draws.participation > 0
    data = FederatedData(**_arrays())
    s, meta = data.sample_round(0, cohort=COHORT, batch=8), \
        data.sample_meta(0, 8)
    weights = np.where(kept, 0.0, s["client_weights"]).astype(np.float32)
    assert weights[~kept].min() > 0
    jw, tw = _params0()
    jstate = jax_init_state(_jax_mlp(), jfed, jax.random.PRNGKey(0))
    jstate["params"] = jw
    jnew, jm = jax.jit(jax_make_round(_jax_mlp(), jfed))(
        jstate, jax.tree.map(jnp.asarray, s["cohort_batch"]),
        jax.tree.map(jnp.asarray, meta), jnp.asarray(weights), key)
    fed = FedConfig(**kw)
    w_in = weights if weights_as == "numpy" else torch.from_numpy(weights)
    tnew, tm = make_federated_round(_torch_mlp(), fed)(
        init_server_state(_torch_mlp(), fed, params=tw),
        _to_t(s["cohort_batch"]), _to_t(meta), w_in, draws)
    assert set(tm) == set(jm)
    for k in jm:
        assert float(tm[k]) == float(jm[k]), k
    assert float(jm["client_loss"]) == float(jm["grad_norm"]) == 0.0
    assert float(tm["participants"]) == np.sum(kept)
    for k in jw:
        assert np.asarray(jnew["params"][k]).tobytes() == \
            np.asarray(jw[k]).tobytes() == tnew["params"][k].numpy().tobytes()
    # the same draws with a positive base weight everywhere: a stepped
    # round in both packages
    tstep, tm1 = make_federated_round(_torch_mlp(), fed)(
        init_server_state(_torch_mlp(), fed, params=tw),
        _to_t(s["cohort_batch"]), _to_t(meta),
        np.asarray(s["client_weights"], np.float32), draws)
    assert float(tm1["grad_norm"]) > 0
    assert not torch.equal(tstep["params"]["w1"], tw["w1"])


def test_stepped_round_takes_tensor_or_host_weights_bitwise():
    """The round's result does not depend on the form of its weights."""
    kw = dict(BASE, fault_profile="flaky")
    fed = FedConfig(**kw)
    jfed = JaxFedConfig(**kw)
    draws = _jax_draws(jfed, round_key(jax.random.PRNGKey(0), 1))
    out = []
    for form in (np.asarray, torch.from_numpy):
        st, a, b, w, d = _round_inputs(fed, draws)
        new, m = make_federated_round(_torch_mlp(), fed)(st, a, b, form(w),
                                                        d)
        out.append((new, {k: float(v) for k, v in m.items()}))
    (n0, m0), (n1, m1) = out
    assert m0 == m1
    assert all(_same(x, y) for x, y in zip(_leaves(n0), _leaves(n1)))
