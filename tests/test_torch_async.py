"""The buffered-async runtime, the port against the JAX package: ticks of
``engine='buffered_async'`` under JAX's draws (garble kept), and the
runtime's invariants within the port.

The JAX tick draws its participation mask and fault streams from the tick
key with threefry; the parity tests hand JAX's draws to the port's tick
(``RoundDraws``), as ``tests/test_torch_faults.py`` does for the
synchronous round, but through ``resolve_faults`` rather than the sync
round's zeroed garble.  The model is that file's small MLP; parameters
start from the JAX init.

Tolerances, max |a-b| over max |b|: parameters and the pool's occupied
slots 1e-5; the pool's host vectors (weight, version, deliver), the server
version and every count metric exactly; the other metrics 1e-4.  Within
the port, as the JAX suite holds it: a fault-free tick with K = capacity
= cohort on the scan base is bitwise the synchronous scan round, the vmap
base within 2e-5 of the synchronous vmap round, a tick without a flush a
bitwise no-op of params and opt, and a crashed client's residual keeps
its bytes."""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import max_tree_rel_err, rel_err
from repro.configs import FedConfig as JaxFedConfig
from repro.core.async_round import staleness_discount as jax_discount
from repro.core.round import init_server_state as jax_init_state
from repro.core.round import make_federated_round as jax_make_round
from repro.core.round import participation_mask as jax_participation_mask
from repro.core.rngtags import round_key
from repro.sim import faults as JF
from repro_torch.configs import FedConfig
from repro_torch.core import async_round as A
from repro_torch.core.executors import get_executor
from repro_torch.core.round import (RoundDraws, draw_round,
                                    init_server_state, make_federated_round)
from repro_torch.data.pipeline import FederatedData
from repro_torch.kernels.fused_update import kernel as FK
from repro_torch.sim import faults as TF
from test_torch_faults import (BASE, COHORT, _arrays, _jax_mlp, _params0,
                               _to_t, _torch_mlp)

ASYNC = dict(BASE, engine="buffered_async")


def _jax_tick_draws(fed, key, cohort=COHORT) -> RoundDraws:
    """The draws JAX's async tick takes under key ``key``: the
    participation mask and the fault streams of ``resolve_faults``,
    garble kept."""
    fc = JF.resolve_faults(fed)
    return RoundDraws(
        participation=(np.asarray(jax_participation_mask(
            key, cohort, fed.participation)) if fed.participation < 1.0
            else None),
        faults=(TF.FaultStreams(*(np.asarray(a) for a in JF.fault_streams(
            key, cohort, fc))) if fc.active else None))


def _logical_pool(a):
    """The port's pool in JAX's slot order, as numpy."""
    return [p.detach().cpu().numpy()[a["slot"]] for p in a["pool"]]


# ---------------------------------------------------------------------------
# ticks under JAX's draws
# ---------------------------------------------------------------------------
TICK_CONFIGS = {
    "clean-scan-adam": dict(cohort_strategy="scan", server_opt="adam",
                            async_buffer=COHORT, async_capacity=COHORT),
    "flaky-scan-k2": dict(cohort_strategy="scan", fault_profile="flaky",
                          fault_garble=0.3, async_buffer=2,
                          async_capacity=2 * COHORT),
    "vmap-participation-crash": dict(participation=0.75, fault_crash=0.25),
    "int8-ef-scan": dict(cohort_strategy="scan", codec="int8",
                         error_feedback=True, fault_crash=0.25,
                         async_buffer=2),
    "max-staleness-1": dict(cohort_strategy="scan", fault_delay=0.5,
                            fault_max_delay=2, async_buffer=2,
                            async_max_staleness=1),
}
TICKS = 5


@pytest.fixture(scope="module", params=list(TICK_CONFIGS))
def ticks(request):
    """Five ticks of JAX's tick program and of the port's under the same
    draws: each tick's JAX and port (state, metrics), the state copied."""
    kw = {**ASYNC, **TICK_CONFIGS[request.param]}
    jfed, tfed = JaxFedConfig(**kw), FedConfig(**kw)
    jw, tw = _params0()
    jmodel = _jax_mlp()
    jtick = jax.jit(jax_make_round(jmodel, jfed))
    jstate = jax_init_state(jmodel, jfed, jax.random.PRNGKey(0))
    jstate["params"] = jw
    ttick = make_federated_round(_torch_mlp(), tfed)
    tstate = init_server_state(_torch_mlp(), tfed, params=tw)
    data = FederatedData(**_arrays())
    key = jax.random.PRNGKey(11)
    out = []
    for r in range(TICKS):
        s = data.sample_round(r, cohort=COHORT, batch=8)
        meta = data.sample_meta(r, 8)
        rk = round_key(key, r)
        jstate, jm = jtick(jstate, jax.tree.map(jnp.asarray,
                                                s["cohort_batch"]),
                           jax.tree.map(jnp.asarray, meta),
                           jnp.asarray(s["client_weights"]), rk)
        tstate, tm = ttick(tstate, _to_t(s["cohort_batch"]), _to_t(meta),
                           torch.from_numpy(s["client_weights"]),
                           _jax_tick_draws(jfed, rk))
        snap = {"params": {k: v.clone() for k, v in tstate["params"].items()},
                "async": {**tstate["async"],
                          "pool": _logical_pool(tstate["async"])}}
        if "comm" in tstate:
            snap["comm"] = [t.clone() for t in tstate["comm"]["residual"]]
        out.append((jax.tree.map(np.asarray, jstate),
                    {k: np.asarray(v) for k, v in jm.items()}, snap,
                    {k: np.asarray(v, dtype=np.float32) if not isinstance(
                        v, torch.Tensor) else v.detach().numpy()
                     for k, v in tm.items()}))
    return request.param, out


COUNTS = ("arrivals", "server_steps", "buffer_fill", "overflow_dropped",
          "expired", "participants", "fault_crashed", "fault_dropped",
          "fault_delayed", "staleness_hist", "staleness_mean",
          "staleness_max", "comm_bytes")


def test_ticks_under_jax_draws_match_jax(ticks):
    name, out = ticks
    for r, (js, jm, ts, tm) in enumerate(out):
        assert set(tm) == set(jm), (name, r, sorted(tm), sorted(jm))
        for k in jm:
            if k in COUNTS:
                assert np.array_equal(np.asarray(tm[k], np.float32),
                                      jm[k]), (name, r, k, tm[k], jm[k])
            else:
                assert abs(float(tm[k]) - float(jm[k])) <= \
                    1e-4 * abs(float(jm[k])) + 1e-7, (name, r, k, tm[k],
                                                      jm[k])
        assert max_tree_rel_err(ts["params"], js["params"]) <= 1e-5, (name,
                                                                      r)
        ja, ta = js["async"], ts["async"]
        for k in ("weight", "version", "deliver"):
            assert ta[k].dtype == ja[k].dtype and np.array_equal(
                ta[k], ja[k]), (name, r, k, ta[k], ja[k])
        assert ta["server_version"] == int(ja["server_version"])
        occupied = ja["weight"] > 0
        for tp, jp in zip(ta["pool"], ja["pool"]):
            if occupied.any():
                assert rel_err(tp[occupied], jp[occupied]) <= 1e-5, (name,
                                                                     r)
        if "comm" in js:
            # the residual: a small remainder of a delta about 100 times
            # its size (tests/test_torch_faults.py)
            assert rel_err(ts["comm"][0], js["comm"]["residual"][0]) <= \
                1e-3, (name, r)


def test_ticks_under_jax_draws_exercise_the_pool(ticks):
    """The seeds do reach the paths each config is for."""
    name, out = ticks
    jm = [o[1] for o in out]
    steps = [float(m["server_steps"]) for m in jm]
    assert sum(steps) > 0, name
    if name == "flaky-scan-k2":
        assert max(steps) >= 2 and max(float(m["staleness_max"])
                                       for m in jm) > 0
        assert sum(float(m["fault_delayed"]) for m in jm) > 0
    if name == "max-staleness-1":
        assert sum(float(m["expired"]) for m in jm) > 0
    if name != "clean-scan-adam":
        assert min(float(m["buffer_fill"]) for m in jm[1:]) >= 0
        assert any(float(m["arrivals"]) < COHORT for m in jm)


# ---------------------------------------------------------------------------
# invariants within the port
# ---------------------------------------------------------------------------
def _run(fed, rounds, draws=None):
    """``rounds`` rounds (or ticks) of ``fed`` on the MLP from the JAX
    init; returns (state, per-round metrics)."""
    model = _torch_mlp()
    state = init_server_state(model, fed, params=_params0()[1])
    fn = make_federated_round(model, fed)
    data = FederatedData(**_arrays())
    ms = []
    for r in range(rounds):
        s = data.sample_round(r, cohort=COHORT, batch=8)
        state, m = fn(state, _to_t(s["cohort_batch"]),
                      _to_t(data.sample_meta(r, 8)),
                      torch.from_numpy(s["client_weights"]),
                      None if draws is None else draws(r))
        ms.append(m)
    return state, ms


def _bytes(t):
    return t.detach().numpy().tobytes()


def test_fault_free_tick_is_bitwise_the_sync_scan_round():
    sync = FedConfig(**BASE, cohort_strategy="scan", server_opt="adam")
    asyn = dataclasses.replace(sync, engine="buffered_async",
                               async_buffer=COHORT, async_capacity=COHORT)
    s_sync, m_sync = _run(sync, 3)
    FK.reset_launch_counts()
    s_async, m_async = _run(asyn, 3)
    for k in s_sync["params"]:
        assert _bytes(s_sync["params"][k]) == _bytes(s_async["params"][k])
    for slot in ("m", "v"):
        for a, b in zip(s_sync["opt"][slot], s_async["opt"][slot]):
            assert _bytes(a) == _bytes(b)
    assert int(s_sync["opt"]["t"]) == int(s_async["opt"]["t"]) == 3
    for a, b in zip(m_sync, m_async):
        for k in ("client_loss", "meta_loss", "grad_norm"):
            assert _bytes(a[k]) == _bytes(b[k]), k
        assert b["server_steps"] == 1 and b["arrivals"] == COHORT
        assert b["buffer_fill"] == 0


def test_vmap_base_tracks_the_sync_vmap_round():
    """The sync vmap cohort reduces with the aggregate pass, the flush
    streams: the same sum in another order."""
    sync = FedConfig(**{**BASE, "meta": False})
    asyn = dataclasses.replace(sync, engine="buffered_async",
                               async_buffer=COHORT, async_capacity=COHORT)
    s_sync, _ = _run(sync, 2)
    s_async, _ = _run(asyn, 2)
    assert max_tree_rel_err(s_async["params"], s_sync["params"]) <= 2e-5


def test_tick_without_a_flush_is_a_bitwise_no_op():
    """Every report late: nothing arrives, no flush, no FedMeta step;
    params and opt are the same tensors, meta_loss reads 0."""
    fed = FedConfig(**ASYNC, fault_delay=1.0, fault_max_delay=2,
                    server_opt="adam")
    model = _torch_mlp()
    state = init_server_state(model, fed, params=_params0()[1])
    data = FederatedData(**_arrays())
    s = data.sample_round(0, cohort=COHORT, batch=8)
    new, m = make_federated_round(model, fed)(
        state, _to_t(s["cohort_batch"]), _to_t(data.sample_meta(0, 8)),
        torch.from_numpy(s["client_weights"]), draw_round(fed, 0, 0, COHORT))
    assert new["params"] is state["params"] and new["opt"] is state["opt"]
    assert m["server_steps"] == 0 and m["meta_loss"] == 0.0
    assert m["grad_norm"] == 0.0 and m["arrivals"] == 0
    assert m["buffer_fill"] == COHORT and new["round"] == 1
    assert (new["async"]["deliver"][:COHORT] > 0).all()


def test_all_failed_tick_runs_no_client_and_flushes_late_deltas():
    """Tick 0: every report one tick late.  Tick 1: every client crashes,
    so no client runs (loss 0), but tick 0's deltas arrive and flush."""
    fed = FedConfig(**ASYNC, fault_delay=0.5, fault_max_delay=1,
                    fault_crash=0.5)
    f0 = draw_round(fed, 0, 0, COHORT).faults
    late = f0._replace(crashed=np.zeros(COHORT, bool),
                       dropped=np.zeros(COHORT, bool),
                       alive=np.ones(COHORT, np.float32),
                       delayed=np.ones(COHORT, bool),
                       delay=np.ones(COHORT, np.int32))
    dead = f0._replace(crashed=np.ones(COHORT, bool),
                       dropped=np.zeros(COHORT, bool),
                       alive=np.zeros(COHORT, np.float32),
                       delayed=np.zeros(COHORT, bool),
                       delay=np.zeros(COHORT, np.int32))
    calls = []
    fed_model = _torch_mlp()
    loss = fed_model.loss
    fed_model = dataclasses.replace(
        fed_model, loss=lambda *a, **k: calls.append(1) or loss(*a, **k))
    state = init_server_state(fed_model, fed, params=_params0()[1])
    fn = make_federated_round(fed_model, fed)
    data = FederatedData(**_arrays())
    ms = []
    for r, fs in enumerate((late, dead)):
        s = data.sample_round(r, cohort=COHORT, batch=8)
        calls.clear()
        state, m = fn(state, _to_t(s["cohort_batch"]),
                      _to_t(data.sample_meta(r, 8)),
                      torch.from_numpy(s["client_weights"]),
                      RoundDraws(faults=fs))
        ms.append((m, len(calls)))
    (m0, c0), (m1, c1) = ms
    assert m0["server_steps"] == 0 and c0 > 0
    assert m1["server_steps"] == 1 and m1["arrivals"] == COHORT
    assert m1["client_loss"] == 0.0 and m1["fault_crashed"] == COHORT
    assert c1 > 0            # the FedMeta step alone evaluates the loss
    assert float(m1["meta_loss"]) > 0


@pytest.mark.parametrize("strategy", ["vmap", "scan"])
def test_crashed_clients_residual_stays_byte_identical(strategy):
    fed = FedConfig(**ASYNC, codec="int8", error_feedback=True,
                    cohort_strategy=strategy, fault_crash=0.5,
                    fault_garble=0.0)
    model = _torch_mlp()
    state = init_server_state(model, fed, params=_params0()[1])
    res = state["comm"]["residual"][0]
    res.normal_(generator=torch.Generator().manual_seed(1)).mul_(1e-3)
    before = res.clone()
    fs = draw_round(fed, 0, 0, COHORT).faults
    crashed = np.zeros(COHORT, bool)
    crashed[1] = True
    fs = fs._replace(crashed=crashed, dropped=np.zeros(COHORT, bool),
                     alive=(~crashed).astype(np.float32))
    data = FederatedData(**_arrays())
    s = data.sample_round(0, cohort=COHORT, batch=8)
    new, m = make_federated_round(model, fed)(
        state, _to_t(s["cohort_batch"]), _to_t(data.sample_meta(0, 8)),
        torch.from_numpy(s["client_weights"]), RoundDraws(faults=fs))
    after = new["comm"]["residual"][0]
    assert m["comm_bytes"] == (COHORT - 1) * (224 + 4)
    assert after[1].numpy().tobytes() == before[1].numpy().tobytes()
    for k in (0, 2, 3):
        assert not torch.equal(after[k], before[k]), k


def test_pool_insert_writes_into_the_pool_in_place():
    """Arrivals take free or evicted physical slots: the pool tensors are
    the same objects tick after tick, the slot map stays a permutation,
    and overflow evicts (the logical order is held to JAX's in value by
    the parity tests)."""
    fed = FedConfig(**ASYNC, fault_profile="stragglers", async_buffer=3,
                    async_capacity=5)
    model = _torch_mlp()
    state = init_server_state(model, fed, params=_params0()[1])
    pool = state["async"]["pool"]
    one = make_federated_round(model, fed)
    data = FederatedData(**_arrays())
    overflow = 0.0
    for r in range(6):
        s = data.sample_round(r, cohort=COHORT, batch=8)
        state, m = one(state, _to_t(s["cohort_batch"]),
                       _to_t(data.sample_meta(r, 8)),
                       torch.from_numpy(s["client_weights"]),
                       draw_round(fed, 0, r, COHORT))
        assert state["async"]["pool"][0] is pool[0]
        assert sorted(state["async"]["slot"].tolist()) == list(range(5))
        overflow += float(m["overflow_dropped"])
    assert overflow > 0
    assert not np.array_equal(state["async"]["slot"], np.arange(5))


@pytest.mark.parametrize("mode", ["none", "inv", "invsqrt"])
def test_staleness_discount_matches_jax(mode):
    s = np.arange(0, 12, dtype=np.float32)
    ours = A.staleness_discount(mode)(s)
    ref = np.asarray(jax_discount(mode)(jnp.asarray(s)))
    assert ours.dtype == np.float32 and ours[0] == 1.0
    assert np.max(np.abs(ours - ref)) <= 1e-7
    if mode == "inv":
        assert ours[3] == 0.25


@pytest.mark.parametrize("kw,err,match", [
    (dict(async_buffer=9, async_capacity=4), ValueError, "deadlock"),
    (dict(round_deadline=2.0), ValueError, "async_max_staleness"),
    (dict(meta_mode="through_aggregation"), ValueError,
     "through_aggregation"),
    (dict(staleness_mode="quadratic"), ValueError, "staleness_mode"),
    (dict(async_buffer=-1), ValueError, "async_buffer"),
], ids=["deadlock", "deadline", "through_aggregation", "staleness_mode",
        "negative"])
def test_async_config_errors_as_in_jax(kw, err, match):
    with pytest.raises(err, match=match):
        FedConfig(**{**ASYNC, **kw})
    with pytest.raises(err, match=match):
        JaxFedConfig(**{**ASYNC, **kw})


def test_async_executor_refusals_and_engine():
    exe = get_executor("buffered_async")
    ns = lambda **kw: types.SimpleNamespace(  # noqa: E731
        **{"cohort_strategy": "scan", "cohort_chunk": None, **kw})
    with pytest.raises(ValueError, match="cohort_chunk"):
        exe(ns(cohort_chunk=2))
    with pytest.raises(ValueError, match="vmap' or 'scan"):
        exe(ns(cohort_strategy="chunked"))
    with pytest.raises(ValueError, match="grad_shardings"):
        exe(ns(), grad_shardings=object())
    with pytest.raises(NotImplementedError, match="engine='buffered_async'"):
        exe(ns()).run()
    # engine='legacy_tree' builds the config the JAX package builds, and
    # resolves to its synchronous tree engine
    from repro.core.engines import resolve_engine as jax_resolve_engine
    from repro_torch.core.engines import get_engine, resolve_engine
    legacy = {**BASE, "engine": "legacy_tree"}
    assert dataclasses.asdict(FedConfig(**legacy)) == dataclasses.asdict(
        JaxFedConfig(**legacy))
    for e in (resolve_engine(FedConfig(**legacy)),
              jax_resolve_engine(JaxFedConfig(**legacy))):
        assert e.name == "legacy_tree" and not e.is_async
    eng = get_engine("buffered_async")
    assert eng.is_async and eng.meta_capabilities == {"post"}
    # an explicit garble reaches the async engine and is kept in its draws
    fed = FedConfig(**ASYNC, fault_garble=1.0)
    d = draw_round(fed, 0, 0, 64)
    assert d.faults.garbled.any() and (d.faults.garble_mult != 1).any()
