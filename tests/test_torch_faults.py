"""The synchronous fault model, the port against the JAX package:
participation, crash / drop / deadline faults, the no-op round when every
client failed, error feedback under faults, and retry with backoff.

The JAX package draws each round's masks and fault streams with threefry
from the round key; the port draws its own with numpy
(``repro_torch.sim.faults``).  So the parity tests draw with JAX's
``participation_mask`` / ``fault_streams`` for the JAX round's keys and
hand the same draws to the port's round (``RoundDraws``) and trainer
(``FederatedTrainer.draw_round``).  The model is a small MLP written for
both packages (``tests/test_async_faults.py``'s), so the JAX programs
compile in seconds; parameters start from the JAX init.

Tolerances, max |a-b| over max |b|: parameters 1e-5, metrics 1e-4 (the
JAX suite's across engines), the counts (participants, arrivals, faults,
retries) and ``comm_bytes`` exactly; byte-identical where the port's own
contract says so (``heavy_tail_speeds``, ``sample_round``, the state of
an all-failed round, a failed client's residual)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import max_tree_rel_err
from repro.configs import FedConfig as JaxFedConfig
from repro.core import FederatedTrainer as JaxTrainer
from repro.core.round import init_server_state as jax_init_state
from repro.core.round import make_federated_round as jax_make_round
from repro.core.round import participation_mask as jax_participation_mask
from repro.core.rngtags import round_key
from repro.data.pipeline import FederatedData as JaxFederatedData
from repro.models.model import Model as JaxModel
from repro.sim import faults as JF
from repro_torch.configs import FedConfig
from repro_torch.core.round import (RoundDraws, draw_round,
                                    init_server_state, make_federated_round)
from repro_torch.core.trainer import FederatedTrainer
from repro_torch.data.pipeline import FederatedData
from repro_torch.models.model import Model
from repro_torch.sim import faults as TF

COHORT = 4
BASE = dict(algorithm="uga", meta=True, cohort=COHORT, local_steps=2,
            client_lr=0.05, server_lr=0.05, meta_lr=0.05, lr_decay=0.992,
            fused_update=True)


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


def _arrays(n=256, clients=8, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, 10)).astype(np.float32)
    y = rng.integers(0, 4, n).astype(np.int32)
    parts = np.array_split(rng.permutation(n), clients)
    meta = rng.choice(n, 32, replace=False)
    return dict(arrays={"x": x, "y": y}, client_indices=parts,
                meta_indices=meta, seed=seed)


def _params0():
    w = _jax_mlp().init(jax.random.PRNGKey(0))
    return w, {k: torch.from_numpy(np.array(v)) for k, v in w.items()}


def _to_t(batch):
    """A numpy batch as the trainer hands it over: integer leaves int64."""
    return {k: (torch.from_numpy(v) if v.dtype.kind == "f"
                else torch.from_numpy(v).long()) for k, v in batch.items()}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _port_streams(fs) -> TF.FaultStreams:
    return TF.FaultStreams(*(np.asarray(a) for a in fs))


def _jax_draws(fed, key, cohort=COHORT) -> RoundDraws:
    """The draws JAX's round takes under round key ``key``, as the port's
    ``RoundDraws`` (garble zeroed as a synchronous round zeroes it)."""
    fc = dataclasses.replace(JF.resolve_faults(fed), garble=0.0)
    return RoundDraws(
        participation=(np.asarray(jax_participation_mask(
            key, cohort, fed.participation)) if fed.participation < 1.0
            else None),
        faults=(_port_streams(JF.fault_streams(key, cohort, fc))
                if fc.active else None))


# ---------------------------------------------------------------------------
# the fault config and the host-side streams
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [
    dict(), dict(fault_profile="flaky"), dict(fault_profile="stragglers"),
    dict(fault_profile="flaky", fault_drop=0.3, fault_max_delay=5),
    dict(fault_crash=0.2, round_deadline=2.5, fault_speed_tail=1.5),
    dict(fault_delay=0.5, fault_max_delay=2, fault_garble_scale=2.0),
], ids=["none", "flaky", "stragglers", "flaky-overridden", "crash-deadline",
        "delay"])
def test_resolve_faults_matches_jax(kw):
    ours = TF.resolve_faults(FedConfig(fused_update=True, **kw))
    ref = JF.resolve_faults(JaxFedConfig(**kw))
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.active == ref.active


@pytest.mark.parametrize("kw,match", [
    (dict(fault_profile="chaos"), "unknown fault_profile"),
    (dict(fault_drop=1.5), "fault_drop"),
    (dict(fault_crash=2.0), "fault_crash"),
    (dict(fault_delay=0.2, fault_max_delay=0), "fault_max_delay"),
    (dict(fault_garble_scale=0.0), "fault_garble_scale"),
    (dict(round_deadline=-1.0), "round_deadline"),
    (dict(retry_backoff=-1), "retry_backoff"),
    (dict(staleness_mode="quadratic"), "staleness_mode"),
], ids=["profile", "drop", "crash", "max_delay", "garble_scale", "deadline",
        "retry", "staleness"])
def test_bad_fault_knobs_raise_as_in_jax(kw, match):
    with pytest.raises(ValueError, match=match):
        FedConfig(fused_update=True, **kw)
    with pytest.raises(ValueError, match=match):
        JaxFedConfig(**kw)


def test_explicit_garble_on_a_sync_engine_raises():
    """Payload corruption is the async half's; a profile's garble is
    zeroed on a synchronous round, an explicit one is an error."""
    with pytest.raises(ValueError, match="fault_garble"):
        make_federated_round(_torch_mlp(), FedConfig(**BASE,
                                                     fault_garble=0.1))
    with pytest.raises(ValueError, match="fault_garble"):
        jax_make_round(_jax_mlp(), JaxFedConfig(**BASE, fault_garble=0.1))
    d = draw_round(FedConfig(**BASE, fault_profile="flaky"), 0, 3, 64)
    assert not d.faults.garbled.any() and (d.faults.garble_mult == 1).all()


@pytest.mark.parametrize("seed,n,sigma", [(0, 8, 0.5), (3, 100, 1.0),
                                          (7, 1, 0.0)])
def test_heavy_tail_speeds_byte_identical(seed, n, sigma):
    a = TF.heavy_tail_speeds(seed, n, sigma)
    b = JF.heavy_tail_speeds(seed, n, sigma)
    assert a.dtype == b.dtype == np.float32 and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("include", [None, [], [5], [5, 6, 7, 0, 5],
                                     [1, 2, 3, 4, 5, 6], [99, -1]],
                         ids=["none", "empty", "one", "dupes", "overfull",
                              "out-of-range"])
def test_sample_round_include_byte_identical(include):
    arrays = _arrays()
    speeds = TF.heavy_tail_speeds(0, 8)
    ours = FederatedData(**arrays, client_speeds=speeds)
    ref = JaxFederatedData(**arrays, client_speeds=speeds)
    for r in range(3):
        a = ours.sample_round(r, cohort=COHORT, batch=6, include=include)
        b = ref.sample_round(r, cohort=COHORT, batch=6, include=include)
        assert set(a) == set(b) == {"cohort_batch", "client_weights",
                                    "clients", "client_speeds"}
        for k in ("client_weights", "clients", "client_speeds"):
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == \
                b[k].tobytes(), k
        for k in b["cohort_batch"]:
            assert a["cohort_batch"][k].tobytes() == \
                b["cohort_batch"][k].tobytes()
    plain = FederatedData(**arrays).sample_round(1, cohort=COHORT, batch=6)
    assert "client_speeds" not in plain
    assert plain["clients"].tobytes() == ours.sample_round(
        1, cohort=COHORT, batch=6, include=[])["clients"].tobytes()


def test_port_streams_are_seeded_and_shaped_as_jax():
    fed = FedConfig(**BASE, participation=0.5, fault_profile="flaky",
                    round_deadline=2.0)
    a, b = draw_round(fed, 0, 3, 64), draw_round(fed, 0, 3, 64)
    c = draw_round(fed, 0, 4, 64)
    assert a.participation.tobytes() == b.participation.tobytes()
    assert all(x.tobytes() == y.tobytes() for x, y in zip(a.faults,
                                                          b.faults))
    assert a.faults.crashed.tobytes() != c.faults.crashed.tobytes() or \
        a.faults.latency.tobytes() != c.faults.latency.tobytes()
    ref = _jax_draws(JaxFedConfig(**BASE, participation=0.5,
                                  fault_profile="flaky", round_deadline=2.0),
                     jax.random.PRNGKey(0), 64)
    assert a.participation.dtype == ref.participation.dtype
    for x, y in zip(a.faults, ref.faults):
        assert x.dtype == y.dtype and x.shape == y.shape == (64,)
    assert not (a.faults.dropped & a.faults.crashed).any()
    assert (a.faults.delay[~a.faults.delayed] == 0).all()
    fresh = draw_round(FedConfig(**BASE), 0, 3, 64)
    assert fresh.participation is None and fresh.faults is None


# ---------------------------------------------------------------------------
# the round under JAX's draws
# ---------------------------------------------------------------------------
ROUND_CONFIGS = {
    "participation": dict(participation=0.5),
    "crash-drop": dict(fault_crash=0.3, fault_drop=0.3),
    "flaky-deadline-scan": dict(fault_profile="flaky", round_deadline=2.0,
                                cohort_strategy="scan"),
    "participation-int8-ef": dict(participation=0.75, fault_crash=0.25,
                                  codec="int8", error_feedback=True),
}


@pytest.fixture(scope="module", params=list(ROUND_CONFIGS))
def rounds(request):
    """Five rounds of JAX's round program and the port's round under the
    same draws; each round's JAX and port (state, metrics)."""
    kw = {**BASE, **ROUND_CONFIGS[request.param]}
    jfed, tfed = JaxFedConfig(**kw), FedConfig(**kw)
    jw, tw = _params0()
    jmodel = _jax_mlp()
    jround = jax.jit(jax_make_round(jmodel, jfed))
    jstate = jax_init_state(jmodel, jfed, jax.random.PRNGKey(0))
    jstate["params"] = jw
    tround = make_federated_round(_torch_mlp(), tfed)
    tstate = init_server_state(_torch_mlp(), tfed, params=tw)
    data = FederatedData(**_arrays())
    key = jax.random.PRNGKey(11)
    out, failed = [], []
    for r in range(5):
        s = data.sample_round(r, cohort=COHORT, batch=8)
        meta = data.sample_meta(r, 8)
        rk = round_key(key, r)
        jstate, jm = jround(jstate, jax.tree.map(jnp.asarray,
                                                 s["cohort_batch"]),
                            jax.tree.map(jnp.asarray, meta),
                            jnp.asarray(s["client_weights"]), rk)
        draws = _jax_draws(jfed, rk)
        keep = (np.ones(COHORT, bool) if draws.participation is None
                else draws.participation > 0)
        if draws.faults is not None:
            keep &= ~TF.client_failed_mask(draws.faults,
                                           TF.resolve_faults(jfed))
        failed.append(~keep)
        tstate, tm = tround(tstate, _to_t(s["cohort_batch"]), _to_t(meta),
                            torch.from_numpy(s["client_weights"]), draws)
        # a copy: the port's uplink updates the residual stacks in place
        snap = {**tstate, "comm": {"residual": tuple(
            t.clone() for t in tstate["comm"]["residual"])}} \
            if "comm" in tstate else tstate
        out.append((jax.tree.map(np.asarray, jstate),
                    {k: float(v) for k, v in jm.items()}, snap,
                    {k: float(v) for k, v in tm.items()}))
    return request.param, out, failed


COUNTS = ("participants", "arrivals", "fault_crashed", "fault_dropped",
          "fault_timeout", "comm_bytes")


def test_round_under_jax_draws_matches_jax(rounds):
    """Params after every round within 1e-5; the same metric keys; the
    counts exactly, the rest within 1e-4 (a round whose clients all failed
    reads 0 in both)."""
    name, out, draws_failed = rounds
    for r, (js, jm, ts, tm) in enumerate(out):
        assert set(tm) == set(jm), (r, sorted(tm), sorted(jm))
        for k in jm:
            if k in COUNTS:
                assert tm[k] == jm[k], (name, r, k)
            else:
                assert abs(tm[k] - jm[k]) <= 1e-4 * abs(jm[k]) + 1e-7, (
                    name, r, k, tm[k], jm[k])
        assert max_tree_rel_err(ts["params"], js["params"]) <= 1e-5, r
        assert ts["round"] == int(js["round"]) == r + 1
        if "comm" in js:
            # the residual is the small remainder of a gradient about 100
            # times its size, whose 1e-5 shows up here as 1e-3; a failed
            # client's slot keeps its bytes in both packages
            res, jres = ts["comm"]["residual"][0], js["comm"]["residual"][0]
            assert max_tree_rel_err({"r": res}, {"r": jres}) <= 1e-3, r
            prev = (out[r - 1][2]["comm"]["residual"][0] if r
                    else torch.zeros_like(res))
            jprev = (out[r - 1][0]["comm"]["residual"][0] if r
                     else np.zeros_like(jres))
            for k in np.flatnonzero(draws_failed[r]):
                assert res[k].numpy().tobytes() == prev[k].numpy().tobytes()
                assert jres[k].tobytes() == jprev[k].tobytes()


def test_rounds_under_jax_draws_saw_faults(rounds):
    """The draws this module's seeds give do exercise the fault paths."""
    name, out, _ = rounds
    jm = [o[1] for o in out]
    if "participants" in jm[0]:
        assert min(m["participants"] for m in jm) < COHORT
    if "arrivals" in jm[0]:
        assert min(m["arrivals"] for m in jm) < COHORT
        assert sum(m["fault_crashed"] + m["fault_dropped"]
                   + m.get("fault_timeout", 0.0) for m in jm) > 0


# ---------------------------------------------------------------------------
# a round in which every client failed
# ---------------------------------------------------------------------------
def _all_failed(fed) -> RoundDraws:
    return draw_round(fed, 0, 0, COHORT)


@pytest.mark.parametrize("kw", [
    dict(fault_crash=1.0),
    dict(fault_crash=1.0, cohort_strategy="scan", server_opt="adam"),
    dict(fault_crash=1.0, meta_mode="through_aggregation"),
    dict(fault_crash=1.0, codec="int8", error_feedback=True),
], ids=["post-vmap-sgd", "post-scan-adam", "through_aggregation",
        "int8-ef"])
def test_all_failed_round_is_a_bitwise_no_op(kw):
    """params, opt, ctrl and comm keep their bytes (the same tensors: the
    round runs nothing), the counter advances, the loss and norm metrics
    read 0, and the keys are those of a stepped round."""
    fed = FedConfig(**BASE, **kw)
    model = _torch_mlp()
    _, tw = _params0()
    state = init_server_state(model, fed, params=tw)
    if "comm" in state:
        state["comm"]["residual"][0].normal_(generator=torch.Generator()
                                             .manual_seed(0))
    before = {k: [t.clone() for t in _leaves(v)] for k, v in
              state.items() if k != "round"}
    data = FederatedData(**_arrays())
    s, meta = data.sample_round(0, cohort=COHORT, batch=8), \
        data.sample_meta(0, 8)
    draws = _all_failed(fed)
    assert draws.faults.crashed.all()
    new, m = make_federated_round(model, fed)(
        state, _to_t(s["cohort_batch"]), _to_t(meta),
        torch.from_numpy(s["client_weights"]), draws)
    assert new["round"] == 1
    for k, leaves in before.items():
        for a, b in zip(_leaves(new[k]), leaves):
            assert a.dtype == b.dtype and torch.equal(
                a.view(torch.uint8) if a.dim() else a.reshape(1).view(
                    torch.uint8),
                b.view(torch.uint8) if b.dim() else b.reshape(1).view(
                    torch.uint8)), k
    m = {k: float(v) for k, v in m.items()}
    assert m["client_loss"] == m["grad_norm"] == m["meta_loss"] == 0.0
    assert m["arrivals"] == 0.0 and m["fault_crashed"] == COHORT
    stepped = dataclasses.replace(fed, fault_crash=0.0)
    _, m1 = make_federated_round(model, stepped)(
        init_server_state(model, stepped, params=tw),
        _to_t(s["cohort_batch"]), _to_t(meta),
        torch.from_numpy(s["client_weights"]))
    assert set(m) - {"arrivals", "fault_crashed", "fault_dropped"} == set(m1)


def test_all_failed_round_matches_jax_keys_and_values():
    """JAX's round at a key whose draws fail every client: the same keys
    and values, NaN-aware, in both meta modes (under
    ``through_aggregation`` ``ctrl_w_gnorm`` reads NaN in both packages,
    JAX's a 0/0 of its weight normalization at all-zero weights), and
    the parameters byte-identical."""
    for mode in ("post", "through_aggregation"):
        kw = {**BASE, "participation": 0.5, "fault_crash": 0.5,
              "meta_mode": mode}
        jfed = JaxFedConfig(**kw)
        key = next(round_key(jax.random.PRNGKey(0), r) for r in range(200)
                   if not np.any(np.asarray(_jax_draws(
                       jfed, round_key(jax.random.PRNGKey(0), r))
                       .participation) * ~TF.client_failed_mask(_jax_draws(
                           jfed, round_key(jax.random.PRNGKey(0), r)).faults,
                           TF.resolve_faults(jfed))))
        jw, tw = _params0()
        jstate = jax_init_state(_jax_mlp(), jfed, jax.random.PRNGKey(0))
        jstate["params"] = jw
        data = FederatedData(**_arrays())
        s, meta = data.sample_round(0, cohort=COHORT, batch=8), \
            data.sample_meta(0, 8)
        jnew, jm = jax.jit(jax_make_round(_jax_mlp(), jfed))(
            jstate, jax.tree.map(jnp.asarray, s["cohort_batch"]),
            jax.tree.map(jnp.asarray, meta),
            jnp.asarray(s["client_weights"]), key)
        tstate = init_server_state(_torch_mlp(), FedConfig(**kw), params=tw)
        tnew, tm = make_federated_round(_torch_mlp(), FedConfig(**kw))(
            tstate, _to_t(s["cohort_batch"]), _to_t(meta),
            torch.from_numpy(s["client_weights"]), _jax_draws(jfed, key))
        assert set(tm) == set(jm), mode
        for k in jm:
            a, b = float(tm[k]), float(jm[k])
            assert a == b or (np.isnan(a) and np.isnan(b)), (mode, k, a, b)
        if mode == "through_aggregation":
            assert np.isnan(float(jm["ctrl_w_gnorm"]))
        for k in jw:
            assert np.asarray(jnew["params"][k]).tobytes() == \
                np.asarray(jw[k]).tobytes() == \
                tnew["params"][k].numpy().tobytes()


# ---------------------------------------------------------------------------
# error feedback under faults
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("strategy", ["vmap", "scan"])
def test_failed_clients_residual_stays_byte_identical(strategy):
    """int8 with error feedback, client 1 crashed, the others alive: slot 1
    of the residual keeps its bytes, every other slot moves."""
    fed = FedConfig(**BASE, codec="int8", error_feedback=True,
                    cohort_strategy=strategy, fault_crash=0.5)
    model = _torch_mlp()
    _, tw = _params0()
    state = init_server_state(model, fed, params=tw)
    res = state["comm"]["residual"][0]
    res.normal_(generator=torch.Generator().manual_seed(1)).mul_(1e-3)
    before = res.clone()
    fs = draw_round(fed, 0, 0, COHORT).faults
    crashed = np.zeros(COHORT, bool)
    crashed[1] = True
    fs = fs._replace(crashed=crashed, dropped=np.zeros(COHORT, bool),
                     alive=(~crashed).astype(np.float32))
    data = FederatedData(**_arrays())
    s, meta = data.sample_round(0, cohort=COHORT, batch=8), \
        data.sample_meta(0, 8)
    new, m = make_federated_round(model, fed)(
        state, _to_t(s["cohort_batch"]), _to_t(meta),
        torch.from_numpy(s["client_weights"]), RoundDraws(faults=fs))
    after = new["comm"]["residual"][0]
    assert float(m["arrivals"]) == COHORT - 1
    assert after[1].numpy().tobytes() == before[1].numpy().tobytes()
    for k in (0, 2, 3):
        assert not torch.equal(after[k], before[k]), k


# ---------------------------------------------------------------------------
# retry with backoff
# ---------------------------------------------------------------------------
RETRY = dict(BASE, meta=False, cohort_strategy="scan", fault_crash=0.5,
             fault_max_delay=0, retry_backoff=1, retry_max=2)


def test_trainer_retry_reenqueues_failed_clients():
    """As JAX's ``test_trainer_retry_reenqueues_failed_clients``, on the
    port's own draws: retries happen and an identical run retries
    identically, to the same bytes."""
    runs = []
    for _ in range(2):
        tr = FederatedTrainer(_torch_mlp(), FedConfig(**RETRY), seed=0,
                              device="cpu", params=_params0()[1])
        hist = tr.run(FederatedData(**_arrays()), rounds=8, cohort=COHORT,
                      batch=8)
        runs.append((hist, tr.state))
    (h1, s1), (h2, s2) = runs
    assert all("retried" in h for h in h1)
    assert sum(h["retried"] for h in h1) > 0
    assert [h["retried"] for h in h1] == [h["retried"] for h in h2]
    for k in s1["params"]:
        assert torch.equal(s1["params"][k], s2["params"][k])


def test_trainer_retry_under_jax_draws_matches_jax_trainer():
    """The port's trainer handed JAX's draws (``draw_round`` replaced):
    the same clients re-enqueued and sampled, the same ``retried`` and
    fault counts each round, parameters within 1e-5."""
    jfed = JaxFedConfig(**RETRY)
    jt = JaxTrainer(_jax_mlp(), jfed, seed=0)
    jt.state["params"] = _params0()[0]
    jh = jt.run(JaxFederatedData(**_arrays()), rounds=8, cohort=COHORT,
                batch=8)
    tt = FederatedTrainer(_torch_mlp(), FedConfig(**RETRY), seed=0,
                          device="cpu", params=_params0()[1])
    tt.draw_round = lambda r, cohort: _jax_draws(
        jfed, round_key(jt.key, r), cohort)
    th = tt.run(FederatedData(**_arrays()), rounds=8, cohort=COHORT, batch=8)
    assert sum(h["retried"] for h in jh) > 0
    for jr, tr in zip(jh, th):
        assert set(tr) == set(jr)
        for k in ("retried", "arrivals", "fault_crashed", "fault_dropped"):
            assert tr[k] == jr[k], (jr["round"], k)
        assert abs(tr["client_loss"] - jr["client_loss"]) <= \
            1e-4 * abs(jr["client_loss"])
    assert tt._retry_due == {k: v for k, v in jt._retry_due.items()}
    assert max_tree_rel_err(tt.state["params"], jax.tree.map(
        np.asarray, jt.state["params"])) <= 1e-5
