"""Multi-round calls (``rounds_per_call=K``) in the port: the trainer's
chunks of K rounds with a tail, sampled on the host up front and read back
once, against K = 1 in the port (bitwise: the same operations in the same
order) and against the JAX trainer at K = 2 (the JAX suite's tolerances:
parameters 1e-5, metrics 1e-4, counts exactly); retries under faults,
deferred past the chunk as JAX defers them; managed checkpoints on chunk
boundaries; the buffered-async tick at K = 2; and ``train_method``'s
evaluation rounds at its default K = 4 against ``benchmarks/common.py``'s.

The model is the small MLP of ``test_torch_faults.py``; parameters start
from the JAX init, the data are its ``_arrays``.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import max_tree_rel_err
from benchmarks.common import train_method as jax_train_method
from repro.configs import FedConfig as JaxFedConfig
from repro.core import FederatedTrainer as JaxTrainer
from repro.core.rngtags import round_key
from repro.data.pipeline import FederatedData as JaxFederatedData
from repro.models.model import Model as JaxModel
from repro_torch.configs import FedConfig
from repro_torch.core.round import (RoundFnCache, make_federated_round,
                                    stack_round_inputs)
from repro_torch.core.trainer import FederatedTrainer
from repro_torch.data.pipeline import FederatedData
from repro_torch.experiments.common import train_method
from repro_torch.models.model import Model
from test_torch_faults import (BASE, COHORT, _arrays, _jax_draws, _jax_mlp,
                               _params0, _torch_mlp)

TOL, TOL_METRIC = 1e-5, 1e-4
RUN = dict(rounds=5, cohort=COHORT, batch=8, meta_batch=8)


def _leaves(state):
    """Every tensor or array of a server state, keyed by its path."""
    out = {}

    def walk(x, path):
        if isinstance(x, dict):
            for k, v in x.items():
                walk(v, f"{path}/{k}")
        elif isinstance(x, (tuple, list)):
            for i, v in enumerate(x):
                walk(v, f"{path}/{i}")
        else:
            out[path] = x
    walk(state, "")
    return out


def _bitwise(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return (a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a.view(-1).view(torch.uint8),
                                b.view(-1).view(torch.uint8)))
    return np.asarray(a).tobytes() == np.asarray(b).tobytes()


def _train(kw, k, rounds=5):
    tr = FederatedTrainer(_torch_mlp(), FedConfig(**kw), rounds_per_call=k,
                          seed=0, device="cpu", params=_params0()[1])
    calls = []
    hist = tr.run(FederatedData(**_arrays()), **{**RUN, "rounds": rounds},
                  on_records=lambda recs, t: calls.append(
                      [r["round"] for r in recs]))
    return tr, hist, calls


CASES = {
    "fused-vmap-sgd": dict(BASE),
    "legacy-scan-adam": dict(BASE, fused_update=False,
                             cohort_strategy="scan", server_opt="adam",
                             clip_norm=1.0),
    "through-participation": dict(BASE, meta_mode="through_aggregation",
                                  participation=0.75),
    "async-flaky": dict(BASE, engine="buffered_async", async_buffer=2,
                        async_capacity=6, fault_profile="flaky",
                        participation=0.75),
}


@pytest.mark.parametrize("case", list(CASES))
def test_k2_with_a_tail_is_k1_bitwise(case):
    """5 rounds (or async ticks) at K = 2 — calls of 2, 2 and a tail of 1
    — against 5 calls of K = 1: every state leaf and every record bitwise,
    ``on_records`` once a call with that call's records.  No retries:
    K > 1 schedules them past the chunk by design."""
    (t1, h1, c1), (t2, h2, c2) = (_train(CASES[case], k) for k in (1, 2))
    assert c1 == [[r] for r in range(5)] and c2 == [[0, 1], [2, 3], [4]]
    assert h2 == h1 and t2.history == t1.history
    l1, l2 = _leaves(t1.state), _leaves(t2.state)
    assert set(l1) == set(l2)
    for path in l1:
        assert _bitwise(l2[path], l1[path]), path


@pytest.fixture(scope="module")
def jax_k2():
    """The JAX trainer at rounds_per_call=2, 5 rounds: one K = 2 program
    and one tail program, compiled once for the module."""
    jt = JaxTrainer(_jax_mlp(), JaxFedConfig(**BASE), rounds_per_call=2,
                    seed=0)
    jt.state["params"] = _params0()[0]
    return jt, jt.run(JaxFederatedData(**_arrays()), **RUN)


def test_k2_matches_jax_trainer(jax_k2):
    jt, jh = jax_k2
    tt, th, _ = _train(BASE, 2)
    assert [r["round"] for r in th] == [r["round"] for r in jh]
    for jr, tr in zip(jh, th):
        assert set(tr) == set(jr)
        for k in set(jr) - {"round"}:
            assert abs(tr[k] - jr[k]) <= TOL_METRIC * abs(jr[k]), (k, tr, jr)
    assert max_tree_rel_err(tt.state["params"], jax.tree.map(
        np.asarray, jt.state["params"])) <= TOL


RETRY = dict(BASE, meta=False, cohort_strategy="scan", fault_crash=0.5,
             fault_max_delay=0, retry_backoff=1, retry_max=2)


def test_retries_under_faults_at_k2_match_jax():
    """Retry with backoff at K = 2, the port handed JAX's draws: a client
    that fails in a chunk is re-enqueued no earlier than the next chunk,
    ``max(r + j + backoff * 2**a, r + k)``, as JAX schedules it — the
    same ``retried`` and fault counts each round and the same queue."""
    jfed = JaxFedConfig(**RETRY)
    jt = JaxTrainer(_jax_mlp(), jfed, rounds_per_call=2, seed=0)
    jt.state["params"] = _params0()[0]
    jh = jt.run(JaxFederatedData(**_arrays()), rounds=8, cohort=COHORT,
                batch=8)
    tt = FederatedTrainer(_torch_mlp(), FedConfig(**RETRY),
                          rounds_per_call=2, seed=0, device="cpu",
                          params=_params0()[1])
    tt.draw_round = lambda r, cohort: _jax_draws(
        jfed, round_key(jt.key, r), cohort)
    th = tt.run(FederatedData(**_arrays()), rounds=8, cohort=COHORT, batch=8)
    assert sum(h["retried"] for h in jh) > 0
    for jr, tr in zip(jh, th):
        assert set(tr) == set(jr)
        for k in ("retried", "arrivals", "fault_crashed", "fault_dropped"):
            assert tr[k] == jr[k], (jr["round"], k)
        assert abs(tr["client_loss"] - jr["client_loss"]) <= \
            TOL_METRIC * abs(jr["client_loss"])
    assert tt._retry_due == dict(jt._retry_due)
    assert max_tree_rel_err(tt.state["params"], jax.tree.map(
        np.asarray, jt.state["params"])) <= TOL


def test_managed_checkpoints_on_chunk_boundaries(tmp_path):
    """7 rounds at K = 2 with a save every 3 rounds: a save when a chunk
    crosses a multiple of 3 (after rounds 4 and 6) and at run end (7), the
    steps JAX's trainer keeps; the newest restores the final state."""
    kw = dict(RUN, rounds=7)
    jt = JaxTrainer(_jax_mlp(), JaxFedConfig(**BASE), rounds_per_call=2,
                    seed=0, run_dir=str(tmp_path / "jax"),
                    checkpoint_every=3)
    jt.run(JaxFederatedData(**_arrays()), **kw)
    jt.finish()
    tt = FederatedTrainer(_torch_mlp(), FedConfig(**BASE), rounds_per_call=2,
                          seed=0, device="cpu", params=_params0()[1],
                          run_dir=str(tmp_path / "port"), checkpoint_every=3)
    tt.run(FederatedData(**_arrays()), **kw)
    tt.finish()
    steps = []
    for d in ("jax", "port"):
        with open(tmp_path / d / "checkpoints" / "manifest.json") as f:
            man = json.load(f)
        steps.append(sorted(e["step"] if isinstance(e, dict) else e
                            for e in man["steps"]))
        assert sorted(os.listdir(tmp_path / d / "checkpoints")) == [
            "manifest.json"] + [f"step_{s:08d}.msgpack" for s in steps[-1]]
    assert steps[0] == steps[1] == [4, 6, 7]
    back = FederatedTrainer(_torch_mlp(), FedConfig(**BASE), device="cpu",
                            params=_params0()[1],
                            run_dir=str(tmp_path / "port"),
                            checkpoint_every=3)
    assert back.resume_latest() == 7
    assert all(torch.equal(back.state["params"][k], tt.state["params"][k])
               for k in tt.state["params"])
    back.finish()


def test_round_fn_cache_and_stacked_inputs():
    """``RoundFnCache`` builds one function per K; ``stack_round_inputs``
    stacks K samples on a leading axis (integers as int64) and keeps the
    draws a list; a K-round function returns metrics with a leading K.
    ``sanitize=True`` builds probed rounds, as JAX's builds checkified
    ones: bitwise the plain call on clean inputs, and a ``SanitizeError``
    naming the flat group and the round on non-finite parameters."""
    from repro_torch.core.sanitize import SanitizeError
    model = _torch_mlp()
    fed = FedConfig(**BASE)
    cache = RoundFnCache(model, fed)
    assert cache(1) is cache(1) and cache(3) is cache(3)
    probed = RoundFnCache(model, fed, sanitize=True)
    assert probed(3) is probed(3) and probed(3) is not cache(3)
    with pytest.raises(ValueError, match="rounds_per_call"):
        make_federated_round(model, fed, rounds_per_call=0)
    data = FederatedData(**_arrays())
    samples = [data.sample_round(r, cohort=COHORT, batch=8)
               for r in range(3)]
    metas = [data.sample_meta(r, 8) for r in range(3)]
    cb, mb, w, draws = stack_round_inputs(
        [s["cohort_batch"] for s in samples], metas,
        [s["client_weights"] for s in samples], [None] * 3)
    assert cb["x"].shape == (3, COHORT, 8, 10) and cb["y"].dtype == \
        torch.int64 and mb["x"].shape == (3, 8, 10)
    assert w.shape == (3, COHORT) and w.dtype == torch.float32
    assert draws is None
    from repro_torch.core.round import init_server_state
    state = init_server_state(model, fed, params=_params0()[1])
    state, m = cache(3)(state, cb, mb, w, draws)
    assert state["round"] == 3
    assert all(v.shape[0] == 3 for v in m.values()), m
    ps, pm = probed(3)(init_server_state(model, fed, params=_params0()[1]),
                       cb, mb, w, draws)
    assert all(_bitwise(a, b) for a, b in zip(_leaves(ps).values(),
                                              _leaves(state).values()))
    assert all(torch.equal(pm[k], m[k]) for k in m)
    bad = {k: v.clone() for k, v in _params0()[1].items()}
    bad["w2"][0, 0] = float("nan")
    with pytest.raises(SanitizeError, match="flat group 0 .* round 0"):
        probed(3)(init_server_state(model, fed, params=bad), cb, mb, w,
                  draws)


def _jax_with_acc(m):
    """The JAX MLP with the accuracy metric ``evaluate`` reads."""
    def loss(w, batch, rng=None):
        logits = jnp.tanh(batch["x"] @ w["w1"]) @ w["w2"]
        acc = jnp.mean((jnp.argmax(logits, -1) == batch["y"]).astype(
            jnp.float32))
        return m.loss(w, batch, rng)[0], {"acc": acc}
    return JaxModel(name="mlp", init=m.init, loss=loss)


def _torch_with_acc(m):
    def loss(w, batch, rng=None):
        logits = torch.tanh(batch["x"] @ w["w1"]) @ w["w2"]
        acc = torch.mean((logits.argmax(-1) == batch["y"]).to(
            torch.float32))
        return m.loss(w, batch, rng)[0], {"acc": acc}
    return Model(name="mlp", init=None, loss=loss)


def test_train_method_k4_evaluates_where_benchmarks_does():
    """``train_method`` at its JAX defaults (fused, rounds_per_call=4): 6
    rounds in calls of 4 and 2, evaluated after each call that reaches a
    multiple of ``eval_every`` = 2 or the last round — rounds 3 and 5, as
    ``benchmarks/common.py::train_method`` evaluates; the evaluations
    within the JAX suite's tolerances."""
    common = dict(rounds=6, cohort=COHORT, batch=8, local_steps=2, lr=0.05,
                  eval_idx=np.arange(0, 64, 2), eval_every=2, seed=0,
                  meta_batch=8)
    jh = jax_train_method(_jax_with_acc(_jax_mlp()),
                          JaxFederatedData(**_arrays()), "fedmeta_uga",
                          **common)
    th = train_method(_torch_with_acc(_torch_mlp()),
                      FederatedData(**_arrays()), "fedmeta_uga",
                      device="cpu", params=_params0()[1], **common)
    assert [h["round"] for h in th] == [h["round"] for h in jh] == [3, 5]
    for a, b in zip(th, jh):
        assert abs(a["acc"] - b["acc"]) <= 1e-6, (a, b)
        for k in ("loss", "client_loss"):
            assert abs(a[k] - b[k]) <= TOL_METRIC * abs(b[k]), (k, a, b)
