"""Observability in the port (``repro_torch.obs``) against the JAX
package's (``repro.obs``): the tracker registry and its error messages,
the file trackers, spans, the trainer's event stream, the per-call
override, ``CheckpointManager(background=False)``, the refusals, and
``round_metric_keys`` over a grid of configs.

Mirrors ``tests/test_obs.py``.  The trainer runs use the small MLP of
``test_torch_faults.py`` (parameters from the JAX init), one JAX trainer
compile in a module-scoped fixture.  The port's and JAX's ``metrics.jsonl``
hold the same sequence of kinds, events and phase names, and metrics
within 1e-4 (the JAX suite's across engines)."""
import dataclasses
import itertools
import json
import os
import sys

import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (the JAX package's import order)
from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.configs import FedConfig as JaxFedConfig
from repro.core import FederatedTrainer as JaxTrainer
from repro.data.pipeline import FederatedData as JaxFederatedData
from repro.obs import get_tracker as jax_get_tracker
from repro.obs import resolve_tracker as jax_resolve_tracker
from repro.obs import round_metric_keys as jax_round_metric_keys
from repro_torch.checkpoint import CheckpointManager
from repro_torch.comm.codecs import available_codecs
from repro_torch.configs import FedConfig
from repro_torch.core.trainer import FederatedTrainer
from repro_torch.data.pipeline import FederatedData
from repro_torch.obs import (CompositeTracker, MetricsTracker, NoopTracker,
                             available_trackers, get_tracker,
                             register_tracker, resolve_tracker,
                             round_metric_keys, span)
from repro_torch.sim.faults import FAULT_PROFILES
from test_torch_faults import (BASE, COHORT, _arrays, _jax_mlp, _params0,
                               _torch_mlp)

TOL_METRIC = 1e-4
RUN = dict(rounds=4, cohort=COHORT, batch=8, meta_batch=8)
PROFILED = dict(profile=1, profile_start=2, trace_summary=True)


def read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _port_trainer(**kw):
    return FederatedTrainer(_torch_mlp(), FedConfig(**BASE), seed=0,
                            device="cpu", params=_params0()[1], **kw)


def _leaves(state):
    out = []
    for k in sorted(state):
        v = state[k]
        if isinstance(v, dict):
            out += _leaves(v)
        elif isinstance(v, (tuple, list)):
            out += list(v)
        else:
            out.append(v)
    return out


def _bitwise(a, b):
    return len(a) == len(b) and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# registry + resolution
# ---------------------------------------------------------------------------
BUILTIN = {"noop", "console", "jsonl", "csv", "composite", "tensorboard"}


def test_builtin_trackers_registered_as_in_jax():
    # other tests in the process may have registered plugins in either
    from repro.obs import available_trackers as jax_available
    assert BUILTIN <= set(available_trackers())
    assert BUILTIN <= set(jax_available())


def test_unknown_tracker_is_actionable():
    from repro.obs import available_trackers as jax_available
    with pytest.raises(ValueError, match="metrics tracker.*jsonl") as port:
        get_tracker("wandb")
    with pytest.raises(ValueError) as ref:
        jax_get_tracker("wandb")

    def message(names, pkg):
        return (f"unknown metrics tracker 'wandb'; registered: {names} "
                f"(register new ones with {pkg}.obs.register_tracker)")
    assert str(port.value) == message(available_trackers(), "repro_torch")
    assert str(ref.value) == message(jax_available(), "repro")


def test_register_tracker_plugin_and_resolution(tmp_path):
    seen = []

    @register_tracker("torch_obs_test_memory")
    class MemoryTracker(MetricsTracker):
        name = "torch_obs_test_memory"

        def __init__(self, run_dir=None):
            pass

        def log_metrics(self, r, m):
            seen.append((r, m))

        def log_event(self, name, data=None):
            pass

        def finish(self):
            pass

    t = resolve_tracker("torch_obs_test_memory")
    t.log_metrics(0, {"x": 1.0})
    assert seen == [(0, {"x": 1.0})]
    combo = resolve_tracker("torch_obs_test_memory,noop",
                            run_dir=str(tmp_path))
    assert isinstance(combo, CompositeTracker)
    assert resolve_tracker(t) is t
    assert isinstance(resolve_tracker(None), NoopTracker)
    owned = []
    resolve_tracker("torch_obs_test_memory,noop", owned=owned)
    assert len(owned) == 2
    with pytest.raises(ValueError, match="already registered"):
        register_tracker("torch_obs_test_memory")(MemoryTracker)
    with pytest.raises(ValueError, match="cannot resolve"):
        resolve_tracker(3)


@pytest.mark.parametrize("name", ["jsonl", "csv"])
def test_file_tracker_requires_run_dir_as_in_jax(name):
    with pytest.raises(ValueError, match="run ") as port:
        resolve_tracker(name)
    with pytest.raises(ValueError) as ref:
        jax_resolve_tracker(name)
    assert str(port.value) == str(ref.value)


# ---------------------------------------------------------------------------
# jsonl / csv / console / span behavior
# ---------------------------------------------------------------------------
def test_jsonl_records_events_and_span(tmp_path):
    t = resolve_tracker("jsonl", run_dir=str(tmp_path))
    t.log_metrics(0, {"round": 0, "client_loss": 1.5,
                      "staleness_hist": [1.0, 2.0]})
    with span(t, "dispatch", round=0) as info:
        info["extra"] = 7
    assert info["dur_s"] >= 0
    t.finish()
    lines = read_jsonl(tmp_path / "metrics.jsonl")
    assert lines[0] == {"kind": "metrics", "round": 0, "client_loss": 1.5,
                        "staleness_hist": [1.0, 2.0]}
    ev = lines[1]
    assert ev["kind"] == "event" and ev["event"] == "phase"
    assert ev["phase"] == "dispatch" and ev["round"] == 0
    assert ev["extra"] == 7 and ev["dur_s"] == info["dur_s"]
    assert isinstance(ev["t"], float)
    with pytest.raises(RuntimeError, match="finish"):
        t.log_metrics(1, {"x": 1.0})
    t.finish()  # idempotent


def test_csv_header_pinned_to_first_record(tmp_path):
    t = resolve_tracker("csv", run_dir=str(tmp_path))
    t.log_metrics(0, {"round": 0, "b": 1.0, "a": 2.0,
                      "staleness_hist": [1.0, 0.0]})
    t.log_metrics(1, {"round": 1, "b": 3.0, "a": 4.0,
                      "staleness_hist": [0.0, 2.0]})
    with pytest.raises(ValueError, match="pinned"):
        t.log_metrics(2, {"round": 2, "b": 1.0, "c": 9.0})
    t.log_event("run_finish", {})
    t.finish()
    rows = (tmp_path / "metrics.csv").read_text().strip().splitlines()
    assert rows[0] == "round,a,b,staleness_hist"
    assert rows[1] == '0,2.0,1.0,"[1.0, 0.0]"'
    assert (tmp_path / "events.csv").exists()


def test_csv_tracker_appends_across_resume(tmp_path):
    t = resolve_tracker("csv", run_dir=str(tmp_path))
    t.log_metrics(0, {"round": 0, "a": 1.0})
    t.log_event("run_finish", {})
    t.finish()
    t2 = resolve_tracker("csv", run_dir=str(tmp_path))
    t2.log_metrics(1, {"round": 1, "a": 2.0})
    with pytest.raises(ValueError, match="pinned"):
        t2.log_metrics(2, {"round": 2, "b": 3.0})
    t2.log_event("run_finish", {})
    t2.finish()
    rows = (tmp_path / "metrics.csv").read_text().strip().splitlines()
    assert rows == ["round,a", "0,1.0", "1,2.0"]
    erows = (tmp_path / "events.csv").read_text().strip().splitlines()
    assert erows[0] == "t,event,data" and len(erows) == 3


def test_console_tracker_prints_every_and_final():
    lines = []
    t = get_tracker("console")(every=3, log_fn=lines.append)
    t.log_event("run_start", {"final_round": 4})
    for r in range(5):
        t.log_metrics(r, {"round": r, "client_loss": float(r),
                          "staleness_hist": [1.0]})
    # every 3 rounds (0, 3) and the final round (4); floats only
    assert [ln.split()[2] for ln in lines] == ["0", "3", "4"]
    assert "client_loss=3.0000" in lines[1]
    assert "staleness_hist" not in lines[1]


def test_tensorboard_tracker_registered_and_gated(tmp_path, monkeypatch):
    """'tensorboard' is always listed; with a backend it writes event
    files, and with neither backend importable it raises the ImportError
    that names the install."""
    assert "tensorboard" in available_trackers()
    factory = get_tracker("tensorboard")
    try:
        from torch.utils.tensorboard import SummaryWriter  # noqa: F401
        have_backend = True
    except ImportError:
        have_backend = False
    if have_backend:
        t = factory(run_dir=str(tmp_path))
        t.log_metrics(0, {"round": 0, "client_loss": 1.5,
                          "staleness_hist": [1.0, 2.0, 3.0]})
        with span(t, "dispatch", round=0):
            pass
        t.finish()
        t.finish()
        tb = os.path.join(str(tmp_path), "tb")
        assert any("tfevents" in f for f in os.listdir(tb))
        with pytest.raises(RuntimeError, match="finish"):
            t.log_metrics(1, {"round": 1})
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    with pytest.raises(ImportError, match="tensorboardX"):
        factory(run_dir=str(tmp_path))


# ---------------------------------------------------------------------------
# trainer wiring, against the JAX trainer
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_tracked(tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_run")
    jt = JaxTrainer(_jax_mlp(), JaxFedConfig(**BASE), rounds_per_call=2,
                    seed=0, tracker="jsonl", run_dir=str(d), **PROFILED)
    jt.state["params"] = _params0()[0]
    jh = jt.run(JaxFederatedData(**_arrays()), **RUN)
    jt.finish()
    return read_jsonl(d / "metrics.jsonl"), jh


def _shape(lines):
    """(kind, event, phase) of every line, in order."""
    return [(ln["kind"], ln.get("event"), ln.get("phase")) for ln in lines]


def test_trainer_jsonl_matches_jax(jax_tracked, tmp_path):
    jlines, jh = jax_tracked
    tt = _port_trainer(rounds_per_call=2, tracker="jsonl",
                       run_dir=str(tmp_path), **PROFILED)
    th = tt.run(FederatedData(**_arrays()), **RUN)
    tt.finish()
    lines = read_jsonl(tmp_path / "metrics.jsonl")
    assert _shape(lines) == _shape(jlines)
    assert _shape(lines)[0] == ("event", "run_start", None)
    assert _shape(lines)[-1] == ("event", "run_finish", None)
    for a, b in zip(lines, jlines):
        assert set(a) == set(b), (a, b)
        if a["kind"] == "event" and a["event"] in ("run_start",
                                                   "run_finish"):
            assert {k: v for k, v in a.items() if k != "t"} == \
                {k: v for k, v in b.items() if k != "t"}
        if a.get("event") == "phase":
            assert (a["round"], a.get("k")) == (b["round"], b.get("k"))
    recs = [ln for ln in lines if ln["kind"] == "metrics"]
    jrecs = [ln for ln in jlines if ln["kind"] == "metrics"]
    assert [r["round"] for r in recs] == [0, 1, 2, 3]
    for a, b in zip(recs, jrecs):
        for k in set(b) - {"kind", "round"}:
            assert abs(a[k] - b[k]) <= TOL_METRIC * max(abs(b[k]), 1e-30), \
                (k, a[k], b[k])
    # the jsonl record is the returned history record
    assert [{k: v for k, v in r.items() if k != "kind"} for r in recs] == th
    assert len(th) == len(jh)


def test_noop_tracked_run_bitwise_untracked():
    a = _port_trainer(rounds_per_call=2)
    b = _port_trainer(rounds_per_call=2, tracker="noop")
    ha = a.run(FederatedData(**_arrays()), **RUN)
    hb = b.run(FederatedData(**_arrays()), **RUN)
    assert _bitwise(_leaves(a.state), _leaves(b.state)) and ha == hb


def test_run_finishes_per_call_tracker_override(tmp_path):
    """A tracker the call resolves is finished when ``run`` returns; an
    instance the caller passes stays open across calls."""
    tr = _port_trainer(run_dir=str(tmp_path))
    kw = dict(cohort=COHORT, batch=8, meta_batch=8)
    tr.run(FederatedData(**_arrays()), rounds=2, tracker="csv", **kw)
    rows = (tmp_path / "metrics.csv").read_text().strip().splitlines()
    assert len(rows) == 3
    shared = resolve_tracker("jsonl", run_dir=str(tmp_path))
    tr.run(FederatedData(**_arrays()), rounds=4, tracker=shared, **kw)
    tr.run(FederatedData(**_arrays()), rounds=6, tracker=shared, **kw)
    shared.finish()
    recs = [ln for ln in read_jsonl(tmp_path / "metrics.jsonl")
            if ln["kind"] == "metrics"]
    assert [m["round"] for m in recs] == [2, 3, 4, 5]
    tr.finish()


def test_profiler_opens_on_chunk_overlapping_window(tmp_path):
    from repro_torch.obs.profiler import RoundProfiler
    events = []

    class Rec(MetricsTracker):
        def log_metrics(self, r, m):
            pass

        def log_event(self, name, data=None):
            events.append((name, data["round"]))

        def finish(self):
            pass

    p = RoundProfiler(str(tmp_path), start=5, rounds=1, tracker=Rec())
    # chunks of k=4: [0,4) misses the window, [4,8) contains round 5
    assert not p.maybe_start(0, 4)
    p.maybe_stop(4)
    assert p.maybe_start(4, 4) and p.active
    p.maybe_stop(8)
    assert not p.active and os.path.isfile(p.trace_path)
    assert events == [("profile_start", 4), ("profile_stop", 7)]
    assert not p.maybe_start(8, 4)       # one window a run


def test_profile_without_run_dir_and_roofline_are_actionable(tmp_path):
    with pytest.raises(ValueError, match="run "):
        _port_trainer(profile=2)
    # the roofline trace follows a round under participation or faults:
    # its all-failed test reads the host weights, not a device value
    fed = FedConfig(**{**BASE, "participation": 0.75})
    assert FederatedTrainer(_torch_mlp(), fed, device="cpu",
                            params=_params0()[1], roofline=True)._roofline
    from repro_torch.launch.train import main
    d = str(tmp_path / "run")
    main(["--arch", "smollm-360m-smoke", "--rounds", "1", "--cohort", "2",
          "--client-batch", "4", "--seq", "32", "--device", "cpu",
          "--tracker", "jsonl", "--run-dir", d, "--roofline",
          "--participation", "0.75"])
    with open(os.path.join(d, "metrics.jsonl")) as f:
        assert sum(json.loads(ln).get("event") == "roofline"
                   for ln in f) == 1


# ---------------------------------------------------------------------------
# the managed store's synchronous mode (tests/test_obs.py:469-491)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_manager_prune_manifest_lands_before_unlink(tmp_path, monkeypatch,
                                                    pkg):
    cls = CheckpointManager if pkg == "port" else JaxCheckpointManager
    m = cls(str(tmp_path), keep_last=1, background=False)
    m.save(1, {"a": np.zeros((2,))})
    assert m.saved_steps() == [1]        # on disk when save returns
    unlinked = []
    real_remove = os.remove

    def spy_remove(path, *a, **kw):
        name = os.path.basename(str(path))
        if name.startswith("step_"):
            step = int(name[5:13])
            assert step not in m.saved_steps()
            unlinked.append(step)
        return real_remove(path, *a, **kw)

    monkeypatch.setattr(os, "remove", spy_remove)
    m.save(2, {"a": np.zeros((2,))})
    assert unlinked == [1]
    assert m.saved_steps() == [2]
    m.close()


# ---------------------------------------------------------------------------
# round_metric_keys against JAX's over a grid of configs
# ---------------------------------------------------------------------------
def _grid(engine, meta):
    for part, profile, deadline, codec, retry, stale in itertools.product(
            (1.0, 0.75), sorted(FAULT_PROFILES), (0.0, 3.0),
            available_codecs(), (0, 1), (0, 2)):
        kw = dict(cohort=4, participation=part, fault_profile=profile,
                  round_deadline=deadline, codec=codec, retry_backoff=retry,
                  meta=meta != "off", **engine)
        if meta == "through_aggregation":
            kw["meta_mode"] = meta
        if engine.get("engine") == "buffered_async":
            kw["async_max_staleness"] = stale
        elif stale:
            continue
        yield kw


ENGINES = {"fused": dict(fused_update=True),
           "legacy": dict(fused_update=False),
           "async": dict(fused_update=True, engine="buffered_async")}


@pytest.mark.parametrize("meta", ["off", "post", "through_aggregation"])
@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_round_metric_keys_match_jax(engine, meta):
    n = 0
    for kw in _grid(ENGINES[engine], meta):
        try:
            jfed = JaxFedConfig(**kw)
        except ValueError:
            with pytest.raises(ValueError):
                FedConfig(**kw)
            continue
        fed = FedConfig(**kw)
        for trainer in (True, False):
            assert round_metric_keys(fed, trainer=trainer) == \
                jax_round_metric_keys(jfed, trainer=trainer), kw
        n += 1
    assert n > 0 or (engine, meta) in {("legacy", "through_aggregation"),
                                       ("async", "through_aggregation")}


def test_round_metric_keys_pin_live_records(tmp_path):
    """The csv header a real run pins is the schema's key set (an async
    run under faults, with its vector metric)."""
    fed = dataclasses.replace(
        FedConfig(**BASE), engine="buffered_async", participation=0.75,
        fault_profile="flaky", async_max_staleness=2)
    tr = FederatedTrainer(_torch_mlp(), fed, seed=0, device="cpu",
                          params=_params0()[1], tracker="csv,jsonl",
                          run_dir=str(tmp_path))
    hist = tr.run(FederatedData(**_arrays()), rounds=2, cohort=COHORT,
                  batch=8, meta_batch=8)
    tr.finish()
    header = (tmp_path / "metrics.csv").read_text().splitlines()[0]
    assert set(header.split(",")) == set(round_metric_keys(fed)) \
        == set(hist[0])
    assert isinstance(hist[0]["staleness_hist"], list)
