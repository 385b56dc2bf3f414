"""Trace analytics in the port (``repro_torch.obs.trace_analysis``):
the same outputs as the JAX package's functions on the synthetic traces
of ``tests/test_trace_analysis.py`` (the hand-computed fixture
``tests/fixtures/mini_trace.json.gz`` and the inline ones), the
``torch.profiler`` Chrome-trace categories on a hand-computed miniature,
and a real CPU ``torch.profiler`` window through the trainer.

Torch miniature (all times us): host lane (pid 1 / tid 10) with the
``user_annotation`` ranges repro.phase.dispatch [100, 300) and
repro.phase.device_sync [300, 400) and a ``cpu_op`` aten::mm [110, 290);
device lane (pid 2 / tid 7) with ``kernel`` k1 [150, 250), ``gpu_memcpy``
[320, 340), ``kernel`` k2 [390, 420), and the annotation's device twin
(``gpu_user_annotation`` repro.phase.dispatch [150, 250)).  Ops: k1,
memcpy, k2 (selfs 100, 20, 30; busy 150 over a wall of 270); phases:
dispatch 100, device_sync 20 + 10, _unattributed 20.
"""
import gzip
import json
import os

import pytest

import repro.core  # noqa: F401  (the JAX package's import order)
from repro.obs import trace_analysis as J
from repro_torch.configs import FedConfig
from repro_torch.core.trainer import FederatedTrainer
from repro_torch.data.pipeline import FederatedData
from repro_torch.obs import PROFILE_SUMMARY_EVENT_KEYS
from repro_torch.obs import trace_analysis as T
from test_torch_faults import BASE, COHORT, _arrays, _params0, _torch_mlp

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "mini_trace.json.gz")

INLINE = [
    {"traceEvents": []},
    {"traceEvents": [{"pid": 1, "tid": 1, "ts": 0, "dur": 100, "name": "a",
                      "ph": "X", "args": {"hlo_op": "a"}},
                     {"pid": 1, "tid": 2, "ts": 10, "dur": 50, "name": "b",
                      "ph": "X", "args": {"hlo_op": "b"}}]},
    # XLA backends that tag nothing: ops on a device-named process
    {"traceEvents": [
        {"ph": "M", "name": "process_name", "pid": 9,
         "args": {"name": "/device:CPU:0"}},
        {"ph": "X", "pid": 9, "tid": 1, "ts": 5, "dur": 10, "name": "x"},
        {"ph": "X", "pid": 9, "tid": 1, "ts": 6, "dur": 2, "name": "y"},
        {"ph": "X", "pid": 3, "tid": 1, "ts": 0, "dur": 30,
         "name": "repro.phase.dispatch"}]},
]


def _torch_mini():
    def x(name, cat, pid, tid, ts, dur):
        return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid,
                "ts": ts, "dur": dur, "args": {}}
    return {"traceEvents": [
        {"ph": "M", "name": "process_name", "pid": 1,
         "args": {"name": "python"}},
        x("repro.phase.dispatch", "user_annotation", 1, 10, 100, 200),
        x("repro.phase.device_sync", "user_annotation", 1, 10, 300, 100),
        x("aten::mm", "cpu_op", 1, 10, 110, 180),
        x("k1", "kernel", 2, 7, 150, 100),
        x("Memcpy HtoD", "gpu_memcpy", 2, 7, 320, 20),
        x("k2", "kernel", 2, 7, 390, 30),
        x("repro.phase.dispatch", "gpu_user_annotation", 2, 7, 150, 100),
        {"ph": "i", "name": "marker", "pid": 1, "tid": 10, "ts": 0}]}


def _traces():
    return [J.load_trace(FIXTURE), *INLINE]


# ---------------------------------------------------------------------------
# the JAX package's outputs on its own fixtures
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("i", range(1 + len(INLINE)))
def test_functions_equal_jax_on_its_traces(i):
    trace = _traces()[i]
    assert T.op_events(trace) == J.op_events(trace)
    assert T.phase_windows(trace) == J.phase_windows(trace)
    ops = J.op_events(trace)
    assert T.self_times(ops) == J.self_times(ops)
    assert T.interval_union_us(ops) == J.interval_union_us(ops)
    for k in (1, 2, 15):
        assert T.summarize(trace, top_k=k) == J.summarize(trace, top_k=k)


def test_fixture_numbers_and_trace_file(tmp_path):
    s = T.summarize_trace(FIXTURE)
    assert s == J.summarize_trace(FIXTURE)
    assert set(s) == set(PROFILE_SUMMARY_EVENT_KEYS)
    assert (s["busy_us"], s["wall_us"], s["gap_us"]) == (190.0, 420.0, 230.0)
    assert s["phase_self_us"] == {"_unattributed": 40.0,
                                  "device_sync": 50.0, "dispatch": 100.0}
    assert T.load_trace(FIXTURE) == J.load_trace(FIXTURE)
    assert T.find_trace_file(FIXTURE) == J.find_trace_file(FIXTURE)
    d = tmp_path / "profile" / "plugins" / "profile" / "2026_08_08"
    d.mkdir(parents=True)
    old, new = d / "a.trace.json", d / "b.trace.json.gz"
    torch_file = tmp_path / "profile" / "round_1.pt.trace.json"
    for p in (old, torch_file):
        p.write_text(json.dumps({"traceEvents": []}))
    with gzip.open(new, "wt") as f:
        f.write(json.dumps({"traceEvents": []}))
    os.utime(old, (1, 1))
    os.utime(torch_file, (2, 2))
    assert T.find_trace_file(str(tmp_path)) == \
        J.find_trace_file(str(tmp_path)) == str(new)
    os.utime(torch_file, None)
    assert T.find_trace_file(str(tmp_path)) == str(torch_file)
    assert T.find_trace_file(str(tmp_path / "empty")) is None \
        is J.find_trace_file(str(tmp_path / "empty"))


class _Recorder:
    def __init__(self):
        self.events = []

    def log_event(self, name, data):
        self.events.append((name, dict(data)))


def test_emit_profile_summary_equals_jax(tmp_path):
    a, b = _Recorder(), _Recorder()
    assert T.emit_profile_summary(a, str(tmp_path)) is None \
        is J.emit_profile_summary(b, str(tmp_path))
    assert T.emit_profile_summary(a, FIXTURE, top_k=3) == \
        J.emit_profile_summary(b, FIXTURE, top_k=3)
    assert a.events == b.events and len(a.events) == 1
    json.dumps(a.events[0][1])


# ---------------------------------------------------------------------------
# torch.profiler's categories
# ---------------------------------------------------------------------------
def test_torch_trace_takes_the_device_stream():
    trace = _torch_mini()
    assert [e["name"] for e in T.op_events(trace)] == \
        ["k1", "Memcpy HtoD", "k2"]
    # the device twin of the dispatch range is not a second window
    assert T.phase_windows(trace) == [("dispatch", 100.0, 300.0),
                                      ("device_sync", 300.0, 400.0)]
    s = T.summarize(trace)
    assert (s["n_events"], s["n_op_events"], s["n_ops"]) == (7, 3, 3)
    assert (s["wall_us"], s["busy_us"], s["gap_us"]) == (270.0, 150.0, 120.0)
    assert s["busy_frac"] == round(150.0 / 270.0, 6)
    assert s["phase_self_us"] == {"_unattributed": 20.0,
                                  "device_sync": 30.0, "dispatch": 100.0}
    assert [o["op"] for o in s["top_ops"]] == ["k1", "k2", "Memcpy HtoD"]


def test_cpu_only_trace_falls_back_to_host_ops():
    trace = _torch_mini()
    trace["traceEvents"] = [e for e in trace["traceEvents"]
                            if e.get("pid") != 2]
    assert [e["name"] for e in T.op_events(trace)] == ["aten::mm"]
    s = T.summarize(trace)
    assert s["phase_self_us"] == {"dispatch": 180.0}


# ---------------------------------------------------------------------------
# a real torch.profiler window through the trainer, on the CPU
# ---------------------------------------------------------------------------
def _events(run_dir, name):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f)
                if r.get("kind") == "event" and r.get("event") == name]


def test_trainer_profile_window_and_summary(tmp_path):
    tr = FederatedTrainer(_torch_mlp(), FedConfig(**BASE),
                          rounds_per_call=2, seed=0, device="cpu",
                          params=_params0()[1], tracker="jsonl",
                          run_dir=str(tmp_path), profile=1, profile_start=1,
                          trace_summary=True, trace_top_k=5)
    tr.run(FederatedData(**_arrays()), rounds=4, cohort=COHORT, batch=8,
           meta_batch=8)
    tr.finish()
    # round 1 lies in the first chunk [0, 2): the window opens on it
    (start,), (stop,) = (_events(tmp_path, "profile_start"),
                         _events(tmp_path, "profile_stop"))
    assert (start["round"], stop["round"]) == (0, 1)
    path = T.find_trace_file(str(tmp_path))
    assert path == os.path.join(str(tmp_path), "profile",
                                "round_0.pt.trace.json")
    (ev,) = _events(tmp_path, "profile_summary")
    payload = {k: v for k, v in ev.items() if k not in ("kind", "event",
                                                        "t")}
    assert set(payload) == set(PROFILE_SUMMARY_EVENT_KEYS)
    assert payload["trace"] == path and payload["top_k"] == 5
    assert payload["n_op_events"] > 0 and 0 < payload["busy_frac"] <= 1
    assert len(payload["top_ops"]) == 5
    assert any(o["op"].startswith("aten::") for o in payload["top_ops"])
    # both phases are annotated; on the CPU the ops run in dispatch
    phases = {w[0] for w in T.phase_windows(T.load_trace(path))}
    assert phases == {"dispatch", "device_sync"}
    assert payload["phase_self_us"]["dispatch"] > 0
    assert payload == {**T.summarize_trace(path, top_k=5)}


def test_trace_summary_and_profile_errors():
    def make(**kw):
        return FederatedTrainer(_torch_mlp(), FedConfig(**BASE), seed=0,
                                device="cpu", params=_params0()[1], **kw)
    with pytest.raises(ValueError, match="profile") as e:
        make(trace_summary=True)
    assert "pass profile=N" in str(e.value)
    with pytest.raises(ValueError, match="needs a run directory"):
        make(profile=1, trace_summary=True)


def test_cli_profile_window_and_report(tmp_path):
    """The launcher's flags end to end at smoke size: the trackers, a
    profiled round summarized with a table of ``--trace-top-k`` rows, and
    ``python -m repro_torch.obs report`` over the run directory."""
    from repro_torch.launch.train import main
    from repro_torch.obs.__main__ import main as obs_main
    d = str(tmp_path / "r")
    main(["--arch", "smollm-360m-smoke", "--rounds", "2", "--cohort", "2",
          "--client-batch", "4", "--seq", "16", "--device", "cpu",
          "--fused", "--log-every", "0", "--tracker", "jsonl,csv",
          "--run-dir", d, "--profile", "1", "--profile-start", "1",
          "--trace-summary", "--trace-top-k", "3"])
    (ev,) = _events(d, "profile_summary")
    assert ev["top_k"] == 3 and len(ev["top_ops"]) == 3
    assert ev["trace"] == os.path.join(d, "profile", "round_1.pt.trace.json")
    assert os.path.isfile(os.path.join(d, "metrics.csv"))
    assert obs_main(["report", d]) == 0
