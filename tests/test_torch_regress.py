"""The regression watch in the port (``repro_torch.obs.regress``, its
``compare`` / ``report`` CLIs and ``python -m repro_torch.obs``) against
the JAX package's: the same summaries, deltas and exit codes on the same
run directories (the synthetic ``metrics.jsonl`` files of
``tests/test_regress.py`` and a real port run) and the same bench files.
The one intended difference: a bench file's ``torch_version`` drift
warns in the port where JAX's warns on ``jax_version``."""
import dataclasses
import json
import os
import subprocess
import sys

import pytest

import repro.core  # noqa: F401  (the JAX package's import order)
from repro.obs import regress as J
from repro.obs.__main__ import main as jax_obs_main
from repro_torch.obs import regress as T
from repro_torch.obs.__main__ import main as obs_main
from test_regress import _write_run

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _same(port, ref):
    """(code, deltas) of both packages, deltas as plain dicts."""
    (pc, pd), (rc, rd) = port, ref
    assert pc == rc
    assert [dataclasses.asdict(d) for d in pd] == \
        [dataclasses.asdict(d) for d in rd]
    return pc


RUNS = {
    "identical": ({}, {}),
    "throughput": (dict(dispatch_s=0.10), dict(dispatch_s=0.30)),
    "loss": (dict(loss0=2.0), dict(loss0=2.2)),
    "memory": (dict(temp_bytes=1000), dict(temp_bytes=1200)),
    "comm_bytes": (dict(comm_bytes=1000), dict(comm_bytes=900)),
    "metric_keys": ({}, dict(extra_key="participants")),
    "rounds": (dict(rounds=4), dict(rounds=5)),
}


@pytest.mark.parametrize("case", sorted(RUNS))
def test_run_dirs_as_in_jax(tmp_path, case):
    a_kw, b_kw = RUNS[case]
    a = _write_run(str(tmp_path / "a"), **a_kw)
    b = _write_run(str(tmp_path / "b"), **b_kw)
    for d in (a, b):
        assert T.summarize_run(d) == J.summarize_run(d)
    code = _same(T.compare_run_dirs(a, b), J.compare_run_dirs(a, b))
    loose = dict(perf_rel=0.95, phase_rel=3.0)
    _same(T.compare_run_dirs(a, b, T.Tolerances(**loose)),
          J.compare_run_dirs(a, b, J.Tolerances(**loose)))
    assert code == {"identical": 0, "metric_keys": 2,
                    "rounds": 2}.get(case, 1)
    assert obs_main(["compare", a, b]) == \
        jax_obs_main(["compare", a, b]) == code


def test_summarize_a_port_run(tmp_path):
    """A run the port's trainer tracked reads the same in both packages."""
    from repro_torch.configs import FedConfig
    from repro_torch.core.trainer import FederatedTrainer
    from repro_torch.data.pipeline import FederatedData
    from test_torch_faults import BASE, COHORT, _arrays, _params0, _torch_mlp
    tr = FederatedTrainer(_torch_mlp(), FedConfig(**BASE), seed=0,
                          device="cpu", params=_params0()[1],
                          tracker="jsonl", run_dir=str(tmp_path))
    tr.run(FederatedData(**_arrays()), rounds=3, cohort=COHORT, batch=8,
           meta_batch=8)
    tr.finish()
    s = T.summarize_run(str(tmp_path))
    assert s == J.summarize_run(str(tmp_path))
    assert s["rounds"] == 3 and s["rounds_per_s"] > 0
    assert set(s["phase_s"]) == {"sample_stack", "dispatch", "device_sync"}
    with pytest.raises(FileNotFoundError, match="tracker"):
        T.summarize_run(str(tmp_path / "none"))


def _bench(path, *, bench="round_latency", config=None, host="h",
           jax_version="0.4.37", torch_version="2.13.0", meta=True,
           body=None):
    rep = {"speedup": 2.0, "rounds_per_s": 10.0, "wall_s": 1.0,
           "comm_bytes": 1000, "pass_numerics": True, "util_pct": 40.0,
           "curve": [1, 2, 3], "note": "x"}
    rep.update(body or {})
    if meta:
        rep["meta"] = {"bench": bench, "config": config or {"fast": True},
                       "host": host, "jax_version": jax_version,
                       "torch_version": torch_version}
    with open(path, "w") as f:
        json.dump(rep, f)
    return str(path)


BENCH = {
    "identical": ({}, {}, 0),
    "name": ({}, dict(bench="other"), 2),
    "config": ({}, dict(config={"fast": False}), 2),
    "host": ({}, dict(host="other"), 0),
    "gate": ({}, dict(body={"pass_numerics": False}), 1),
    "perf": ({}, dict(body={"rounds_per_s": 5.0}), 1),
    "bytes": ({}, dict(body={"comm_bytes": 1100}), 1),
    "pct": ({}, dict(body={"util_pct": 60.0}), 1),
    "schema": ({}, dict(body={"curve": [1, 2]}), 2),
    "missing_meta": ({}, dict(meta=False), 0),
}


@pytest.mark.parametrize("case", sorted(BENCH))
def test_bench_files_as_in_jax(tmp_path, case):
    a_kw, b_kw, want = BENCH[case]
    a = _bench(tmp_path / "a.json", **a_kw)
    b = _bench(tmp_path / "b.json", **b_kw)
    assert _same(T.compare_bench_files(a, b), J.compare_bench_files(a, b)) \
        == want
    assert obs_main(["compare", a, b]) == jax_obs_main(["compare", a, b])
    if case == "config":
        assert _same(T.compare_bench_files(a, b, ignore_config=["fast"]),
                     J.compare_bench_files(a, b, ignore_config=["fast"])) \
            == 0


def test_bench_version_drift_warns_on_the_own_framework(tmp_path):
    a = _bench(tmp_path / "a.json")
    b = _bench(tmp_path / "b.json", jax_version="0.5.0")
    c = _bench(tmp_path / "c.json", torch_version="2.14.0")
    for x, pkg, name in ((b, J, "meta.jax_version"),
                         (c, T, "meta.torch_version")):
        code, deltas = pkg.compare_bench_files(a, x)
        assert code == 0
        assert [(d.name, d.status) for d in deltas] == [(name, "warn")]
    assert T.compare_bench_files(a, b) == (0, [])
    assert J.compare_bench_files(a, c) == (0, [])


def test_obs_cli_exit_codes_as_in_jax(tmp_path, capsys):
    a = _write_run(str(tmp_path / "a"))
    f = _bench(tmp_path / "b.json")
    for argv in (["report", a], ["report", a, "--json"],
                 ["report", str(tmp_path / "none")], ["compare", a, f],
                 [], ["-h"], ["nope"]):
        assert obs_main(argv) == jax_obs_main(argv), argv
    out = capsys.readouterr().out
    assert "run report" in out
    # the module entry point, as a user runs it
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src")}
    proc = subprocess.run([sys.executable, "-m", "repro_torch.obs",
                           "report", a], capture_output=True, text=True,
                          env=env)
    assert proc.returncode == 0, proc.stderr
    assert "rounds_per_s" in proc.stdout
    # the stdlib part imports neither jax nor torch (the profiler loads
    # on first use)
    proc = subprocess.run(
        [sys.executable, "-c", "import sys, repro_torch.obs; "
         "print(sorted({'jax', 'torch', 'repro'} & set(sys.modules)))"],
        capture_output=True, text=True, env=env)
    assert proc.stdout.strip() == "[]", proc.stdout + proc.stderr
