"""The live roofline event in the port's trainer and launcher
(``FederatedTrainer(roofline=True)``, ``train.py --roofline``) and its
report (``python -m repro_torch.roofline.report``), against the JAX
package's: the event's keys are ``ROOFLINE_EVENT_KEYS``, one event per
distinct K, the report's exit codes are JAX's report's on the same run
directories, and ``obs.regress`` reads the event's peak temp bytes.

The trace changes nothing: a run with ``roofline=True`` is bitwise the
run without it, in parameters, optimizer state and history.  The trainer
runs use the small MLP of ``test_torch_faults.py`` on the CPU (where the
trace covers the kernels' plain versions, so it charges no launch); the
launcher runs smollm-360m-smoke for one round."""
import json
import os

import pytest
import torch

import _torch_parity  # noqa: F401  (one torch thread)
from repro.roofline.report import main as jax_report
from repro_torch.configs import FedConfig
from repro_torch.core.trainer import FederatedTrainer
from repro_torch.data.pipeline import FederatedData
from repro_torch.obs import ROOFLINE_EVENT_KEYS
from repro_torch.obs.regress import summarize_run
from repro_torch.roofline.report import main as port_report
from test_torch_faults import BASE, COHORT, _arrays, _params0, _torch_mlp

RUN = dict(rounds=3, cohort=COHORT, batch=8, meta_batch=8)


def _trainer(run_dir=None, **kw):
    return FederatedTrainer(_torch_mlp(), FedConfig(**BASE), seed=0,
                            device="cpu", params=_params0()[1],
                            rounds_per_call=2, run_dir=run_dir, **kw)


def _events(run_dir, name):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        lines = [json.loads(ln) for ln in f]
    return [{k: v for k, v in ln.items() if k not in ("kind", "event", "t")}
            for ln in lines if ln.get("event") == name]


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The same 3 rounds (a K = 2 call and a K = 1 tail) without and with
    the roofline event."""
    d = str(tmp_path_factory.mktemp("roofline"))
    plain = _trainer()
    hp = plain.run(FederatedData(**_arrays()), **RUN)
    traced = _trainer(d, tracker="jsonl", roofline=True)
    ht = traced.run(FederatedData(**_arrays()), **RUN)
    traced.finish()
    return plain, hp, traced, ht, d


def test_roofline_run_is_bitwise_the_plain_run(runs):
    plain, hp, traced, ht, _ = runs
    assert ht == hp
    a, b = _leaves(plain.state), _leaves(traced.state)
    assert len(a) == len(b) and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        for x, y in zip(a, b))


def test_one_event_per_distinct_k_with_jaxs_keys(runs):
    *_, traced, _, d = runs
    evs = _events(d, "roofline")
    assert [e["rounds_per_call"] for e in evs] == [1, 2]
    for e in evs:
        assert set(e) == set(ROOFLINE_EVENT_KEYS)
        assert e["rounds_measured"] == 3 and e["measured_rounds_per_s"] > 0
        assert e["loop_ratio"] == 1.0 and e["xla_flops"] > 0
        assert e["flops_per_round"] == e["xla_flops"] / e["rounds_per_call"]
        assert e["memory"]["temp_size_in_bytes"] > 0
        assert e["bottleneck"] in ("compute", "memory", "collective")
    # the CPU trace covers the kernels' plain versions: no launch charged
    assert traced.roofline_summaries[2]["launches"] == {}
    assert traced.roofline_summaries[2]["flops"] == \
        2 * traced.roofline_summaries[1]["flops"]


def test_sanitized_round_emits_no_event(tmp_path):
    tr = _trainer(str(tmp_path), tracker="jsonl", roofline=True,
                  sanitize=True)
    tr.run(FederatedData(**_arrays()), **RUN)
    tr.finish()
    assert _events(str(tmp_path), "roofline") == []
    assert _events(str(tmp_path), "run_finish")


def test_report_exits_as_jaxs_does(runs, tmp_path, capsys):
    d = runs[-1]
    empty = tmp_path / "empty"
    empty.mkdir()
    none = tmp_path / "none"
    none.mkdir()
    with open(d + "/metrics.jsonl") as f:
        lines = [ln for ln in f if '"roofline"' not in ln]
    (none / "metrics.jsonl").write_text("".join(lines))
    for run_dir, rc in ((d, 0), (str(none), 1), (str(empty), 2)):
        assert port_report([run_dir]) == rc
        assert jax_report([run_dir]) == rc
    out = capsys.readouterr().out
    assert "H100 SXM hardware model" in out


def test_regress_reads_the_events_temp_bytes(runs):
    d = runs[-1]
    temp = _events(d, "roofline")[-1]["memory"]["temp_size_in_bytes"]
    assert summarize_run(d)["peak_temp_bytes"] == temp


def test_launcher_roofline(tmp_path, capsys):
    from repro_torch.launch.train import main
    d = str(tmp_path / "run")
    main(["--arch", "smollm-360m-smoke", "--fused", "--rounds", "1",
          "--cohort", "2", "--client-batch", "4", "--seq", "32", "--device",
          "cpu", "--tracker", "jsonl", "--run-dir", d, "--roofline"])
    (ev,) = _events(d, "roofline")
    assert set(ev) == set(ROOFLINE_EVENT_KEYS) and ev["flops_per_round"] > 0
    assert port_report([d]) == 0


def test_round_roofline_event_alone(runs):
    """The event the trainer emits, from the function alone: JAX's keys
    less the trainer's measured triple; None for a sanitized round."""
    from repro_torch.core.sanitize import sanitize_round
    from repro_torch.roofline import round_roofline_event
    plain = runs[0]
    fn = plain._cache(1)
    data = FederatedData(**_arrays())
    staged = plain._stage(
        [data.sample_round(0, cohort=COHORT, batch=8, share=False)],
        [data.sample_meta(0, 8)], [None])
    ev = round_roofline_event(fn, (plain.state, *staged), device="cpu")
    assert set(ev) == set(ROOFLINE_EVENT_KEYS) - {
        "measured_rounds_per_s", "measured_s_per_round", "rounds_measured"}
    assert ev["rounds_per_call"] == 1 and ev["flops_per_round"] > 0
    assert round_roofline_event(sanitize_round(fn), (plain.state, *staged),
                                device="cpu") is None
