"""The compressed uplink in the port's round and trainer at smoke size:
``codec='none'`` is the codec-free round, the CLI runs the coded uplink,
and the port's config and round guards refuse what JAX's refuse.

The 3-round trainer parity against the JAX package under the flip-aware
criterion is ``test_torch_comm_rounds.py`` and
``test_torch_comm_rounds_sign_topk.py``, in files of their own so that a
parallel run (``-n N --dist loadfile``) puts them on separate workers.
"""
import json

import numpy as np
import pytest
import torch

from _torch_parity import SMOKE
from repro.configs import FedConfig as JaxFedConfig
from repro_torch.configs import FedConfig, get_arch
from repro_torch.core import executors as TE
from repro_torch.core.round import init_server_state, make_federated_round
from repro_torch.core.trainer import FederatedTrainer
from repro_torch.launch.train import build_synthetic_fed_data, main
from repro_torch.models.model import build_model

ROUNDS, COHORT, BATCH, SEQ = 3, 2, 4, 32
DATA_KW = dict(num_clients=8, examples=64, seq=SEQ, iid=False, seed=0)
RUN_KW = dict(rounds=ROUNDS, cohort=COHORT, batch=BATCH,
              meta_batch=2 * BATCH)


def _fed_kw(strategy, opt, codec, ef, **kw):
    return dict(algorithm="uga", meta=True, cohort=COHORT, local_steps=2,
                client_lr=0.01, server_lr=0.01, meta_lr=0.01,
                server_opt=opt, cohort_strategy=strategy, lr_decay=0.992,
                fused_update=True, codec=codec, error_feedback=ef, **kw)


@pytest.mark.parametrize("strategy", ["vmap", "scan"])
def test_codec_none_is_the_codec_free_round(strategy, monkeypatch):
    """codec='none' never enters the codec stage: no comm state, no
    comm_bytes, and the parameters bitwise those of the default round."""
    def refuse(*a, **k):
        raise AssertionError("codec='none' ran the coded path")
    for cls in (TE.VmapExecutor, TE.ScanExecutor):
        monkeypatch.setattr(cls, "run_coded", refuse)
    tm = build_model(get_arch(SMOKE), loss_chunk=256)
    p0 = tm.init(torch.Generator().manual_seed(0))
    data = build_synthetic_fed_data(get_arch(SMOKE), **DATA_KW)
    base = _fed_kw(strategy, "sgd", "none", False)
    del base["codec"], base["error_feedback"]
    out = []
    for kw in (dict(codec="none", error_feedback=False), {}):
        tr = FederatedTrainer(tm, FedConfig(**base, **kw), device="cpu",
                              params=p0)
        assert "comm" not in tr.state
        hist = tr.run(data, rounds=2, cohort=COHORT, batch=BATCH,
                      meta_batch=2 * BATCH)
        assert all("comm_bytes" not in r for r in hist)
        out.append((tr.state["params"], hist))
    (pa, ha), (pb, hb) = out
    assert ha == hb
    assert all(torch.equal(pa[k], pb[k]) for k in pb)


@pytest.mark.parametrize("strategy", ["vmap", "scan"])
@pytest.mark.parametrize("codec", ["int8", "sign1bit"])
def test_cli_runs_the_coded_uplink_on_cpu(tmp_path, strategy, codec):
    out = tmp_path / "hist.json"
    main(["--arch", SMOKE, "--fused", "--meta", "--codec", codec,
          "--error-feedback", "--rounds", "3", "--cohort", "2",
          "--client-batch", "4", "--seq", "32", "--device", "cpu",
          "--strategy", strategy, "--log-every", "0", "--history-out",
          str(out)])
    hist = json.loads(out.read_text())
    assert [r["round"] for r in hist] == [0, 1, 2]
    for rec in hist:
        assert rec["comm_bytes"] > 0
        assert all(np.isfinite(v) for v in rec.values())


@pytest.mark.parametrize("kw,match", [
    (dict(codec="nope"), "unknown gradient codec"),
    (dict(error_feedback=True), "no compression residual"),
    (dict(codec="topk", topk_ratio=0.0), "topk_ratio"),
    (dict(codec="topk", topk_ratio=1.5), "topk_ratio"),
    (dict(codec="int8", meta_mode="through_aggregation"),
     "through_aggregation"),
    (dict(codec="sign1bit", error_feedback=True,
          meta_mode="through_aggregation"), "through_aggregation"),
], ids=["unknown", "ef-lossless", "ratio-0", "ratio-big", "int8-through",
        "sign1bit-ef-through"])
def test_config_guards_raise_as_jax(kw, match):
    for cls in (FedConfig, JaxFedConfig):
        with pytest.raises(ValueError, match=match):
            cls(fused_update=True, **kw)


def test_through_aggregation_cli_refuses_a_lossy_codec():
    with pytest.raises(ValueError, match="through_aggregation"):
        main(["--arch", SMOKE, "--fused", "--codec", "int8", "--meta-mode",
              "through_aggregation", "--rounds", "1", "--device", "cpu"])


@TE.register_executor("test_no_lossy")
class _NoLossy(TE.VmapExecutor):
    name = "test_no_lossy"
    codec_capabilities = frozenset({"none"})


def test_round_guards_refuse_what_the_resolved_plugins_lack():
    """The round re-checks the codec against the RESOLVED executor and mode
    (a config that went round __post_init__), as JAX's round does."""
    tm = build_model(get_arch(SMOKE))
    fed = FedConfig(**_fed_kw("vmap", "sgd", "int8", False))
    object.__setattr__(fed, "cohort_strategy", "test_no_lossy")
    with pytest.raises(ValueError, match="cohort executor declaring"):
        make_federated_round(tm, fed)
    fed = FedConfig(**_fed_kw("vmap", "sgd", "int8", False))
    object.__setattr__(fed, "meta_mode", "through_aggregation")
    with pytest.raises(ValueError, match="non-differentiable"):
        make_federated_round(tm, fed)
    with pytest.raises(NotImplementedError, match="lossy"):
        TE.CohortExecutor().run_coded(None, {}, {}, torch.ones(2), 0.1,
                                      codec=None, comm=None)


def test_init_server_state_adds_comm_only_for_lossy_ef():
    tm = build_model(get_arch(SMOKE))
    gen = torch.Generator().manual_seed(0)
    st = init_server_state(tm, FedConfig(**_fed_kw("scan", "sgd", "int8",
                                                   True)), generator=gen)
    (res,) = st["comm"]["residual"]
    rows = next(iter(st["opt"].values()), None)
    assert res.shape[0] == COHORT and res.shape[2] == 128 and rows is None
    assert not res.any()
    for kw in (_fed_kw("scan", "sgd", "int8", False),
               _fed_kw("scan", "sgd", "none", False)):
        assert "comm" not in init_server_state(tm, FedConfig(**kw),
                                               generator=gen)
