"""The compressed uplink end to end: 3 rounds of the JAX ``FederatedTrainer``
against the port's trainer with a lossy codec — same data seed, same
bridged init, fused engine, UGA + FedMeta (``meta_mode='post'``) — at
smoke size, and the port's config and round guards against JAX's.

Tolerances: history metrics <= 1e-4 relative (the JAX suite's across
engines) and ``comm_bytes`` exactly.  Parameters and error-feedback
residuals are held by a flip-aware criterion.  The codecs are
discontinuous: a one-ulp difference between the two packages' client
gradients moves an int8 code by one step, or flips a sign, at the few
elements that sit on a rounding boundary, and that moves the aggregate
there by ``scale * w_k`` (about amax / 127) or ``2 mu w_k``.  So:

  * every element off by more than 1e-5 (of max |b| per parameter leaf;
    of the encoded input's size for the residuals, see below) is counted,
    and the count must stay under FLIP_FRACTION (1e-3) of the elements;
  * each counted element's difference must be at most what a few flips
    amount to there (parameters: FLIP_CAP of the leaf's largest entry;
    residuals: one codec step per round);
  * every other element is held to the usual 1e-5.

The counts seen are printed (``-s``) and stated in ``PERF.md``.  Adam runs
from a warm state (t = 5, random m, v > 0), as the port's other adam
parity tests do (ROADMAP Queue 3).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import SMOKE, jax_params_to_torch
from repro.configs import FedConfig as JaxFedConfig
from repro.configs import get_arch as jax_get_arch
from repro.core import FederatedTrainer as JaxTrainer
from repro.launch.train import build_synthetic_fed_data as jax_fed_data
from repro.models.model import build_model as jax_build_model
from repro_torch import bridge
from repro_torch.configs import FedConfig, get_arch
from repro_torch.core import executors as TE
from repro_torch.core.round import init_server_state, make_federated_round
from repro_torch.core.trainer import FederatedTrainer
from repro_torch.launch.train import build_synthetic_fed_data, main
from repro_torch.models.model import build_model

ROUNDS, COHORT, BATCH, SEQ = 3, 2, 4, 32
TOL, TOL_METRIC = 1e-5, 1e-4
FLIP_FRACTION = 1e-3
FLIP_CAP = 1e-3
DATA_KW = dict(num_clients=8, examples=64, seq=SEQ, iid=False, seed=0)
RUN_KW = dict(rounds=ROUNDS, cohort=COHORT, batch=BATCH,
              meta_batch=2 * BATCH)


def _fed_kw(strategy, opt, codec, ef, **kw):
    return dict(algorithm="uga", meta=True, cohort=COHORT, local_steps=2,
                client_lr=0.01, server_lr=0.01, meta_lr=0.01,
                server_opt=opt, cohort_strategy=strategy, lr_decay=0.992,
                fused_update=True, codec=codec, error_feedback=ef, **kw)


def flip_aware(port, ref, *, ref_scale, cap, what):
    """Hold ``port`` to ``ref`` element by element: those off by more than
    TOL * ``ref_scale`` are counted; there may be at most FLIP_FRACTION of
    the elements, each off by at most ``cap``.  Returns the count."""
    a = np.asarray(port, np.float64).reshape(-1)
    b = np.asarray(ref, np.float64).reshape(-1)
    diff = np.abs(a - b)
    off = diff > TOL * ref_scale
    n_off = int(off.sum())
    assert n_off <= FLIP_FRACTION * a.size, (what, n_off, a.size)
    if n_off:
        assert diff[off].max() <= cap, (what, diff[off].max(), cap)
    return n_off


def _warm(rows, seed):
    rng = np.random.default_rng(seed)
    m = (0.01 * rng.standard_normal((rows, 128))).astype(np.float32)
    v = (1e-3 * rng.random((rows, 128)) + 1e-4).astype(np.float32)
    res = (1e-3 * rng.standard_normal((COHORT, rows, 128))).astype(
        np.float32)
    return {"m": (m,), "v": (v,), "t": np.int32(5)}, {"residual": (res,)}


CASES = {
    "int8-vmap-sgd": ("vmap", "sgd", "int8", False),
    "int8ef-scan-adam-warm": ("scan", "adam", "int8", True),
    "sign1bitef-vmap-sgd": ("vmap", "sgd", "sign1bit", True),
    "topk-scan-sgd": ("scan", "sgd", "topk", False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_three_rounds_match_jax_trainer(case):
    strategy, opt, codec, ef = CASES[case]
    kw = _fed_kw(strategy, opt, codec, ef, topk_ratio=0.05)
    jt = JaxTrainer(jax_build_model(jax_get_arch(SMOKE), dtype=jnp.float32,
                                    loss_chunk=256), JaxFedConfig(**kw),
                    seed=0)
    tt = FederatedTrainer(build_model(get_arch(SMOKE), loss_chunk=256),
                          FedConfig(**kw), device="cpu",
                          params=jax_params_to_torch(jt.state["params"]))
    assert ("comm" in tt.state) == ("comm" in jt.state) == ef
    if opt == "adam":
        opt_np, comm_np = _warm(jt.state["opt"]["m"][0].shape[0], 5)
        jt.state["opt"] = jax.tree.map(jnp.asarray, opt_np)
        jt.state["comm"] = jax.tree.map(jnp.asarray, comm_np)
        tt.state.update(bridge.server_state_to_torch(opt_np, comm=comm_np))
    jh = jt.run(jax_fed_data(jax_get_arch(SMOKE), **DATA_KW), **RUN_KW)
    th = tt.run(build_synthetic_fed_data(get_arch(SMOKE), **DATA_KW),
                **RUN_KW)

    assert [r["round"] for r in th] == list(range(ROUNDS))
    for jr, tr in zip(jh, th):
        assert set(tr) == set(jr) == {"round", "client_loss", "grad_norm",
                                      "meta_loss", "comm_bytes"}
        assert tr["comm_bytes"] == jr["comm_bytes"]
        for k in ("client_loss", "grad_norm", "meta_loss"):
            assert abs(tr[k] - jr[k]) <= TOL_METRIC * abs(jr[k]), (tr, jr)

    # parameters: a flip moves G by scale * w_k (int8) or 2 mu w_k
    # (sign1bit) at one element, and the server step moves that parameter
    # by lr times it (adam: by its step's response to it), about 1e-4 of
    # the leaf's largest entry here; FLIP_CAP allows several flips
    tp = tt.state["params"]
    jp = jax_params_to_torch(jt.state["params"])
    n_p = 0
    for k in jp:
        scale = float(np.max(np.abs(jp[k].numpy())))
        n_p += flip_aware(tp[k], jp[k], ref_scale=scale,
                          cap=FLIP_CAP * scale, what=k)
    n_r = 0
    if ef:
        # residuals: e - decode(encode(e)) is a cancellation, so it is held
        # against the size of e (int8: |r| <= scale / 2 = amax(e) / 254),
        # and a flip moves it by one step (int8: scale, at most 2 max |r|;
        # sign1bit: 2 mu), at most once a round
        res_t = tt.state["comm"]["residual"][0]
        res_j = np.asarray(jt.state["comm"]["residual"][0])
        r_max = float(np.max(np.abs(res_j)))
        n_r = flip_aware(
            res_t, res_j, ref_scale=r_max * (254 if codec == "int8" else 1),
            cap=ROUNDS * 2 * r_max * (1 + TOL), what="residual")
    print(f"{case}: parameter elements off by more than 1e-5: {n_p} of "
          f"{sum(v.numel() for v in tp.values())}; residual elements: {n_r}")


@pytest.fixture
def one_thread():
    """Bitwise comparisons within the port need the CPU's reductions in a
    fixed order: with several threads, PyTorch's CPU kernels may split a
    sum differently from run to run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("strategy", ["vmap", "scan"])
def test_codec_none_is_the_codec_free_round(strategy, monkeypatch,
                                            one_thread):
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
