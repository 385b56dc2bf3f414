"""The paper models' slice as a whole, the port against the JAX package on
the CPU: fused UGA + FedMeta rounds on the CIFAR CNN (smoke widths, dropout
0.2 under the masks JAX's key chain draws, injected) on the vmap and scan
cohorts and under ``through_aggregation`` on scan, whose backward re-runs
each client with its masks; the Shakespeare GRU on vmap; and
``experiments/common.py::train_method`` against ``benchmarks/common.py``'s
(``fused=True, rounds_per_call=1``) on the GRU.

Tolerances, max |a-b| over max |b| per leaf: parameters (and ctrl) 1e-5,
round metrics 1e-4 (the JAX suite's across engines); evaluation accuracy
as the same count of right predictions, evaluation loss 1e-4."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (jax_params_to_torch, jax_round_dropout,
                           max_tree_rel_err, rel_err)
from benchmarks.common import train_method as jax_train_method
from repro.configs import FedConfig as JaxFedConfig
from repro.configs import paper_models as JPM
from repro.core.round import init_server_state as jax_init_state
from repro.core.round import make_federated_round as jax_make_round
from repro.core.rngtags import round_key
from repro.models.model import build_paper_cnn as jax_build_cnn
from repro.models.model import build_paper_gru as jax_build_gru
from repro_torch.configs import FedConfig
from repro_torch.configs import paper_models as PM
from repro_torch.core.dropout import HostDropout, InjectedDropout
from repro_torch.core.round import (RoundDraws, draw_round,
                                    init_server_state, make_federated_round)
from repro_torch.data.partition import partition_by_writer, partition_iid
from repro_torch.data.pipeline import FederatedData
from repro_torch.data.synthetic import synthetic_chars, synthetic_images
from repro_torch.experiments.common import METHODS, train_method
from repro_torch.models.model import build_paper_cnn, build_paper_gru

COHORT = 3
BATCH = 8            # client batch: 2 local steps of 4 (GRU: 4 of 2)
META_BATCH = 6
ROUNDS = 2
PARAM_TOL = 1e-5
METRIC_TOL = 1e-4


def _image_data(cfg):
    rng = np.random.default_rng(0)
    ds = synthetic_images(rng, n=96, image_size=cfg.image_size,
                          channels=cfg.in_channels,
                          num_classes=cfg.num_classes, num_writers=6)
    meta = rng.choice(96, 12, replace=False)
    return FederatedData(arrays={"x": ds.x, "y": ds.y},
                         client_indices=partition_iid(rng, 96, 6),
                         meta_indices=meta, shared_indices=meta.copy())


def _char_data(cfg, n=120, roles=6):
    rng = np.random.default_rng(1)
    ds = synthetic_chars(rng, n=n, seq_len=cfg.seq_len + 1,
                         vocab=cfg.vocab_size, num_roles=roles)
    parts = partition_by_writer(ds.role, list(range(roles)))
    meta = rng.choice(n, 12, replace=False)
    return FederatedData(arrays={"tokens": ds.tokens}, client_indices=parts,
                         meta_indices=meta, shared_indices=meta.copy())


def _to_t(batch):
    return {k: (torch.from_numpy(v) if v.dtype.kind == "f"
                else torch.from_numpy(v).long()) for k, v in batch.items()}


def _flat(tree):
    from repro_torch import bridge
    return {k: v.numpy() for k, v in
            bridge.to_torch(jax.tree.map(np.asarray, tree)).items()}


def _run_both(jmodel, tmodel, kw, data, dropout):
    """ROUNDS rounds of JAX's jitted round and the port's, from JAX's init,
    on the same samples; the port takes JAX's masks when ``dropout``.
    Returns (worst metric error, worst param error, worst ctrl error)."""
    jfed, fed = JaxFedConfig(**kw), FedConfig(**kw)
    jstate = jax_init_state(jmodel, jfed, jax.random.PRNGKey(0))
    tstate = init_server_state(tmodel, fed,
                               params=jax_params_to_torch(jstate["params"]))
    jround = jax.jit(jax_make_round(jmodel, jfed))
    tround = make_federated_round(tmodel, fed)
    e_m = 0.0
    for r in range(ROUNDS):
        s = data.sample_round(r, cohort=COHORT, batch=BATCH)
        meta = data.sample_meta(r, META_BATCH)
        key = round_key(jax.random.PRNGKey(0), r)
        jstate, jm = jround(jstate,
                            jax.tree.map(jnp.asarray, s["cohort_batch"]),
                            jax.tree.map(jnp.asarray, meta),
                            jnp.asarray(s["client_weights"]), key)
        draws = None
        if dropout:
            cfg = tmodel.cfg
            draws = RoundDraws(dropout=jax_round_dropout(
                key, widths=cfg.fc, rate=cfg.dropout, cohort=COHORT,
                n_steps=kw["local_steps"],
                step_batch=BATCH // kw["local_steps"], eval_batch=BATCH,
                meta_batch=META_BATCH))
        tstate, tm = tround(tstate, _to_t(s["cohort_batch"]), _to_t(meta),
                            torch.from_numpy(s["client_weights"]), draws)
        assert set(tm) == set(jm), (sorted(tm), sorted(jm))
        e_m = max(e_m, max(rel_err(torch.as_tensor(tm[k]), np.asarray(jm[k]))
                           for k in jm))
    e_p = max_tree_rel_err(tstate["params"], _flat(jstate["params"]))
    e_c = (max_tree_rel_err(tstate["ctrl"], {k: np.asarray(v) for k, v in
                                            jstate["ctrl"].items()})
           if "ctrl" in jstate else 0.0)
    return e_m, e_p, e_c, tstate


# the port-only checks run the CIFAR smoke CNN on 16 x 16 images
SMALL_CNN = dataclasses.replace(PM.CIFAR_CNN_SMOKE, image_size=16)
CNN_KW = dict(algorithm="uga", meta=True, cohort=COHORT, local_steps=2,
              client_lr=0.05, server_lr=0.1, meta_lr=0.05, lr_decay=0.996,
              clip_norm=2.0, fused_update=True)


@pytest.mark.parametrize("mode", ["vmap", "scan", "scan-through_aggregation"])
def test_cnn_rounds_with_jax_dropout_masks_match_jax(mode):
    """Two fused UGA + FedMeta rounds on CIFAR_CNN_SMOKE, dropout 0.2: the
    clients' local steps, gradient evaluations and HVP sweeps and the
    FedMeta step each under the masks JAX's keys draw."""
    strategy, _, meta_mode = mode.partition("-")
    kw = dict(CNN_KW, cohort_strategy=strategy,
              meta_mode=meta_mode or "post")
    cfg = PM.CIFAR_CNN_SMOKE
    assert cfg.dropout == 0.2
    e_m, e_p, e_c, _ = _run_both(jax_build_cnn(JPM.CIFAR_CNN_SMOKE),
                                 build_paper_cnn(cfg), kw, _image_data(cfg),
                                 dropout=True)
    assert e_m <= METRIC_TOL and max(e_p, e_c) <= PARAM_TOL, (e_m, e_p, e_c)


def test_cnn_round_needs_its_masks_and_host_draws_repeat():
    """A dropout model's round without its draws raises; the port's own
    host draws (numpy, keyed by seed and round) repeat the round bitwise,
    keep about 1 - rate of the units and have the round's shapes."""
    cfg = SMALL_CNN
    fed = FedConfig(**CNN_KW)
    model = build_paper_cnn(cfg)
    data = _image_data(cfg)
    s, meta = data.sample_round(0, cohort=COHORT, batch=BATCH), \
        data.sample_meta(0, META_BATCH)
    params = model.init(torch.Generator().manual_seed(0))
    args = (_to_t(s["cohort_batch"]), _to_t(meta),
            torch.from_numpy(s["client_weights"]))
    one_round = make_federated_round(model, fed)
    with pytest.raises(ValueError, match="dropout"):
        one_round(init_server_state(model, fed, params=params), *args)
    draws = draw_round(fed, 0, 0, COHORT, dropout=True)
    assert draws.dropout == HostDropout(0, 0)
    outs = [one_round(init_server_state(model, fed, params=params), *args,
                      draws)[0]["params"] for _ in range(2)]
    for k in outs[0]:
        assert torch.equal(outs[0][k], outs[1][k]), k
    masks = draws.dropout.masks(model.dropout, cohort=COHORT, n_steps=2,
                                step_batch=4, eval_batch=BATCH,
                                meta_batch=META_BATCH, device="cpu")
    keep = torch.cat([m.reshape(-1) for m in masks.steps + masks.evaluation
                      + masks.meta]).to(torch.float32)
    assert abs(float(keep.mean()) - 0.8) < 0.05
    assert [tuple(m.shape) for m in masks.steps] == [
        (COHORT, 2, 4, w) for w in cfg.fc]
    short = InjectedDropout([m.numpy()[:, :1] for m in masks.steps],
                            [m.numpy() for m in masks.evaluation],
                            [m.numpy() for m in masks.meta])
    with pytest.raises(ValueError, match="injected dropout masks"):
        one_round(init_server_state(model, fed, params=params), *args,
                  RoundDraws(dropout=short))


def test_cnn_async_tick_with_masks_is_bitwise_the_sync_scan_round():
    """The buffered-async tick hands each client and the FedMeta step the
    round's masks as the sync round does: at K = capacity = cohort on the
    scan base, fault-free, two ticks under the trainer's host draws are
    bitwise two sync scan rounds under the same draws."""
    cfg = SMALL_CNN
    model = build_paper_cnn(cfg)
    params = model.init(torch.Generator().manual_seed(1))
    data = _image_data(cfg)
    sync = FedConfig(**CNN_KW, cohort_strategy="scan")
    asyn = dataclasses.replace(sync, engine="buffered_async",
                               async_buffer=COHORT, async_capacity=COHORT)
    out = []
    for fed in (sync, asyn):
        state = init_server_state(model, fed, params=dict(params))
        one_round = make_federated_round(model, fed)
        for r in range(2):
            s = data.sample_round(r, cohort=COHORT, batch=BATCH)
            state, m = one_round(
                state, _to_t(s["cohort_batch"]),
                _to_t(data.sample_meta(r, META_BATCH)),
                torch.from_numpy(s["client_weights"]),
                draw_round(fed, 0, r, COHORT, dropout=True))
        out.append((state["params"], m))
    (ps, ms), (pa, ma) = out
    for k in ps:
        assert torch.equal(ps[k], pa[k]), k
    for k in ("client_loss", "meta_loss", "grad_norm"):
        assert float(ms[k]) == float(ma[k]), k
    assert float(ma["server_steps"]) == 1.0


GRU_KW = dict(algorithm="uga", meta=True, cohort=COHORT, local_steps=4,
              client_lr=0.5, server_lr=1.0, meta_lr=0.5, lr_decay=0.999,
              clip_norm=0.5, fused_update=True)


def test_gru_rounds_match_jax():
    """Two fused UGA + FedMeta rounds on SHAKESPEARE_GRU_SMOKE, vmap: no
    dropout, so no draws."""
    cfg = PM.SHAKESPEARE_GRU_SMOKE
    e_m, e_p, _, _ = _run_both(jax_build_gru(JPM.SHAKESPEARE_GRU_SMOKE),
                               build_paper_gru(cfg), GRU_KW, _char_data(cfg),
                               dropout=False)
    assert e_m <= METRIC_TOL and e_p <= PARAM_TOL, (e_m, e_p)


@pytest.mark.parametrize("method", ["fedmeta_uga", "fedshare"])
def test_train_method_matches_benchmarks_train_method(method):
    """4 rounds of the six-method loop on the GRU smoke, evaluated at
    rounds 0, 2 and 3: the same evaluation history as JAX's loop at
    ``fused=True, rounds_per_call=1``."""
    cfg = PM.SHAKESPEARE_GRU_SMOKE
    data = _char_data(cfg)
    eval_idx = np.arange(0, 120, 3)
    common = dict(rounds=4, cohort=COHORT, batch=BATCH, local_steps=4,
                  lr=0.5, eval_idx=eval_idx, eval_every=2, seed=0,
                  uga_server_lr=1.0, clip_norm=0.5, lr_decay=0.999,
                  meta_batch=META_BATCH)
    jmodel = jax_build_gru(JPM.SHAKESPEARE_GRU_SMOKE)
    jh = jax_train_method(jmodel, data, method, fused=True,
                          rounds_per_call=1, **common)
    th = train_method(build_paper_gru(cfg), data, method, device="cpu",
                      rounds_per_call=1, params=jax_params_to_torch(
                          jmodel.init(jax.random.PRNGKey(0))), **common)
    assert [h["round"] for h in th] == [h["round"] for h in jh] == [0, 2, 3]
    n = eval_idx.size
    for a, b in zip(th, jh):
        # the same count of right predictions (the fp32 means may round
        # one ulp apart: JAX's mean multiplies by 1/n)
        assert round(a["acc"] * n) == round(b["acc"] * n), (a, b)
        assert abs(a["acc"] - b["acc"]) <= 1e-6, (a, b)
        assert abs(a["loss"] - b["loss"]) <= METRIC_TOL * abs(b["loss"])
        assert abs(a["client_loss"] - b["client_loss"]) <= \
            METRIC_TOL * abs(b["client_loss"])


def test_train_method_refuses_what_is_not_ported():
    """Unported arms name their ROADMAP item (trackers, item 8); the
    legacy engine and multi-round calls, once refused, run as JAX's
    ``train_method`` runs them; without a card, the entry points raise
    unless given the CPU."""
    cfg = PM.SHAKESPEARE_GRU_SMOKE
    common = dict(rounds=1, cohort=COHORT, batch=BATCH, local_steps=4,
                  lr=0.5, eval_idx=np.arange(4), device="cpu")
    model, data = build_paper_gru(cfg), _char_data(cfg)
    assert list(METHODS) == ["fedavg", "fedprox", "fedshare", "uga",
                             "fedmeta", "fedmeta_uga"]
    for kw in (dict(fused=False), dict(rounds_per_call=4)):
        (h,) = train_method(model, data, "uga", **common, **kw)
        assert h["round"] == 0 and np.isfinite(h["loss"]), (kw, h)
    with pytest.raises(NotImplementedError, match="item 8"):
        train_method(model, data, "uga", **common, tracker="jsonl")
    if not torch.cuda.is_available():
        # the entry points run on the card unless asked for the CPU
        from repro_torch.experiments import paper
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train_method(model, data, "uga", **{**common, "device": None})
        with pytest.raises(RuntimeError, match="device='cpu'"):
            paper.main(["--model", "paper-shakespeare-gru-smoke",
                        "--rounds", "1", "--examples", "200"])
    with pytest.raises(TypeError):
        build_paper_cnn(dataclasses.replace(cfg))
