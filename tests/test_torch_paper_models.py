"""The paper's own models in the PyTorch port, module by module, against the
JAX package on the CPU: the CNN and GRU (loss, gradient and
jvp-of-gradient at full width, dropout on with JAX's own masks injected),
the losses, the data stand-ins and partitioners (byte-identical), ``optim/``
and the bridge.  Inputs are made with numpy from a seed; tolerances are
max |a-b| over max |b| per leaf (``_torch_parity.rel_err``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, jvp

from _torch_parity import (jax_dropout_masks, jax_params_to_torch,
                           max_tree_rel_err, rel_err)
from repro.configs import paper_models as JPM
from repro.core.flat import make_flat_spec as jax_make_flat_spec
from repro.data import partition as JP
from repro.data import synthetic as JS
from repro.data.pipeline import FederatedData as JaxFederatedData
from repro.models import layers as JL
from repro.models import smallnets as JSN
from repro.optim import optimizers as JO
from repro.optim import schedules as JSC
from repro_torch import bridge
from repro_torch.configs import paper_models as PM
from repro_torch.core.flat import make_flat_spec
from repro_torch.data import partition as TP
from repro_torch.data import synthetic as TS
from repro_torch.data.pipeline import FederatedData
from repro_torch.models import layers as TL
from repro_torch.models import smallnets as TSN
from repro_torch.models.model import (Dropout, build_paper_cnn,
                                      build_paper_gru)
from repro_torch.optim import optimizers as TO
from repro_torch.optim import schedules as TSC

# full-width flat rows (rows, 128) of each config's single fp32 group
FULL_ROWS = {"paper-cifar-cnn": 10_848, "paper-femnist-cnn": 13_208,
             "paper-shakespeare-gru": 31_648}
FULL_PARAMS = {"paper-cifar-cnn": 1_387_786, "paper-femnist-cnn": 1_690_046,
               "paper-shakespeare-gru": 4_050_522}
TOL = 1e-5          # loss, gradient, jvp-of-gradient
OPT_TOL = 1e-6      # optim/


def test_configs_are_the_jax_configs():
    names = ("CIFAR_CNN", "FEMNIST_CNN", "SHAKESPEARE_GRU", "CIFAR_CNN_SMOKE",
             "FEMNIST_CNN_SMOKE", "SHAKESPEARE_GRU_SMOKE")
    for n in names:
        assert dataclasses.asdict(getattr(PM, n)) == \
            dataclasses.asdict(getattr(JPM, n)), n
    assert set(PM.PAPER_MODELS) == {getattr(JPM, n).name for n in names}


# ---------------------------------------------------------------------------
# the models at full width
# ---------------------------------------------------------------------------
def _batch(cfg, b, seed):
    rng = np.random.default_rng(seed)
    if hasattr(cfg, "image_size"):
        return {"x": rng.normal(0, 1, (b, cfg.image_size, cfg.image_size,
                                       cfg.in_channels)).astype(np.float32),
                "y": rng.integers(0, cfg.num_classes, b).astype(np.int32)}
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, 9))
            .astype(np.int32)}


def _tangent(params, seed):
    rng = np.random.default_rng(seed)
    return {k: (0.01 * rng.normal(0, 1, np.shape(v))).astype(np.float32)
            for k, v in params.items()}


@pytest.mark.parametrize("name", ["CIFAR_CNN", "FEMNIST_CNN",
                                  "SHAKESPEARE_GRU"])
def test_full_width_loss_grad_and_jvp_of_grad_match_jax(name):
    """Loss, gradient and the HVP of UGA's reverse sweep (jvp of the
    gradient) at the published widths, batch 2 (GRU: 2 sequences of 9),
    the CNN with dropout 0.2 under the masks JAX's key draws."""
    jcfg, tcfg = getattr(JPM, name), getattr(PM, name)
    cnn = isinstance(jcfg, JPM.CNNConfig)
    jparams = (JSN.cnn_init if cnn else JSN.gru_init)(
        jcfg, jax.random.PRNGKey(0))
    tparams = jax_params_to_torch(jparams)
    batch = _batch(jcfg, 2, 1)
    key = jax.random.PRNGKey(5)
    jloss = ((lambda p: JSN.cnn_loss(p, jcfg, batch, rng=key)) if cnn
             else (lambda p: JSN.gru_loss(p, jcfg, batch)))
    tan_np = _tangent({k: np.asarray(v) for k, v in
                       tparams.items()}, 2)
    jtan = jax.tree.map(jnp.asarray, bridge.to_numpy(
        {k: torch.from_numpy(v) for k, v in tan_np.items()}))

    @jax.jit
    def jall(p, t):
        l, g = jax.value_and_grad(jloss)(p)
        return l, g, jax.jvp(jax.grad(jloss), (p,), (t,))[1]

    jl, jg, jh = jall(jparams, jtan)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    if cnn:
        masks = tuple(torch.from_numpy(m) for m in jax_dropout_masks(
            key, jcfg.fc, 2, jcfg.dropout))
        tloss = lambda p: TSN.cnn_loss(p, tcfg, tb, rng=masks)
    else:
        tloss = lambda p: TSN.gru_loss(p, tcfg, tb)
    tl = tloss(tparams)
    tg = grad(tloss)(tparams)
    th = jvp(grad(tloss), (tparams,),
             ({k: torch.from_numpy(v) for k, v in tan_np.items()},))[1]
    flat = lambda t: {k: np.asarray(v) for k, v in
                      bridge.to_torch(jax.tree.map(np.asarray, t)).items()}
    e_l = rel_err(tl, np.asarray(jl))
    e_g = max_tree_rel_err(tg, flat(jg))
    e_h = max_tree_rel_err(th, flat(jh))
    assert max(e_l, e_g, e_h) <= TOL, (e_l, e_g, e_h)
    if cnn:   # the masks matter: without them the loss moves
        nodrop = rel_err(TSN.cnn_loss(tparams, tcfg, tb), np.asarray(jl))
        assert nodrop > 100 * TOL, nodrop


@pytest.mark.parametrize("name", ["CIFAR_CNN", "FEMNIST_CNN",
                                  "SHAKESPEARE_GRU"])
def test_init_layout_bridge_and_flat_rows_match_jax(name):
    """``bridge.to_torch`` carries JAX's tree across unchanged (conv weights
    HWIO), the port's own init has the same names, shapes and dtypes, and
    the flat layout gives JAX's rows: 10,848 / 13,208 / 31,648."""
    jcfg, tcfg = getattr(JPM, name), getattr(PM, name)
    cnn = isinstance(jcfg, JPM.CNNConfig)
    jparams = (JSN.cnn_init if cnn else JSN.gru_init)(
        jcfg, jax.random.PRNGKey(0))
    tparams = jax_params_to_torch(jparams)
    for k, v in tparams.items():
        assert v.numpy().tobytes() == np.asarray(
            bridge.to_torch(jparams)[k]).tobytes()
    jspec, tspec = jax_make_flat_spec(jparams), make_flat_spec(tparams)
    assert [g.rows for g in tspec.groups] == [g.rows for g in jspec.groups] \
        == [FULL_ROWS[jcfg.name]]
    assert tspec.groups[0].size == FULL_PARAMS[jcfg.name]
    model = (build_paper_cnn if cnn else build_paper_gru)(tcfg)
    own = model.init(torch.Generator().manual_seed(0))
    assert list(own) == list(tparams)
    assert {k: (tuple(v.shape), v.dtype) for k, v in own.items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in tparams.items()}
    if cnn:
        k = jcfg.conv_kernel
        assert tparams["conv1_w"].shape == (k, k, jcfg.in_channels,
                                            jcfg.conv_channels[0])
        assert model.dropout == Dropout(jcfg.dropout, jcfg.fc)
    else:
        assert model.dropout is None
    back = bridge.to_numpy(tparams)
    assert jax.tree.structure(back) == jax.tree.structure(
        jax.tree.map(np.asarray, jparams))


def test_smoke_models_loss_and_metrics_match_jax():
    """``Model.loss`` -> (xent, {"xent", "acc"}) on the smoke configs, and
    the even-kernel refusal."""
    from repro.models.model import build_paper_cnn as jbuild_cnn
    from repro.models.model import build_paper_gru as jbuild_gru
    for jcfg, tcfg, jb, tb_ in ((JPM.FEMNIST_CNN_SMOKE, PM.FEMNIST_CNN_SMOKE,
                                 jbuild_cnn, build_paper_cnn),
                                (JPM.SHAKESPEARE_GRU_SMOKE,
                                 PM.SHAKESPEARE_GRU_SMOKE, jbuild_gru,
                                 build_paper_gru)):
        jm, tm = jb(jcfg), tb_(tcfg)
        jp = jm.init(jax.random.PRNGKey(1))
        batch = _batch(jcfg, 4, 3)
        jl, jmet = jm.loss(jp, batch)
        tl, tmet = tm.loss(jax_params_to_torch(jp),
                           {k: torch.from_numpy(v) for k, v in batch.items()})
        assert rel_err(tl, np.asarray(jl)) <= TOL
        assert set(tmet) == set(jmet) == {"xent", "acc"}
        # the same count of right predictions (JAX's mean may multiply by
        # 1/n, one ulp from a division)
        assert abs(float(tmet["acc"]) - float(jmet["acc"])) <= 1e-6
    with pytest.raises(ValueError, match="odd"):
        TSN.cnn_apply(TSN.cnn_init(PM.CIFAR_CNN_SMOKE,
                                   torch.Generator().manual_seed(0)),
                      dataclasses.replace(PM.CIFAR_CNN_SMOKE, conv_kernel=4),
                      torch.zeros((1, 32, 32, 3)))


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------
def test_softmax_xent_and_accuracy_match_jax():
    """Random logits, integer logits with ties (argmax takes the first
    index), int32 labels, with and without a mask, 2-D and 3-D."""
    rng = np.random.default_rng(0)
    for shape in ((7, 11), (3, 5, 90)):
        for tie in (False, True):
            logits = (rng.integers(0, 3, shape) if tie
                      else rng.normal(0, 3, shape)).astype(np.float32)
            labels = rng.integers(0, shape[-1], shape[:-1]).astype(np.int32)
            mask = (rng.random(shape[:-1]) < 0.6).astype(np.float32)
            tl, tlab = torch.from_numpy(logits), torch.from_numpy(labels)
            for m in (None, mask):
                tmask = None if m is None else torch.from_numpy(m)
                jx = JL.softmax_xent(logits, labels, m)
                tx = TL.softmax_xent(tl, tlab, tmask)
                assert rel_err(tx, np.asarray(jx)) <= 1e-6
                assert float(TL.accuracy(tl, tlab, tmask)) == float(
                    JL.accuracy(logits, labels, m))


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------
def _same_arrays(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def test_synthetic_data_and_partitioners_are_byte_identical():
    """Same generator in, same bytes out, and the generators left in the
    same state (their next draws agree)."""
    for kw in (dict(n=300, image_size=8, channels=3, num_classes=10,
                    num_writers=7),
               dict(n=200, image_size=6, channels=1, num_classes=62,
                    num_writers=9, style_strength=1.2, label_skew_alpha=0.2,
                    noise=0.5)):
        rj, rt = np.random.default_rng(4), np.random.default_rng(4)
        dj, dt = JS.synthetic_images(rj, **kw), TS.synthetic_images(rt, **kw)
        for f in ("x", "y", "writer"):
            _same_arrays(getattr(dt, f), getattr(dj, f))
        assert rj.random() == rt.random()
    rj, rt = np.random.default_rng(5), np.random.default_rng(5)
    cj = JS.synthetic_chars(rj, n=64, seq_len=21, vocab=90, num_roles=12)
    ct = TS.synthetic_chars(rt, n=64, seq_len=21, vocab=90, num_roles=12)
    _same_arrays(ct.tokens, cj.tokens)
    _same_arrays(ct.role, cj.role)
    for pj, pt in ((JP.partition_dirichlet(rj, dj.y, 6, alpha=0.3,
                                           min_per_client=4),
                    TP.partition_dirichlet(rt, dt.y, 6, alpha=0.3,
                                           min_per_client=4)),
                   (JP.partition_by_writer(dj.writer, range(9)),
                    TP.partition_by_writer(dt.writer, range(9)))):
        assert len(pj) == len(pt)
        for a, b in zip(pt, pj):
            _same_arrays(np.asarray(a), np.asarray(b))
    for overlap in (0.0, 0.5, 1.0):
        _same_arrays(TP.make_meta_set(rt, dt.writer, [0, 1, 2, 3],
                                      [4, 5, 6, 7], overlap=overlap,
                                      fraction=0.05),
                     JP.make_meta_set(rj, dj.writer, [0, 1, 2, 3],
                                      [4, 5, 6, 7], overlap=overlap,
                                      fraction=0.05))
    assert rj.random() == rt.random()
    arrays = {"x": dt.x, "y": dt.y}
    idx = np.arange(0, 150, 3)
    jb = list(JaxFederatedData(arrays=arrays, client_indices=[idx])
              .eval_batches(idx, 16))
    tb = list(FederatedData(arrays=arrays, client_indices=[idx])
              .eval_batches(idx, 16))
    assert [len(b["y"]) for b in tb] == [16, 16, 16, 2]
    for a, b in zip(tb, jb):
        for k in arrays:
            _same_arrays(a[k], b[k])


# ---------------------------------------------------------------------------
# optim/
# ---------------------------------------------------------------------------
def test_optimizers_and_schedules_match_jax():
    rng = np.random.default_rng(7)
    shapes = {"a": (5, 3), "b": (4,), "c.d": (2, 2, 2)}
    p = {k: rng.normal(0, 1, s).astype(np.float32) for k, s in shapes.items()}
    gs = [{k: rng.normal(0, 1, s).astype(np.float32)
           for k, s in shapes.items()} for _ in range(4)]
    tt = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}
    jt = lambda d: {k: jnp.asarray(v) for k, v in d.items()}
    e = max_tree_rel_err(TO.sgd_step(tt(p), tt(gs[0]), 0.05),
                         {k: np.asarray(v) for k, v in
                          JO.sgd_step(jt(p), jt(gs[0]), 0.05).items()})
    assert e <= OPT_TOL
    jp, js = jt(p), JO.adam_init(jt(p))
    tp, ts = tt(p), TO.adam_init(tt(p))
    for g in gs:
        jp, js = JO.adam_step(jp, jt(g), js, 0.01)
        tp, ts = TO.adam_step(tp, tt(g), ts, 0.01)
    assert ts["t"] == int(js["t"]) == len(gs)
    for port, ref in ((tp, jp), (ts["m"], js["m"]), (ts["v"], js["v"])):
        assert max_tree_rel_err(port, {k: np.asarray(v)
                                       for k, v in ref.items()}) <= OPT_TOL
    scheds = [(TSC.constant(0.1), JSC.constant(0.1)),
              (TSC.cosine(0.1, 100, warmup=10), JSC.cosine(0.1, 100,
                                                           warmup=10)),
              (TSC.cosine(0.3, 50), JSC.cosine(0.3, 50)),
              (TSC.wsd_schedule(0.1, 200), JSC.wsd_schedule(0.1, 200))]
    for tf, jf in scheds:
        for step in (0, 1, 5, 10, 49, 95, 100, 180, 199, 250):
            a, b = tf(step), float(jf(step))
            assert isinstance(a, float)
            assert abs(a - b) <= OPT_TOL * max(abs(b), 1e-30), (step, a, b)
    assert TSC.linear_scaling_lr(0.1, 128) == JSC.linear_scaling_lr(0.1, 128)
