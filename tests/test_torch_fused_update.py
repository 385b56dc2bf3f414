"""Fused server-update kernels of the PyTorch port.

On the CPU each wrapper runs its plain PyTorch version; those are held
against the JAX package's ops (Pallas in interpret mode, as the JAX suite
runs them) on the same numpy inputs, to <= 1e-6 relative (max |a-b| over
max |b|) — two fp32 implementations of one formula, which may round a
product in another order.  ``test_torch_kernels_cuda.py`` holds each CUDA
kernel against its plain version on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import rel_err
from repro.core import flat as JF
from repro.kernels.fused_update import kernel as JK
from repro.kernels.fused_update import ops as JO
from repro_torch.core import flat as TF
from repro_torch.kernels.fused_update import kernel as K
from repro_torch.kernels.fused_update import ops as O

TOL = 1e-6
ROWS = [8, 24, 264]
OPTS = ["sgd", "sgdm", "adam", "yogi"]


def _tree(rows, seed):
    """Two fp32 leaves whose flat layout has exactly ``rows`` rows."""
    rng = np.random.default_rng(seed)
    n = rows * 128 - 77
    a = rng.standard_normal((n - 3 * 5,)).astype(np.float32)
    b = rng.standard_normal((3, 5)).astype(np.float32)
    return {"a": a, "b": b}


def _opt_state(opt, rows, seed, lib):
    """Warm optimizer state (t = 5, random m, v > 0), as the JAX suite
    compares adam/yogi: from zeros the first step saturates to lr*sign(g)."""
    rng = np.random.default_rng(seed)
    m = (0.1 * rng.standard_normal((rows, 128))).astype(np.float32)
    v = (0.01 * rng.random((rows, 128)) + 1e-3).astype(np.float32)
    if lib == "jax":
        arr, t = jnp.asarray, jnp.asarray(5, jnp.int32)
    else:
        arr, t = torch.from_numpy, torch.tensor(5, dtype=torch.int32)
    return {"sgd": {}, "sgdm": {"m": (arr(m),)},
            "adam": {"m": (arr(m),), "v": (arr(v),), "t": t},
            "yogi": {"m": (arr(m),), "v": (arr(v),), "t": t}}[opt]


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("cohort", [1, 3])
def test_aggregate_matches_jax(cohort, rows):
    rng = np.random.default_rng(cohort * 1000 + rows)
    g = rng.standard_normal((cohort, rows, 128)).astype(np.float32)
    w = rng.random(cohort).astype(np.float32) + 0.5
    Gs, ssq = O.flat_weighted_aggregate(_spec(rows),
                                        [torch.from_numpy(g)],
                                        torch.from_numpy(w))
    wn = jnp.asarray(w) / jnp.sum(jnp.asarray(w))
    JG, jssq = JK.aggregate_pass(jnp.asarray(g), wn, interpret=True)
    assert rel_err(Gs[0], JG) <= TOL
    assert abs(float(ssq) - float(jssq)) <= TOL * abs(float(jssq))


def _spec(rows):
    return TF.make_flat_spec({"x": torch.zeros(rows * 128)})


@pytest.mark.parametrize("rows", ROWS)
def test_accumulate_matches_jax(rows):
    rng = np.random.default_rng(rows)
    acc, g = (rng.standard_normal((2, rows, 128)).astype(np.float32))
    w = np.float32(0.37)
    out = O.flat_accumulate(torch.from_numpy(acc), torch.from_numpy(g),
                            torch.tensor([w]))
    ref = JK.accumulate_pass(jnp.asarray(acc), jnp.asarray(g), w,
                             interpret=True)
    assert rel_err(out, ref) <= TOL
    inplace = torch.from_numpy(acc.copy())
    O.flat_accumulate(inplace, torch.from_numpy(g), torch.tensor([w]),
                      out=inplace)
    assert torch.equal(inplace, out)


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("clip", [0.0, 0.5])
@pytest.mark.parametrize("opt", OPTS)
def test_apply_groups_matches_jax(opt, clip, rows):
    """Pass 2 through the public ops (clip scale, bias corrections and the
    update kernel's plain version) against the JAX ops; clip 0.5 makes the
    scale != 1 (||G|| is ~sqrt(rows * 128))."""
    tree = _tree(rows, seed=rows)
    G = np.random.default_rng(rows + 1).standard_normal(
        (rows, 128)).astype(np.float32)
    G.reshape(-1)[rows * 128 - 77:] = 0.0           # the zero pad
    jtree = {k: jnp.asarray(v) for k, v in tree.items()}
    ttree = {k: torch.from_numpy(v) for k, v in tree.items()}
    jspec, tspec = JF.make_flat_spec(jtree), TF.make_flat_spec(ttree)
    assert tspec.groups[0].rows == jspec.groups[0].rows == rows
    gn = float(np.sqrt(np.sum(G.astype(np.float64) ** 2)))
    kw = dict(opt=opt, lr=0.05, clip_norm=clip, momentum=0.9)
    jp, jst, jgn = JO.flat_apply_groups(
        jspec, [jnp.asarray(G)], jnp.float32(gn), jtree,
        _opt_state(opt, rows, 9, "jax"), interpret=True, **kw)
    tp, tst, tgn = O.flat_apply_groups(
        tspec, [torch.from_numpy(G)], torch.tensor(gn, dtype=torch.float32),
        ttree, _opt_state(opt, rows, 9, "torch"), **kw)
    for k in tree:
        assert rel_err(tp[k], jp[k]) <= TOL, k
    for slot in ("m", "v"):
        if slot in jst:
            assert rel_err(tst[slot][0], jst[slot][0]) <= TOL, slot
    if "t" in jst:
        assert int(tst["t"]) == int(jst["t"]) == 6
    assert abs(float(tgn) - float(jgn)) <= TOL * float(jgn)


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_fused_apply_flat_matches_jax(opt):
    """The scan cohort's pass 2 (||G||^2 reduced in plain code)."""
    rows = 24
    tree = _tree(rows, seed=1)
    G = np.random.default_rng(2).standard_normal(
        (rows, 128)).astype(np.float32) * 0.01
    jtree = {k: jnp.asarray(v) for k, v in tree.items()}
    ttree = {k: torch.from_numpy(v) for k, v in tree.items()}
    kw = dict(opt=opt, lr=0.1, clip_norm=1.0)
    jp, _, jgn = JO.fused_apply_flat(jtree, [jnp.asarray(G)],
                                     _opt_state(opt, rows, 3, "jax"),
                                     interpret=True, **kw)
    tp, _, tgn = O.fused_apply_flat(ttree, [torch.from_numpy(G)],
                                    _opt_state(opt, rows, 3, "torch"), **kw)
    for k in tree:
        assert rel_err(tp[k], jp[k]) <= TOL, k
    assert abs(float(tgn) - float(jgn)) <= TOL * float(jgn)


def test_wrappers_check_their_inputs():
    x = torch.zeros(8, 128)
    with pytest.raises(TypeError):
        K.accumulate_pass(x, x.double(), torch.ones(1))
    with pytest.raises(ValueError):
        K.accumulate_pass(x, torch.zeros(16, 128), torch.ones(1))
    with pytest.raises(ValueError):
        K.aggregate_pass(torch.zeros(2, 8, 64), torch.ones(2))
    with pytest.raises(ValueError, match="contiguous"):
        K.aggregate_pass(torch.zeros(2, 128, 8).transpose(1, 2),
                         torch.ones(2))
    with pytest.raises(ValueError):
        K.update_pass(x, x, None, None, torch.ones(4), opt="adam")
    before = dict(K.launch_counts())
    K.accumulate_pass(x, x, torch.ones(1))
    assert K.launch_counts() == before          # the plain path: no launch
