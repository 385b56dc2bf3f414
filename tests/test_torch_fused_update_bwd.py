"""Backward of the port's fused server update: the plain versions of the
three backward kernels, and autograd through the fused ops.

On the CPU each backward wrapper runs its plain PyTorch version; those are
held against the JAX package's backward kernels (Pallas in interpret mode,
as the JAX suite runs them) on the same numpy inputs, and autograd through
the port's ops against ``jax.grad`` through JAX's ``fused_server_update``.

Tolerances (max |a-b| over max |b| per array):

  * elementwise outputs (dg, dG, dm, dv) <= 1e-6: one formula in two fp32
    implementations;
  * the sums (dw, dscal) <= 1e-5: the port adds fp32 products in fp64, JAX
    in fp32, and a dot product of random vectors cancels, so JAX's sum
    carries a few ulp of its terms' scale;
  * gradients through the whole step <= 1e-5, the JAX suite's tolerance
    between engines (``tests/test_fused_update.py``).

Adam and yogi run from a warm state (t = 5, random m, v > 0), as the JAX
suite runs them: from a cold start the first step is about lr * sign(G)
and its derivative is fp32 cancellation in any implementation.
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
from repro_torch.kernels.fused_update import ref as R

TOL = 1e-6
TOL_SUM = 1e-5
TOL_GRAD = 1e-5
ROWS = [8, 24, 264]
COHORTS = [1, 3, 5]
OPTS = ["sgd", "sgdm", "adam", "yogi"]
HAS_M = {"sgd": False, "sgdm": True, "adam": True, "yogi": True}
HAS_V = {"sgd": False, "sgdm": False, "adam": True, "yogi": True}
SCAL = np.array([0.7, 0.05, 1.0 / (1 - 0.9 ** 5), 1.0 / (1 - 0.99 ** 5)],
                np.float32)


def _randn(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _t(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


@pytest.mark.parametrize("rows", ROWS)
def test_accumulate_bwd_matches_jax(rows):
    rng = np.random.default_rng(rows)
    g, d_out = _randn(rng, rows, 128), _randn(rng, rows, 128)
    w = np.float32(0.37)
    dg, dw = K.accumulate_pass_bwd(_t(g), torch.tensor([w]), _t(d_out))
    jdg, jdw = JK.accumulate_pass_bwd(_j(g), w, _j(d_out), interpret=True)
    assert rel_err(dg, jdg) <= TOL
    assert rel_err(dw, jdw) <= TOL_SUM


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("cohort", COHORTS)
def test_aggregate_bwd_matches_jax(cohort, rows):
    """With a nonzero ssq cotangent, so the 2 dssq G term is live."""
    rng = np.random.default_rng(cohort * 1000 + rows)
    g = _randn(rng, cohort, rows, 128)
    w = rng.random(cohort).astype(np.float32) + 0.5
    w /= w.sum()
    G = np.einsum("k,krl->rl", w, g).astype(np.float32)
    dG = _randn(rng, rows, 128)
    dssq = np.float32(0.3)
    dg, dw = K.aggregate_pass_bwd(_t(g), _t(w), _t(G), _t(dG),
                                  torch.tensor(dssq))
    jdg, jdw = JK.aggregate_pass_bwd(_j(g), _j(w), _j(G), _j(dG),
                                     jnp.float32(dssq), interpret=True)
    assert dg.shape == (cohort, rows, 128) and dw.shape == (cohort,)
    assert rel_err(dg, jdg) <= TOL
    assert rel_err(dw, jdw) <= TOL_SUM


def _update_inputs(opt, rows, seed):
    rng = np.random.default_rng(seed)
    G = _randn(rng, rows, 128)
    m = _randn(rng, rows, 128, scale=0.1) if HAS_M[opt] else None
    v = ((0.01 * rng.random((rows, 128)) + 1e-3).astype(np.float32)
         if HAS_V[opt] else None)
    dpn = _randn(rng, rows, 128)
    dmn = _randn(rng, rows, 128) if HAS_M[opt] else None
    dvn = _randn(rng, rows, 128) if HAS_V[opt] else None
    return G, m, v, dpn, dmn, dvn


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("opt", OPTS)
def test_update_bwd_matches_jax(opt, rows):
    G, m, v, dpn, dmn, dvn = _update_inputs(opt, rows, rows + len(opt))
    hp = dict(opt=opt, momentum=0.9, b1=0.9, b2=0.99, eps=1e-8)
    got = K.update_pass_bwd(_t(G), _t(m), _t(v), _t(SCAL), _t(dpn), _t(dmn),
                            _t(dvn), **hp)
    want = JK.update_pass_bwd(_j(G), _j(m), _j(v), _j(SCAL[None]), _j(dpn),
                              _j(dmn), _j(dvn), interpret=True, **hp)
    for a, b, slot in zip(got[:3], want[:3], ("dG", "dm", "dv")):
        assert (a is None) == (b is None), slot
        if b is not None:
            assert rel_err(a, b) <= TOL, slot
    dscal, jdscal = got[3], np.asarray(want[3])[0]
    assert dscal.shape == (4,)
    for i, name in enumerate(("dscale", "dlr", "dbc1", "dbc2")):
        if not HAS_V[opt] and i >= 2:
            assert float(dscal[i]) == float(jdscal[i]) == 0.0, name
        else:
            assert rel_err(dscal[i], jdscal[i]) <= TOL_SUM, name


# ---------------------------------------------------------------------------
# The plain backward versions against autograd through the plain forwards
# ---------------------------------------------------------------------------
PAD = 3      # zero-padded tail rows, as a flat layout pads its last group


def _padded(x):
    if x is None:
        return None
    out = np.zeros((x.shape[0] + PAD, 128), np.float32)
    out[:x.shape[0]] = x
    return torch.from_numpy(out)


@pytest.mark.parametrize("opt", OPTS)
def test_update_bwd_plain_matches_autograd(opt):
    """update_bwd_ref on buffers with a zero-padded tail: exact zeros on the
    pad (autograd through sqrt gives NaN there: 0 * inf), and autograd's
    cotangents on the rows that hold data."""
    rows = 24
    G, m, v, dpn, dmn, dvn = _update_inputs(opt, rows, 7)
    hp = dict(opt=opt, momentum=0.9, b1=0.9, b2=0.99, eps=1e-8)
    dG, dm, dv, dscal = R.update_bwd_ref(
        _padded(G), _padded(m), _padded(v), _t(SCAL), _padded(dpn),
        _padded(dmn), _padded(dvn), **hp)
    for out in (dG, dm, dv):
        if out is not None:
            assert torch.isfinite(out).all()
            assert torch.equal(out[rows:], torch.zeros(PAD, 128))

    ins = [_t(x).requires_grad_() if x is not None else None
           for x in (G, m, v, SCAL)]
    outs = R.update_ref(ins[0], _t(G), ins[1], ins[2], ins[3], **hp)
    cts = [c for c in (dpn, dmn, dvn) if c is not None]
    obj = sum(torch.sum(o * _t(c)) for o, c in zip(outs, cts))
    named = [(n, x) for n, x in zip(("G", "m", "v", "scal"), ins)
             if x is not None]
    auto = dict(zip([n for n, _ in named],
                    torch.autograd.grad(obj, [x for _, x in named])))
    assert rel_err(dG[:rows], auto["G"]) <= TOL_GRAD
    if dm is not None:
        assert rel_err(dm[:rows], auto["m"]) <= TOL_GRAD
    if dv is not None:
        assert rel_err(dv[:rows], auto["v"]) <= TOL_GRAD
    for i in range(4):
        assert rel_err(dscal[i], auto["scal"][i]) <= TOL_GRAD, i


def test_accumulate_and_aggregate_bwd_plain_match_autograd():
    rng = np.random.default_rng(3)
    g, dG = _randn(rng, 3, 16, 128), _randn(rng, 16, 128)
    w = torch.tensor([0.2, 0.3, 0.5], requires_grad=True)
    gt = _t(g).requires_grad_()
    G, ssq = R.aggregate_ref(gt, w)
    obj = torch.sum(G * _t(dG)) + 0.3 * ssq
    ag, aw = torch.autograd.grad(obj, (gt, w))
    dg, dw = R.aggregate_bwd_ref(_t(g), w.detach(), G.detach(), _t(dG),
                                 torch.tensor(0.3))
    assert rel_err(dg, ag) <= TOL and rel_err(dw, aw) <= TOL_SUM

    acc = torch.zeros(16, 128, requires_grad=True)
    g0 = _t(g[0]).requires_grad_()
    w0 = torch.tensor(0.4, requires_grad=True)
    out = R.accumulate_ref(acc, g0, w0)
    dacc, ag, aw = torch.autograd.grad(torch.sum(out * _t(dG)),
                                       (acc, g0, w0))
    dg, dw = R.accumulate_bwd_ref(_t(g[0]), torch.tensor(0.4), _t(dG))
    assert torch.equal(dacc, _t(dG))
    assert rel_err(dg, ag) <= TOL and rel_err(dw, aw) <= TOL_SUM


# ---------------------------------------------------------------------------
# Autograd through the port's fused ops against jax.grad through JAX's
# ---------------------------------------------------------------------------
COHORT = 5
SHAPES = {"b": (5,), "w1": (10, 16), "w2": (16, 4)}


def _problem(seed):
    rng = np.random.default_rng(seed)
    params = {k: _randn(rng, *s, scale=0.3) for k, s in SHAPES.items()}
    grads = {k: _randn(rng, COHORT, *s) for k, s in SHAPES.items()}
    coeff = {slot: {k: _randn(rng, *s) for k, s in SHAPES.items()}
             for slot in ("p", "m", "v")}
    m = {k: _randn(rng, *s, scale=0.3) for k, s in SHAPES.items()}
    v = {k: (0.1 + np.abs(_randn(rng, *s))).astype(np.float32)
         for k, s in SHAPES.items()}
    return params, grads, coeff, m, v


def _objectives(opt, clip, params, coeff, m, v):
    """The same objective in both packages: <p', c_p> + 0.3 ||G'|| +
    <m', c_m> + <v', c_v>, so every output cotangent is live."""
    def torch_obj(p, g, w, lr):
        spec = TF.make_flat_spec(p)
        st = O.init_flat_opt_state(opt, spec)
        if "m" in st:
            st["m"] = tuple(TF.flatten_tree(spec, {k: _t(x) for k, x
                                                   in m.items()}))
        if "v" in st:
            st["v"] = tuple(TF.flatten_tree(spec, {k: _t(x) for k, x
                                                   in v.items()}))
            st["t"] = torch.tensor(5, dtype=torch.int32)
        newp, newst, gn = O.fused_server_update(
            p, g, w, st, opt=opt, lr=lr, clip_norm=clip, momentum=0.9)
        obj = sum(torch.sum(newp[k] * _t(coeff["p"][k])) for k in newp)
        obj = obj + 0.3 * gn
        for slot in ("m", "v"):
            if slot in newst:
                c = TF.flatten_tree(spec, {k: _t(x) for k, x
                                           in coeff[slot].items()})
                obj = obj + torch.sum(newst[slot][0] * c[0])
        return obj

    def jax_obj(p, g, w, lr):
        spec = JF.make_flat_spec(p)
        st = JO.init_flat_opt_state(opt, spec)
        if "m" in st:
            st["m"] = tuple(JF.flatten_tree(spec, m))
        if "v" in st:
            st["v"] = tuple(JF.flatten_tree(spec, v))
            st["t"] = jnp.asarray(5, jnp.int32)
        newp, newst, gn = JO.fused_server_update(
            p, g, w, st, opt=opt, lr=lr, clip_norm=clip, momentum=0.9)
        obj = sum(jnp.sum(newp[k] * coeff["p"][k]) for k in newp)
        obj = obj + 0.3 * gn
        for slot in ("m", "v"):
            if slot in newst:
                c = JF.flatten_tree(spec, coeff[slot])
                obj = obj + jnp.sum(newst[slot][0] * c[0])
        return obj

    return torch_obj, jax_obj


@pytest.mark.parametrize("clip", [0.0, 0.5])
@pytest.mark.parametrize("opt", OPTS)
def test_grad_through_fused_server_update_matches_jax(opt, clip):
    """d objective / d (stacked gradients, client weights, lr)."""
    params, grads, coeff, m, v = _problem(11)
    wts = np.array([1.0, 2.0, 3.0, 4.0, 5.0], np.float32)
    lr = 0.07
    torch_obj, jax_obj = _objectives(opt, clip, params, coeff, m, v)
    tg = {k: _t(x).requires_grad_() for k, x in grads.items()}
    tw = _t(wts).requires_grad_()
    tlr = torch.tensor(lr, requires_grad=True)
    obj = torch_obj({k: _t(x) for k, x in params.items()}, tg, tw, tlr)
    got = torch.autograd.grad(obj, [*tg.values(), tw, tlr])
    want_g, want_w, want_lr = jax.grad(jax_obj, argnums=(1, 2, 3))(
        {k: _j(x) for k, x in params.items()},
        {k: _j(x) for k, x in grads.items()}, _j(wts), jnp.float32(lr))
    for a, k in zip(got, tg):
        assert rel_err(a, want_g[k]) <= TOL_GRAD, k
    assert rel_err(got[-2], want_w) <= TOL_GRAD
    assert rel_err(got[-1], want_lr) <= TOL_GRAD


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_grad_wrt_params_through_fused_matches_jax(opt):
    """Cotangents reach the parameters too (dp = dp')."""
    params, grads, coeff, m, v = _problem(12)
    wts = np.array([1.0, 1.0, 2.0, 3.0, 1.0], np.float32)
    torch_obj, jax_obj = _objectives(opt, 0.5, params, coeff, m, v)
    tp = {k: _t(x).requires_grad_() for k, x in params.items()}
    obj = torch_obj(tp, {k: _t(x) for k, x in grads.items()}, _t(wts), 0.05)
    got = torch.autograd.grad(obj, list(tp.values()))
    want = jax.grad(jax_obj)({k: _j(x) for k, x in params.items()},
                             {k: _j(x) for k, x in grads.items()}, _j(wts),
                             0.05)
    for a, k in zip(got, tp):
        assert rel_err(a, want[k]) <= TOL_GRAD, k


def test_accumulate_op_is_differentiable_and_out_refuses_grad():
    rng = np.random.default_rng(5)
    acc, g, d = (_t(_randn(rng, 8, 128)) for _ in range(3))
    w = torch.tensor([0.6], requires_grad=True)
    gg = g.clone().requires_grad_()
    out = O.flat_accumulate(acc, gg, w)
    dg, dw = torch.autograd.grad(torch.sum(out * d), (gg, w))
    rdg, rdw = R.accumulate_bwd_ref(g, torch.tensor(0.6), d)
    assert torch.equal(dg, rdg) and torch.equal(dw, rdw.reshape(1))
    with pytest.raises(ValueError, match="not differentiable"):
        O.flat_accumulate(acc, gg, w, out=acc)


def test_post_mode_records_no_graph():
    """Nothing requires grad: the Functions return plain tensors and keep
    no residuals, as in meta_mode='post'."""
    params, grads, _, _, _ = _problem(13)
    p = {k: _t(x) for k, x in params.items()}
    st = O.init_flat_opt_state("adam", TF.make_flat_spec(p))
    newp, newst, gn = O.fused_server_update(
        p, {k: _t(x) for k, x in grads.items()}, torch.ones(COHORT), st,
        opt="adam", lr=0.1)
    for t in (*newp.values(), *newst["m"], *newst["v"], gn):
        assert not t.requires_grad and t.grad_fn is None


def test_backward_wrappers_check_their_inputs():
    x = torch.zeros(8, 128)
    with pytest.raises(ValueError):
        K.accumulate_pass_bwd(x, torch.ones(2), x)
    with pytest.raises(ValueError):
        K.aggregate_pass_bwd(torch.zeros(2, 8, 128), torch.ones(2),
                             torch.zeros(16, 128), x, torch.tensor(0.0))
    with pytest.raises(ValueError, match="d_new_m"):
        K.update_pass_bwd(x, x, None, torch.ones(4), x, None, None,
                          opt="sgdm")
    with pytest.raises(ValueError, match="not expected"):
        K.update_pass_bwd(x, None, None, torch.ones(4), x, x, None,
                          opt="sgd")
    before = dict(K.launch_counts())
    K.update_pass_bwd(x, None, None, torch.ones(4), x, None, None, opt="sgd")
    assert K.launch_counts() == before          # the plain path: no launch


def test_new_params_own_their_storage():
    """The update's new parameters become the next round's w_t: each leaf
    must own its storage, not be a view of the flat output buffer
    (``torch.func`` allocates model-sized buffers per leaf that shares
    one storage).  With and without grad."""
    params, _, coeff, _, _ = _problem(14)
    G = np.concatenate([v.reshape(-1) for v in coeff["p"].values()])
    for needs_grad in (False, True):
        p = {k: _t(x) for k, x in params.items()}
        spec = TF.make_flat_spec(p)
        buf = TF.zeros_flat(spec)[0]
        buf.view(-1)[:G.size] = _t(G)
        lr = torch.tensor(0.1, requires_grad=needs_grad)
        newp, _, _ = O.flat_apply_groups(spec, [buf], torch.tensor(1.0), p,
                                         {}, opt="sgd", lr=lr)
        for k, t in newp.items():
            assert t._base is None, k
            assert t.untyped_storage().nbytes() == t.numel() * 4, k
            assert t.requires_grad == needs_grad
