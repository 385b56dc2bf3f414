"""Training through Mamba2 layers, the port against the JAX package at smoke
size: ``models/ssm.py::ssd_chunked`` (the differentiable chunked SSD scan
the loss runs) in value, reverse mode and forward mode, then one UGA client
update (a jvp-of-grad reverse sweep through it) and one fused round on
mamba2-780m-smoke (a pure SSM stack) and jamba-1.5-large-398b-smoke (the
hybrid: a mamba layer with a dense MLP, then attention with a top-2 MoE).
Inputs are made with numpy from a seed; parameters come from the JAX init
through the bridge.  On the hybrid, routing is asserted equal before any
value is compared.

Tolerances, max |a-b| over max |b| per array: ``ssd_chunked`` 1e-5 in
value and VJP (the same fp32 function in another summation order;
measured up to 1e-6), 1e-4 for the tangent of the VJP (a second
derivative through the exponential of a cumsum of hundreds; measured up to
1.1e-5).

The client update of these stacks is ill-conditioned in the embedding:
its leaf feeds both the tied head and, through the SSD's decays, every
state.  A perturbation of 2e-6 of the embedding's largest entry moves the
client gradient by more than 1e-5
(``test_client_gradient_is_sensitive_to_the_embedding``), so the fp32
rounding of the first local step, a few 1e-6 apart in the two packages,
moves the update by 2e-5 (mamba2) to 1.5e-4 (jamba) at lr 0.05.  The
update is therefore held twice: with the first local step pinned to
JAX's, so that both packages run the evaluation gradient and the
jvp-of-grad sweep from the same parameters, to the JAX suite's 1e-4 on
gradients and parameters; and as a whole to 5e-4.  One fused round (lr
0.01): metrics 1e-4, parameters 1e-4 (measured up to 4e-5; dt_bias starts
at zero, so its relative error is its update's)."""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_same_routing, jax_params_to_torch,
                           max_tree_rel_err, rel_err, routes_jax, routes_port)
from repro.configs import FedConfig as JaxFedConfig
from repro.configs import get_arch as jax_get_arch
from repro.core import FederatedTrainer as JaxTrainer
from repro.core import client as JC
from repro.launch.train import build_synthetic_fed_data as jax_fed_data
from repro.models.model import build_model as jax_build_model
from repro.models.ssm import ssd_chunked as jax_ssd_chunked
from repro_torch.configs import FedConfig, get_arch
from repro_torch.core import client as TC
from repro_torch.core.trainer import FederatedTrainer
from repro_torch.launch.train import build_synthetic_fed_data
from repro_torch.models.model import build_model
from repro_torch.models.ssm import ssd_chunked

ARCHS = ["mamba2-780m-smoke", "jamba-1.5-large-398b-smoke"]
TOL = 1e-5


def _ssd_inputs(seed, B, S, H, P, N, *, dt_shift=0.0):
    """x, dt (softplus'ed), A (the init's range, -1 to -16), Bm, Cm."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    x = f32(rng.standard_normal((B, S, H, P)))
    dt = f32(np.log1p(np.exp(rng.standard_normal((B, S, H)) + dt_shift)))
    A = f32(-np.linspace(1.0, 16.0, H))
    Bm = f32(rng.standard_normal((B, S, H, N)))
    Cm = f32(rng.standard_normal((B, S, H, N)))
    return x, dt, A, Bm, Cm


@pytest.mark.parametrize("S,chunk", [(40, 16), (32, 16), (12, 32)],
                         ids=["ragged", "whole-chunks", "one-short-chunk"])
def test_ssd_chunked_matches_jax_value_vjp_jvp(S, chunk):
    """y and h_final; the gradient of sum(y * ry) + sum(h * rh) w.r.t. all
    five inputs; and the tangent of that gradient (forward over reverse,
    UGA's Hessian-vector product) along a random direction."""
    ins = _ssd_inputs(S + chunk, 2, S, 3, 4, 5)
    rng = np.random.default_rng(1)
    ry = rng.standard_normal((2, S, 3, 4)).astype(np.float32)
    rh = rng.standard_normal((2, 3, 5, 4)).astype(np.float32)
    tans = [rng.standard_normal(a.shape).astype(np.float32) for a in ins]
    argnums = (0, 1, 2, 3, 4)

    def jf(*a):
        y, h = jax_ssd_chunked(*a, chunk)
        return jnp.sum(y * ry) + jnp.sum(h * rh)

    def tf(*a):
        y, h = ssd_chunked(*a, chunk)
        return torch.sum(y * torch.from_numpy(ry)) + torch.sum(
            h * torch.from_numpy(rh))

    J = tuple(jnp.asarray(a) for a in ins)
    T = tuple(torch.from_numpy(a) for a in ins)
    jy, jh = jax_ssd_chunked(*J, chunk)
    ty, th = ssd_chunked(*T, chunk)
    assert ty.shape == (2, S, 3, 4) and th.shape == (2, 3, 5, 4)
    assert rel_err(ty, np.asarray(jy)) <= TOL
    assert rel_err(th, np.asarray(jh)) <= TOL
    jg = jax.grad(jf, argnums=argnums)(*J)
    tg = torch.func.grad(tf, argnums=argnums)(*T)
    _, jt = jax.jvp(jax.grad(jf, argnums=argnums), J,
                    tuple(jnp.asarray(t) for t in tans))
    _, tt = torch.func.jvp(torch.func.grad(tf, argnums=argnums), T,
                           tuple(torch.from_numpy(t) for t in tans))
    for name, a, b, c, d in zip("x dt A Bm Cm".split(), tg, jg, tt, jt):
        assert rel_err(a, np.asarray(b)) <= TOL, ("vjp", name)
        assert rel_err(c, np.asarray(d)) <= 1e-4, ("jvp", name)


def test_ssd_chunked_finite_at_long_chunk_with_strong_decay():
    """A chunk of 256 at the init's decay range, dt shifted up: above the
    diagonal exp(seg) would overflow fp32 (asserted), so a mask applied
    after the exponential would make inf * 0 = NaN in every tangent and
    cotangent through it.  Value, gradient and jvp-of-grad stay finite."""
    x, dt, A, Bm, Cm = (torch.from_numpy(a) for a in _ssd_inputs(
        5, 1, 256, 2, 4, 3, dt_shift=2.0))
    acum = torch.cumsum(dt * A, dim=1)
    assert float((acum[:, 0] - acum[:, -1]).max()) > 89.0  # exp overflows

    def f(x, dt, A, Bm, Cm):
        y, h = ssd_chunked(x, dt, A, Bm, Cm, 256)
        return torch.sum(y * y) + torch.sum(h)

    y, h = ssd_chunked(x, dt, A, Bm, Cm, 256)
    g = torch.func.grad(f, argnums=(0, 1, 2, 3, 4))(x, dt, A, Bm, Cm)
    _, hv = torch.func.jvp(torch.func.grad(f, argnums=(0, 1, 2, 3, 4)),
                           (x, dt, A, Bm, Cm),
                           tuple(torch.ones_like(t) for t in
                                 (x, dt, A, Bm, Cm)))
    for t in (y, h, *g, *hv):
        assert bool(torch.isfinite(t).all())


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    name = request.param
    jm = jax_build_model(jax_get_arch(name), dtype=jnp.float32,
                         loss_chunk=16)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(1))
    toks = np.random.default_rng(3).integers(0, 512, (2, 17)).astype(
        np.int32)
    return dict(name=name, jm=jm, jp=jp, toks=toks,
                juga=jax.jit(partial(JC.uga_update, jm.loss, local_steps=2,
                                     local_epochs=1)),
                tm=build_model(get_arch(name), loss_chunk=16),
                tp=jax_params_to_torch(jp))


def test_client_gradient_is_sensitive_to_the_embedding(arch):
    """The conditioning the tolerances below rest on: a random perturbation
    of 2e-6 of the embedding's scale moves the port's gradient by more
    than 1e-5 of its scale (printed with ``-s``)."""
    tm, tp = arch["tm"], arch["tp"]
    tb = {"tokens": torch.from_numpy(arch["toks"]).long()}
    rng = np.random.default_rng(0)
    d = torch.from_numpy(rng.uniform(-1, 1, tuple(tp["embed"].shape)).astype(
        np.float32)) * float(tp["embed"].abs().max()) * 2e-6
    grad = torch.func.grad(lambda p: tm.loss(p, tb)[0])
    moved = max_tree_rel_err(grad({**tp, "embed": tp["embed"] + d}),
                             grad(tp))
    print(f"{arch['name']}: gradient moved {moved:.3e} by an embedding "
          "perturbation of 2e-6")
    assert moved > 1e-5


def _uga_vs_jax(arch, lr):
    """The port's and JAX's UGA client update (two local steps) on the
    arch's batch; returns the gradient's and the stepped parameters'
    errors."""
    jb = {"tokens": jnp.asarray(arch["toks"])}
    tb = {"tokens": torch.from_numpy(arch["toks"]).long()}
    g, l = TC.uga_update(arch["tm"].loss, arch["tp"], tb, lr, local_steps=2,
                         local_epochs=1)
    jg, jl = arch["juga"](arch["jp"], jb, lr)
    jg = jax_params_to_torch(jg)
    tp = arch["tp"]
    assert all(bool(torch.isfinite(v).all()) for v in g.values())
    assert abs(float(l) - float(jl)) <= TOL * abs(float(jl))
    return (max_tree_rel_err(g, jg),
            max_tree_rel_err({k: tp[k] - lr * g[k] for k in tp},
                             {k: tp[k] - lr * jg[k] for k in tp}))


def test_uga_update_matches_jax(arch, monkeypatch):
    """One UGA client update: local SGD, the gradient on the whole batch,
    the jvp-of-grad reverse sweep, each through ``ssd_chunked`` (and on
    the hybrid through attention and the MoE, routing on the batch
    asserted equal first).  First with the first local step pinned to
    JAX's (its parameters bridged in place of the port's SGD step), then
    as a whole."""
    if get_arch(arch["name"]).moe is not None:
        jb = {"tokens": jnp.asarray(arch["toks"])}
        tb = {"tokens": torch.from_numpy(arch["toks"]).long()}
        _, jrecs = routes_jax(lambda: jax.jit(arch["jm"].loss)(
            arch["jp"], jb))
        _, trecs = routes_port(lambda: arch["tm"].loss(arch["tp"], tb),
                               monkeypatch)
        assert_same_routing(jrecs, trecs)
    lr = 0.05
    jmb = {"tokens": jnp.asarray(arch["toks"][:1])}
    jg0 = jax.grad(lambda p: arch["jm"].loss(p, jmb)[0])(arch["jp"])
    jw1 = jax_params_to_torch(jax.tree.map(lambda a, b: a - lr * b,
                                           arch["jp"], jg0))
    with monkeypatch.context() as m:
        m.setattr(TC, "_sgd", lambda w, g, lr: jw1)
        g_err, p_err = _uga_vs_jax(arch, lr)
    print(f"{arch['name']}: first step pinned: gradient {g_err:.3e}, "
          f"parameters {p_err:.3e}")
    assert g_err <= 1e-4 and p_err <= 1e-4
    g_err, p_err = _uga_vs_jax(arch, lr)
    print(f"{arch['name']}: whole update: gradient {g_err:.3e}, "
          f"parameters {p_err:.3e}")
    assert g_err <= 5e-4 and p_err <= 5e-4


def test_one_fused_round_matches_jax(arch):
    """One round of the JAX ``FederatedTrainer`` against the port's, vmap
    cohort of 2, sgd server, UGA + FedMeta (post), the same data seed and
    bridged init."""
    name = arch["name"]
    kw = dict(algorithm="uga", meta=True, cohort=2, local_steps=2,
              client_lr=0.01, server_lr=0.01, meta_lr=0.01, server_opt="sgd",
              cohort_strategy="vmap", lr_decay=0.992, fused_update=True)
    data_kw = dict(num_clients=8, examples=64, seq=16, iid=False, seed=0)
    run_kw = dict(rounds=1, cohort=2, batch=4, meta_batch=8)
    jt = JaxTrainer(jax_build_model(jax_get_arch(name), dtype=jnp.float32,
                                    loss_chunk=256), JaxFedConfig(**kw),
                    seed=0)
    tt = FederatedTrainer(build_model(get_arch(name), loss_chunk=256),
                          FedConfig(**kw), device="cpu",
                          params=jax_params_to_torch(jt.state["params"]))
    jh = jt.run(jax_fed_data(jax_get_arch(name), **data_kw), **run_kw)
    th = tt.run(build_synthetic_fed_data(get_arch(name), **data_kw),
                **run_kw)
    assert set(th[0]) == set(jh[0])
    for k in ("client_loss", "grad_norm", "meta_loss"):
        assert abs(th[0][k] - jh[0][k]) <= 1e-4 * abs(jh[0][k]), k
    err = max_tree_rel_err(tt.state["params"],
                           jax_params_to_torch(jt.state["params"]))
    print(f"{name}: parameters after one round {err:.3e}")
    assert err <= 1e-4
