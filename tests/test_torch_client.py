"""Client updates of the port: the HVP form of UGA (jvp-of-grad) equals the
double-backward oracle to <= 1e-5, and both equal the JAX ``uga_update``
to <= 1e-4 (max |a-b| over max |b| per leaf); FedAvg/FedProx and the
FedMeta step match the JAX ones."""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import SMOKE, jax_params_to_torch, max_tree_rel_err
from repro.configs import get_arch as jax_get_arch
from repro.core import client as JC
from repro.core.meta import meta_update as jax_meta_update
from repro.models.model import build_model as jax_build_model
from repro_torch.configs import get_arch
from repro_torch.core import client as TC
from repro_torch.core.meta import meta_update
from repro_torch.models.model import build_model


@pytest.fixture(scope="module")
def setup():
    jm = jax_build_model(jax_get_arch(SMOKE), dtype=jnp.float32,
                         loss_chunk=256)
    jp = jm.init(jax.random.PRNGKey(2))
    tm = build_model(get_arch(SMOKE), loss_chunk=256)
    toks = np.random.default_rng(4).integers(0, 512, (4, 33)).astype(
        np.int32)
    return (jm, jp, {"tokens": jnp.asarray(toks)},
            tm, jax_params_to_torch(jp), {"tokens": torch.from_numpy(toks)
                                         .long()})


@pytest.mark.parametrize("steps,epochs", [(2, 1), (2, 2)])
def test_uga_hvp_equals_autodiff_and_jax(setup, steps, epochs):
    jm, jp, jb, tm, tp, tb = setup
    lr = 0.05
    g, l = TC.uga_update(tm.loss, tp, tb, lr, local_steps=steps,
                         local_epochs=epochs)
    g_ad, l_ad = TC.uga_update_autodiff(tm.loss, tp, tb, lr,
                                        local_steps=steps,
                                        local_epochs=epochs)
    assert max_tree_rel_err(g, g_ad) <= 1e-5
    assert abs(float(l) - float(l_ad)) <= 1e-5 * abs(float(l_ad))
    jg, jl = jax.jit(partial(JC.uga_update, jm.loss, local_steps=steps,
                             local_epochs=epochs))(jp, jb, lr)
    jg = jax_params_to_torch(jg)
    assert max_tree_rel_err(g, jg) <= 1e-4
    assert max_tree_rel_err(g_ad, jg) <= 1e-4
    assert abs(float(l) - float(jl)) <= 1e-5 * abs(float(jl))


@pytest.mark.parametrize("prox_mu", [0.0, 0.5])
def test_fedavg_matches_jax(setup, prox_mu):
    jm, jp, jb, tm, tp, tb = setup
    g, l = TC.fedavg_update(tm.loss, tp, tb, 0.05, prox_mu=prox_mu)
    jg, jl = jax.jit(partial(JC.fedavg_update, jm.loss,
                             prox_mu=prox_mu))(jp, jb, 0.05)
    jg = jax_params_to_torch(jg)
    # the pseudo-gradient w_t - w_k cancels the leading digits of two
    # close parameter sets, so compare the local endpoint w_k, a parameter
    # set, at the parameter tolerance
    assert max_tree_rel_err({k: tp[k] - g[k] for k in tp},
                            {k: tp[k] - jg[k] for k in tp}) <= 1e-5
    assert abs(float(l) - float(jl)) <= 1e-5 * abs(float(jl))


def test_meta_update_matches_jax(setup):
    jm, jp, jb, tm, tp, tb = setup
    new, l = meta_update(tm.loss, tp, tb, 0.05)
    jnew, jl = jax_meta_update(jm.loss, jp, jb, 0.05)
    assert max_tree_rel_err(new, jax_params_to_torch(jnew)) <= 1e-5
    assert abs(float(l) - float(jl)) <= 1e-5 * abs(float(jl))
