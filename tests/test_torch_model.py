"""The port's dense LM against the JAX package's, on bridged smoke
parameters: loss <= 1e-5 relative, gradients <= 1e-4 (max |a-b| over
max |b| per leaf) — the same fp32 math summed in another order."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import SMOKE, jax_params_to_torch, max_tree_rel_err, rel_err
from repro.configs import get_arch as jax_get_arch
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models.model import build_model as jax_build_model
from repro_torch.configs import get_arch
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models.model import build_model


@pytest.fixture(scope="module")
def params():
    model = jax_build_model(jax_get_arch(SMOKE), dtype=jnp.float32)
    jp = model.init(jax.random.PRNGKey(1))
    return jp, jax_params_to_torch(jp)


@pytest.mark.parametrize("chunk", [256, 8])
@pytest.mark.parametrize("seq", [32, 17])
def test_loss_and_grads_match_jax(params, seq, chunk):
    jp, tp = params
    toks = np.random.default_rng(seq).integers(
        0, 512, (4, seq + 1)).astype(np.int32)
    jm = jax_build_model(jax_get_arch(SMOKE), dtype=jnp.float32,
                         loss_chunk=chunk)
    tm = build_model(get_arch(SMOKE), loss_chunk=chunk)
    (jl, jmet), jg = jax.value_and_grad(
        lambda p: jm.loss(p, {"tokens": jnp.asarray(toks)}), has_aux=True)(jp)
    tg, (tl, tmet) = torch.func.grad_and_value(
        lambda p: tm.loss(p, {"tokens": torch.from_numpy(toks).long()}),
        has_aux=True)(tp)
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    assert float(tmet["acc"]) == pytest.approx(float(jmet["acc"]), abs=1e-6)
    assert max_tree_rel_err(tg, jax_params_to_torch(jg)) <= 1e-4


def test_rope_pairs_interleaved_lanes():
    x = np.random.default_rng(0).standard_normal((2, 6, 3, 8)).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(6, dtype=np.int32), (2, 6))
    ours = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos.copy()),
                         10_000.0)
    ref = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)
    assert rel_err(ours, ref) <= 1e-6


def test_gqa_attention_matches_jax():
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, 16, 6, 8)).astype(np.float32)
    k, v = rng.standard_normal((2, 2, 16, 2, 8)).astype(np.float32)
    ours = TA.attend(torch.from_numpy(q), torch.from_numpy(k),
                     torch.from_numpy(v), causal=True)
    ref = JA.simple_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=True)
    assert rel_err(ours, ref) <= 1e-6


def test_init_matches_jax_layout():
    """Same names, shapes and dtypes as the JAX init; values are random
    from a torch.Generator (the generators differ between frameworks)."""
    jshape = jax.eval_shape(jax_build_model(jax_get_arch(SMOKE),
                                            dtype=jnp.float32).init,
                            jax.random.PRNGKey(0))
    ref = jax_params_to_torch(jax.tree.map(
        lambda s: np.zeros(s.shape, s.dtype), jshape))
    tp = build_model(get_arch(SMOKE)).init(torch.Generator().manual_seed(0))
    assert list(tp) == list(ref)
    for k in ref:
        assert tp[k].shape == ref[k].shape and tp[k].dtype == ref[k].dtype
    assert torch.all(tp["final_norm"] == 1)
    assert 0.015 < float(tp["embed"].std()) < 0.025
