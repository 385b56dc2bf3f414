"""The port's MoE FFN and MLA attention against the JAX package's, module
by module, on parameters from the JAX initializers and inputs made with
numpy from a seed.

Routing first: top-k over router probabilities turns an ulp of difference
into another expert, an O(1) change in that token's output, so each case
asserts that both packages pick the same experts and keep the same
(token, k) entries before it compares values.  Tolerances, max |a-b| over
max |b|: ``moe_ffn`` 1e-6 against both of JAX's dispatch forms (the same
fp32 products summed in another order); its gradients 1e-5; MLA's
prefill attention and absorbed decode 1e-5 (a softmax over a few dozen
keys, and the decode's latent-space products in another order)."""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import rel_err
from repro.configs.base import MoEConfig as JaxMoEConfig
from repro.models import attention as JA
from repro.models import moe as JM
from repro_torch.configs.base import MoEConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import attention as TA
from repro_torch.models import moe as TM

D, DFF = 32, 16
CASES = {
    # 48 tokens in 3 groups of 16, capacity ceil(2 * 16 / 8 * 1.25) = 5
    "drops": (dict(num_experts=8, top_k=2, num_shared=1,
                   group_size=16), (2, 24)),
    "dropless": (dict(num_experts=8, top_k=2, num_shared=1, group_size=16,
                      capacity_factor=8.0), (2, 24)),
    # (B, 1, d): every token its own group, capacity 1, nothing dropped
    "decode": (dict(num_experts=8, top_k=2, num_shared=1), (5, 1)),
    # llama4's top-1 with a shared expert; 40 tokens padded to 2 groups
    "top1_padded": (dict(num_experts=4, top_k=1, num_shared=1,
                         group_size=32), (2, 20)),
    "no_shared": (dict(num_experts=4, top_k=2, num_shared=0,
                       group_size=16, d_expert=24), (3, 8)),
}


def _tree_to_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _case(name):
    kw, (B, S) = CASES[name]
    jcfg, tcfg = JaxMoEConfig(**kw), MoEConfig(**kw)
    jp = JM.moe_init(jax.random.PRNGKey(len(name)), D, jcfg, DFF)
    x = np.random.default_rng(len(name)).standard_normal(
        (B, S, D), dtype=np.float32)
    return jcfg, tcfg, jp, _tree_to_torch(jp), x


@pytest.mark.parametrize("name", list(CASES))
def test_moe_ffn_matches_jax_gather_and_einsum(name):
    jcfg, tcfg, jp, tp, x = _case(name)
    # routing first: the same experts and the same kept entries
    jidx, jpos, jkeep = jax.jit(lambda xx, p: JM._route(
        JM._group(xx, jcfg)[0], p, jcfg)[1:4])(jnp.asarray(x), jp)
    txg, _, _ = TM._group(torch.from_numpy(x), tcfg)
    _, tidx, tpos, tkeep, _, _ = TM._route(txg, tp, tcfg)
    flips = int((tidx.numpy() != np.asarray(jidx)).sum())
    assert flips == 0, f"{flips} routing decisions differ"
    assert np.array_equal(tkeep.numpy(), np.asarray(jkeep))
    assert np.array_equal(tpos.numpy(), np.asarray(jpos))
    kept = tkeep.numpy()
    if name == "drops":
        assert not kept.all()                  # capacity really drops
    elif name in ("dropless", "decode"):
        assert kept.all()
    y, aux = TM.moe_ffn(torch.from_numpy(x), tp, tcfg)
    ye, auxe = TM.moe_ffn_einsum(torch.from_numpy(x), tp, tcfg)
    assert y.shape == x.shape
    for ref in (JM.moe_ffn_gather, JM.moe_ffn_einsum):
        jy, jaux = jax.jit(partial(ref, cfg=jcfg))(jnp.asarray(x), jp)
        assert rel_err(y, np.asarray(jy)) <= 1e-6, ref.__name__
        assert rel_err(ye, np.asarray(jy)) <= 1e-6, ref.__name__
        assert rel_err(aux, np.asarray(jaux)) <= 1e-6
        assert rel_err(auxe, np.asarray(jaux)) <= 1e-6


@pytest.mark.parametrize("name", ["drops", "no_shared"])
def test_moe_ffn_gradients_match_jax(name):
    """Gradients of a weighted sum of the output plus the aux loss, with
    respect to the input and every leaf (the router's reach it through the
    combine weights).  Top-2 cases: under top-1 the renormalized gate is
    p / p = 1, and the router's gradient through it is rounding noise."""
    jcfg, tcfg, jp, tp, x = _case(name)
    w = np.random.default_rng(7).standard_normal(x.shape, dtype=np.float32)

    def jloss(p, xx):
        y, aux = JM.moe_ffn_gather(xx, p, jcfg)
        return jnp.sum(y * w) + aux

    def tloss(p, xx):
        y, aux = TM.moe_ffn(xx, p, tcfg)
        return torch.sum(y * torch.from_numpy(w)) + aux

    jg = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    tg = torch.func.grad(tloss, argnums=(0, 1))(tp, torch.from_numpy(x))
    assert rel_err(tg[1], np.asarray(jg[1])) <= 1e-5
    jleaves = jax.tree_util.tree_leaves_with_path(jg[0])
    assert len(jleaves) == len(jax.tree.leaves(tg[0]))
    for path, leaf in jleaves:
        node = tg[0]
        for k in path:
            node = node[k.key]
        assert rel_err(node, np.asarray(leaf)) <= 1e-5, path


def test_group_rule_decode_step_is_its_own_group():
    cfg = MoEConfig(num_experts=4, top_k=2, group_size=16)
    xg, T, pad = TM._group(torch.zeros((6, 1, D)), cfg)
    assert xg.shape == (6, 1, D) and (T, pad) == (6, 0)
    xg, T, pad = TM._group(torch.zeros((2, 20, D)), cfg)
    assert xg.shape == (3, 16, D) and (T, pad) == (40, 8)
    xg, T, pad = TM._group(torch.zeros((1, 5, D)), cfg)
    assert xg.shape == (1, 5, D) and (T, pad) == (5, 0)


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------
H, HD, R, RD, THETA = 4, 16, 24, 8, 10_000.0
MLA_KW = dict(num_heads=H, head_dim=HD, rope_head_dim=RD, rope_theta=THETA)


@pytest.fixture(scope="module")
def mla():
    jp = JA.mla_init(jax.random.PRNGKey(5), D, H, HD, R, RD)
    return jp, _tree_to_torch(jp)


def _positions(B, S):
    return np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()


@pytest.mark.parametrize("S", [9, 33])
def test_mla_prefill_attention_matches_jax(mla, S):
    """Training (``attend``) and the prefill (the flash op at Dk =
    head_dim + rope_head_dim, Dv = head_dim, its plain version here)
    against JAX's ``mla_attention``; the latent cache against JAX's."""
    jp, tp = mla
    x = np.random.default_rng(S).standard_normal((2, S, D), dtype=np.float32)
    pos = _positions(2, S)
    ref = np.asarray(jax.jit(partial(JA.mla_attention, **MLA_KW))(
        jnp.asarray(x), jp, jnp.asarray(pos)))
    tx, tpos = torch.from_numpy(x), torch.from_numpy(pos)
    for attn_fn in (None, lambda q, k, v: flash_attention(q, k, v)):
        out, ckv, krope = TA.mla_attention(tx, tp, tpos, attn_fn=attn_fn,
                                           **MLA_KW)
        assert rel_err(out, ref) <= 1e-5
    assert rel_err(ckv, np.asarray(jnp.asarray(x) @ jp["w_dkv"])) <= 1e-6
    jkr = JA.apply_rope_1h(jnp.asarray(x) @ jp["w_kr"], jnp.asarray(pos),
                           THETA)
    assert rel_err(krope, np.asarray(jkr)) <= 1e-6


@pytest.mark.parametrize("index", [0, 7, 15])
def test_mla_absorbed_decode_matches_jax(mla, index):
    """One token against a (B, 16, r) / (B, 16, rd) latent cache: the
    output, and the cache written in place where JAX returns a new one."""
    jp, tp = mla
    rng = np.random.default_rng(index)
    x = rng.standard_normal((3, D), dtype=np.float32)
    ckv = rng.standard_normal((3, 16, R), dtype=np.float32)
    krope = rng.standard_normal((3, 16, RD), dtype=np.float32)
    jout, jckv, jkr = jax.jit(partial(JA.mla_decode_absorbed, **MLA_KW))(
        jnp.asarray(x), jp, jnp.asarray(ckv), jnp.asarray(krope),
        jnp.asarray(index, jnp.int32))
    tckv, tkr = torch.from_numpy(ckv.copy()), torch.from_numpy(krope.copy())
    out = TA.mla_decode_absorbed(torch.from_numpy(x), tp, tckv, tkr,
                                 torch.tensor(index, dtype=torch.int32),
                                 **MLA_KW)
    assert rel_err(out, np.asarray(jout)) <= 1e-5
    assert rel_err(tckv, np.asarray(jckv)) <= 1e-6
    assert rel_err(tkr, np.asarray(jkr)) <= 1e-6


def test_mla_absorbed_decode_equals_expanded_attention(mla):
    """Within the port: decoding token S against the latent cache of a
    prefill of S tokens gives the expanded attention's row S."""
    _, tp = mla
    S = 12
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, S + 1, D), dtype=np.float32))
    pos = torch.from_numpy(_positions(2, S + 1))
    full, ckv, krope = TA.mla_attention(x, tp, pos, **MLA_KW)
    pad = lambda t: torch.nn.functional.pad(t[:, :S], [0, 0, 0, 4])
    ckv_c, kr_c = pad(ckv), pad(krope)
    out = TA.mla_decode_absorbed(x[:, S], tp, ckv_c, kr_c,
                                 torch.tensor(S, dtype=torch.int32), **MLA_KW)
    assert rel_err(out, full[:, S]) <= 1e-5
    assert torch.allclose(ckv_c[:, S], ckv[:, S], atol=1e-6)


def test_moe_config_fields_mirror_jax():
    assert [(f.name, f.default) for f in dataclasses.fields(MoEConfig)] == \
        [(f.name, f.default) for f in dataclasses.fields(JaxMoEConfig)]
