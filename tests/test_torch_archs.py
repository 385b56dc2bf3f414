"""The port's five newer configurations against the JAX package's, at smoke
size: the dense minicpm-2b, phi3-mini-3.8b (head dim 96) and
phi3-medium-14b (GQA 8/2), and the MoE deepseek-v2-lite-16b (MLA: the
prefill attends at Dk 96, Dv 64 here, 192 / 128 at full width) and
llama4-scout-17b-a16e (top-1 with a shared expert).  Parameters come from
the JAX init through the bridge; tokens are made with numpy from a seed.

For the MoE configs every comparison first asserts that both packages
route alike (the same experts and kept entries in every layer), since a
flipped expert is an O(1) change in that token's output; values are
compared after.  Tolerances, max |a-b| over max |b|: loss and its
metrics, prefill logits and cache, and four teacher-forced decode steps
1e-5 (the same fp32 model summed in another order; measured about 2e-6);
one UGA client update: the parameters after the step 1e-5 and the
pseudo-gradient 1e-4 (the suite's gradient tolerance, as in
``test_torch_client.py``).  Full width is checked from shapes alone: the
port's module on the ``meta`` device against ``jax.eval_shape`` of the
JAX init and ``ArchConfig.param_count()``."""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_same_routing, jax_params_to_torch,
                           max_tree_rel_err, rel_err, routes_jax, routes_port)
from repro.configs import get_arch as jax_get_arch
from repro.core import client as JC
from repro.models.model import build_model as jax_build_model
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.core import client as TC
from repro_torch.launch import serve
from repro_torch.models.model import build_model
from repro_torch.models.transformer import Transformer, period_of

NEW = ["minicpm-2b", "phi3-mini-3.8b", "phi3-medium-14b",
       "deepseek-v2-lite-16b", "llama4-scout-17b-a16e"]
SMOKE = [f"{a}-smoke" for a in NEW]
MOE = [a for a in SMOKE if get_arch(a).moe is not None]
B, P = 2, 24
TOL = 1e-5


@pytest.fixture(scope="module", params=SMOKE)
def arch(request):
    name = request.param
    jm = jax_build_model(jax_get_arch(name), dtype=jnp.float32,
                         loss_chunk=16)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(1))
    toks = np.random.default_rng(len(name)).integers(
        0, 512, (B, P + 5)).astype(np.int32)
    return dict(name=name, jm=jm, jp=jp, toks=toks,
                tm=build_model(get_arch(name), loss_chunk=16),
                tp=jax_params_to_torch(jp))


def test_loss_and_metrics_match_jax(arch, monkeypatch):
    """Loss = xent + aux (the MoE load-balance loss summed over layers),
    chunked over the sequence with a ragged last chunk (P = 24 inputs in
    chunks of 16)."""
    toks = arch["toks"][:, :P + 1]
    moe = arch["name"] in MOE
    (jl, jmet), jrecs = routes_jax(lambda: jax.jit(arch["jm"].loss)(
        arch["jp"], {"tokens": jnp.asarray(toks)}))
    (tl, tmet), trecs = routes_port(lambda: arch["tm"].loss(
        arch["tp"], {"tokens": torch.from_numpy(toks).long()}), monkeypatch)
    if moe:
        assert_same_routing(jrecs, trecs)
        assert float(tmet["aux"]) > 0
    else:
        assert not jrecs and not trecs and float(tmet["aux"]) == 0.0
    assert rel_err(tl, np.asarray(jl)) <= TOL
    for k in ("xent", "aux"):
        assert rel_err(tmet[k], np.asarray(jmet[k])) <= TOL, k
    assert float(tmet["acc"]) == pytest.approx(float(jmet["acc"]), abs=1e-6)


def test_uga_client_update_matches_jax(arch, monkeypatch):
    """One UGA client update (two local steps, jvp-of-grad through the MoE
    and MLA in the port), routing on the first local batch asserted equal
    first."""
    toks = arch["toks"][:, :17]
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(
        toks).long()}
    if arch["name"] in MOE:
        _, jrecs = routes_jax(lambda: jax.jit(arch["jm"].loss)(
            arch["jp"], jb))
        _, trecs = routes_port(lambda: arch["tm"].loss(arch["tp"], tb),
                                monkeypatch)
        assert_same_routing(jrecs, trecs)
    lr = 0.05
    g, l = TC.uga_update(arch["tm"].loss, arch["tp"], tb, lr, local_steps=2,
                         local_epochs=1)
    jg, jl = jax.jit(partial(JC.uga_update, arch["jm"].loss, local_steps=2,
                             local_epochs=1))(arch["jp"], jb, lr)
    jg = jax_params_to_torch(jg)
    tp = arch["tp"]
    assert max_tree_rel_err({k: tp[k] - lr * g[k] for k in tp},
                            {k: tp[k] - lr * jg[k] for k in tp}) <= TOL
    assert max_tree_rel_err(g, jg) <= 1e-4
    assert abs(float(l) - float(jl)) <= TOL * abs(float(jl))


def test_prefill_cache_and_decode_match_jax(arch, monkeypatch):
    """Prefill logits and every cache entry (k / v, or MLA's latent ckv /
    krope), then four decode steps fed the same tokens, against JAX."""
    jm, tm, toks = arch["jm"], arch["tm"], arch["toks"]
    cache_len = P + 5
    (jlog, jc), jrecs = routes_jax(lambda: jax.jit(
        lambda p, b: jm.prefill(p, b, cache_len=cache_len))(
            arch["jp"], {"tokens": jnp.asarray(toks[:, :P])}))
    (tlog, tc), trecs = routes_port(lambda: tm.prefill(
        arch["tp"], {"tokens": torch.from_numpy(toks[:, :P]).long()},
        cache_len=cache_len), monkeypatch)
    if arch["name"] in MOE:
        assert_same_routing(jrecs, trecs)
    assert rel_err(tlog, np.asarray(jlog)) <= TOL
    assert len(tc["layers"]) == len(jc["layers"])
    for entry, jentry in zip(tc["layers"], jc["layers"]):
        assert sorted(entry) == sorted(jentry)
        for k in jentry:
            assert entry[k].shape == jentry[k].shape, k
            assert rel_err(entry[k], np.asarray(jentry[k])) <= TOL, k
    decode = jax.jit(jm.decode)
    for i in range(4):
        tok = toks[:, P + i]
        jd, jc = decode(arch["jp"], jnp.asarray(tok), jc)
        td, tc = tm.decode(arch["tp"], torch.from_numpy(tok).long(), tc)
        assert rel_err(td, np.asarray(jd)) <= TOL, i
    assert int(tc["index"]) == int(jc["index"]) == P + 4


@pytest.mark.parametrize("name", MOE)
def test_dropless_decode_after_prefill_equals_longer_prefill(name):
    """As JAX's ``test_smoke_prefill_decode_consistency``: with a dropless
    capacity (8 >= E / K) the decode of token S after prefill(S) equals
    the last logits of prefill(S + 1), atol 2e-4 + rtol 1e-3; at the
    config's capacity the two prefills drop differently."""
    cfg = get_arch(name)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=8.0))
    tm = build_model(cfg)
    tp = jax_params_to_torch(jax_build_model(
        jax_get_arch(name), dtype=jnp.float32).init(jax.random.PRNGKey(4)))
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, 512,
                                                              (2, 17)))
    _, cache = tm.prefill(tp, {"tokens": toks[:, :16]}, cache_len=20)
    dec, _ = tm.decode(tp, toks[:, 16], cache)
    full, _ = tm.prefill(tp, {"tokens": toks})
    np.testing.assert_allclose(dec.numpy(), full.numpy(), atol=2e-4,
                               rtol=1e-3)


@pytest.mark.parametrize("name", NEW)
def test_full_width_layout_and_count_match_jax(name):
    """At full width from shapes alone (the port's module on the meta
    device, JAX's init through ``jax.eval_shape``): the same leaves and
    shapes, and ``param_count()`` (which leaves out the final norm's
    d_model scales) equal in both packages and to the leaves' sum."""
    cfg, jcfg = get_arch(name), jax_get_arch(name)
    jshape = jax.eval_shape(jax_build_model(jcfg, dtype=jnp.float32).init,
                            jax.random.PRNGKey(0))
    leaves = {k: tuple(v.shape) for k, v in
              Transformer(cfg).named_parameters()}
    assert all(v.is_meta for v in Transformer(cfg).parameters())
    jleaves = {}
    bridge._walk(jshape, "", jleaves)
    assert leaves == {k: tuple(v.shape) for k, v in jleaves.items()}
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    assert sum(int(np.prod(s)) for s in leaves.values()) == \
        cfg.param_count() + cfg.d_model


def test_moe_every_second_layer_builds_jaxs_pattern(monkeypatch):
    """``moe.every = 2``: a period of two, layer 0 dense and layer 1 MoE,
    each position its own stacked block, as JAX's ``period_of`` lays it
    out; loss and routing against JAX."""
    name = "llama4-scout-17b-a16e-smoke"
    cfg = get_arch(name)
    cfg = dataclasses.replace(cfg, num_layers=4, moe=dataclasses.replace(
        cfg.moe, every=2))
    jcfg = jax_get_arch(name)
    jcfg = dataclasses.replace(jcfg, num_layers=4, moe=dataclasses.replace(
        jcfg.moe, every=2))
    assert period_of(cfg) == 2
    jm = jax_build_model(jcfg, dtype=jnp.float32)
    jp = jm.init(jax.random.PRNGKey(6))
    tp = jax_params_to_torch(jp)
    tm = build_model(cfg)
    assert list(tm.init(torch.Generator().manual_seed(0))) == list(tp)
    assert "blocks.0.mlp.w_gate" in tp and "blocks.1.mlp.router" in tp
    assert tp["blocks.1.mlp.router"].shape[0] == 2
    toks = np.random.default_rng(6).integers(0, 512, (2, 13)).astype(
        np.int32)
    (jl, _), jrecs = routes_jax(lambda: jax.jit(jm.loss)(
        jp, {"tokens": jnp.asarray(toks)}))
    (tl, _), trecs = routes_port(lambda: tm.loss(
        tp, {"tokens": torch.from_numpy(toks).long()}), monkeypatch)
    assert_same_routing(jrecs, trecs)
    assert len(trecs) == 2
    assert rel_err(tl, np.asarray(jl)) <= TOL


@pytest.mark.parametrize("name", SMOKE)
def test_make_cache_matches_jax(name):
    jc = jax_build_model(jax_get_arch(name), dtype=jnp.float32).make_cache(
        3, 24)
    tc = build_model(get_arch(name)).make_cache(3, 24)
    assert [{k: tuple(v.shape) for k, v in e.items()} for e in tc["layers"]] \
        == [{k: tuple(v.shape) for k, v in e.items()} for e in jc["layers"]]
    assert all(not t.any() for e in tc["layers"] for t in e.values())


def test_mla_cache_bridge_round_trip():
    name = "deepseek-v2-lite-16b-smoke"
    jm = jax_build_model(jax_get_arch(name), dtype=jnp.float32)
    jp = jm.init(jax.random.PRNGKey(2))
    toks = jnp.asarray(np.random.default_rng(2).integers(0, 512, (2, 9)))
    _, jc = jm.prefill(jp, {"tokens": toks}, cache_len=12)
    jc = jax.tree.map(np.asarray, jc)
    back = bridge.cache_to_numpy(bridge.cache_to_torch(jc))
    (a,), (b,) = back["layers"], jc["layers"]
    assert sorted(a) == ["ckv", "krope"]
    assert all(np.array_equal(a[k], b[k]) for k in b)


@pytest.mark.parametrize("window", [0, 16])
@pytest.mark.parametrize("name", SMOKE)
def test_serve_cli_runs_on_cpu(name, window, capsys):
    """Every new name through ``serve.main``, with and without ``--window``
    (a ring buffer for GQA; MLA's latent cache is written at the clamped
    index, as JAX writes it)."""
    toks, stats = serve.main(["--arch", name, "--batch", "2", "--prompt-len",
                              "20", "--gen", "4", "--window", str(window),
                              "--device", "cpu"])
    assert toks.shape == (2, 4) and stats["decode_s"] > 0
    assert "[serve] generated (2, 4) tokens" in capsys.readouterr().out

