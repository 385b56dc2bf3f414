"""The port's hybrid attention/mamba stack against the JAX package's, at
smoke size: jamba-1.5-large-398b-smoke (a period of two: layer 0 a Mamba2
block with a dense SwiGLU MLP, layer 1 GQA attention with a top-2 MoE
FFN), and a deeper cut of jamba's own pattern (attention at the middle of
a period of four, MoE at odd positions, two periods), so that a mamba
layer's decode state and an attention layer's cache sit in one stacked
cache.  Parameters come from the JAX init through the bridge; tokens are
made with numpy from a seed.

Every comparison first asserts that both packages route alike (the same
experts and kept entries in every MoE call), since a flipped expert is an
O(1) change in that token's output; values are compared after.
Tolerances, max |a-b| over max |b|: prefill logits, every cache entry
and four teacher-forced decode steps 1e-5 on the smoke config (the same
fp32 model summed in another order; measured about 2e-6), 1e-4 on the
eight-layer cut, where the orders' drift grows with depth (measured up to
9e-6 in the prefill and past 1e-5 in the SSD state after four decode
steps): the JAX suite's tolerance for a round's metrics, which
``test_torch_serve.py`` holds decode to.  The loss (training runs
through ``models/ssm.py::ssd_chunked``) is held to the same tolerances;
training itself is ``test_torch_ssm_train.py``'s.  Full width is checked
from shapes alone."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_same_routing, jax_params_to_torch, rel_err,
                           routes_jax, routes_port)
from repro.configs import get_arch as jax_get_arch
from repro.models.model import build_model as jax_build_model
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.configs.base import ATTN, MAMBA
from repro_torch.launch import serve
from repro_torch.models.model import build_model
from repro_torch.models.transformer import Transformer, period_kinds

NAME = "jamba-1.5-large-398b"
SMOKE = f"{NAME}-smoke"
B, P = 2, 40                    # P = 40: a ragged last SSD chunk of 32
TOL = {"smoke": 1e-5, "deeper": 1e-4}


def _deeper(cfg):
    """jamba's own layout at smoke width: 8 layers, attention every 4th
    (position 2 of 4), MoE at odd positions."""
    return dataclasses.replace(cfg, num_layers=8, attn_period=4)


@pytest.fixture(scope="module", params=["smoke", "deeper"])
def arch(request):
    cfg, jcfg = get_arch(SMOKE), jax_get_arch(SMOKE)
    if request.param == "deeper":
        cfg, jcfg = _deeper(cfg), _deeper(jcfg)
    jm = jax_build_model(jcfg, dtype=jnp.float32)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(7))
    toks = np.random.default_rng(3).integers(0, 512, (B, P + 5)).astype(
        np.int32)
    return dict(cfg=cfg, jcfg=jcfg, jm=jm, jp=jp, toks=toks,
                tm=build_model(cfg), tp=jax_params_to_torch(jp),
                tol=TOL[request.param])


def test_period_layout_matches_jax(arch):
    """One block per position of the period, each of its own kind: the
    mamba positions with the dense MLP at even positions and the MoE at
    odd ones, the attention position likewise."""
    cfg, tp = arch["cfg"], arch["tp"]
    kinds = period_kinds(cfg)
    assert kinds == arch["jcfg"].layer_kinds()[:len(kinds)]
    assert kinds in ((MAMBA, ATTN), (MAMBA, MAMBA, ATTN, MAMBA))
    for j, kind in enumerate(kinds):
        leaf = "mamba.in_proj" if kind == MAMBA else "attn.wq"
        assert f"blocks.{j}.{leaf}" in tp and f"blocks.{j}.norm2" in tp
        assert (f"blocks.{j}.mlp.router" in tp) == (j % 2 == 1)
    init = arch["tm"].init(torch.Generator().manual_seed(0))
    assert list(init) == list(tp)
    assert all(init[k].shape == tp[k].shape for k in tp)


def test_prefill_cache_and_decode_match_jax(arch, monkeypatch):
    """Routing equal in every MoE call first; then prefill logits, the
    mamba entries' SSD state and conv window, the attention entries' k /
    v, and four decode steps fed the same tokens."""
    jm, tm, toks, tol = arch["jm"], arch["tm"], arch["toks"], arch["tol"]
    cache_len = P + 5
    (jlog, jc), jrecs = routes_jax(lambda: jax.jit(
        lambda p, b: jm.prefill(p, b, cache_len=cache_len))(
            arch["jp"], {"tokens": jnp.asarray(toks[:, :P])}))
    (tlog, tc), trecs = routes_port(lambda: tm.prefill(
        arch["tp"], {"tokens": torch.from_numpy(toks[:, :P]).long()},
        cache_len=cache_len), monkeypatch)
    assert_same_routing(jrecs, trecs)
    assert len(trecs) == arch["cfg"].num_layers // 2
    assert rel_err(tlog, np.asarray(jlog)) <= tol
    assert sorted(tc) == sorted(jc) == ["index", "layers"]
    for entry, jentry in zip(tc["layers"], jc["layers"]):
        assert sorted(entry) == sorted(jentry)
        for k in jentry:
            assert entry[k].shape == jentry[k].shape, k
            assert rel_err(entry[k], np.asarray(jentry[k])) <= tol, k
    decode = jax.jit(jm.decode)

    def steps(fn, cache):
        out = []
        for i in range(4):
            logits, cache = fn(toks[:, P + i], cache)
            out.append(logits)
        return out, cache

    (jd, jc), jrecs = routes_jax(lambda: steps(
        lambda t, c: decode(arch["jp"], jnp.asarray(t), c), jc))
    (td, tc), trecs = routes_port(lambda: steps(
        lambda t, c: tm.decode(arch["tp"], torch.from_numpy(t).long(), c),
        tc), monkeypatch)
    assert_same_routing(jrecs, trecs)
    assert len(trecs) == 4 * arch["cfg"].num_layers // 2
    for i, (a, b) in enumerate(zip(td, jd)):
        assert rel_err(a, np.asarray(b)) <= tol, i
    for entry, jentry in zip(tc["layers"], jc["layers"]):
        for k in jentry:
            assert rel_err(entry[k], np.asarray(jentry[k])) <= tol, k
    assert int(tc["index"]) == int(jc["index"]) == P + 4


def test_loss_raises_naming_item_10(arch, monkeypatch):
    """Training through mamba layers (ROADMAP Queue 1 item 10) is ported:
    the hybrid's loss runs through ``ssd_chunked`` and matches JAX's,
    routing asserted equal first."""
    toks = np.random.default_rng(7).integers(0, 512, (2, 9)).astype(
        np.int32)
    (jl, _), jrecs = routes_jax(lambda: jax.jit(arch["jm"].loss)(
        arch["jp"], {"tokens": jnp.asarray(toks)}))
    (tl, _), trecs = routes_port(lambda: arch["tm"].loss(
        arch["tp"], {"tokens": torch.from_numpy(toks).long()}), monkeypatch)
    assert_same_routing(jrecs, trecs)
    assert torch.isfinite(tl)
    assert rel_err(tl, np.asarray(jl)) <= arch["tol"]


@pytest.mark.parametrize("window", [0, 16])
def test_make_cache_matches_jax(window):
    jc = jax_build_model(jax_get_arch(SMOKE), dtype=jnp.float32,
                         decode_window=window).make_cache(3, 24)
    tc = build_model(get_arch(SMOKE), decode_window=window).make_cache(3, 24)
    assert [{k: tuple(v.shape) for k, v in e.items()} for e in tc["layers"]] \
        == [{k: tuple(v.shape) for k, v in e.items()} for e in jc["layers"]]
    assert all(not t.any() for e in tc["layers"] for t in e.values())


def test_cache_bridge_round_trip(arch):
    _, jc = arch["jm"].prefill(arch["jp"], {"tokens": jnp.asarray(
        arch["toks"][:, :9])}, cache_len=12)
    jc = jax.tree.map(np.asarray, jc)
    back = bridge.cache_to_numpy(bridge.cache_to_torch(jc))
    assert sorted(back) == sorted(jc)
    for a, b in zip(back["layers"], jc["layers"]):
        assert sorted(a) == sorted(b)
        assert all(np.array_equal(a[k], b[k]) for k in b)


def test_full_width_layout_and_count_match_jax():
    """jamba-1.5-large-398b at full width from shapes alone (the port's
    module on the meta device, JAX's init through ``jax.eval_shape``): the
    same leaves and shapes over its period of eight, and ``param_count()``
    equal in both packages.  The leaves hold the final norm's d_model
    scales and each mamba layer's ``dt_bias`` (one per head) beyond it:
    JAX's analytic count leaves both out."""
    cfg, jcfg = get_arch(NAME), jax_get_arch(NAME)
    jshape = jax.eval_shape(jax_build_model(jcfg, dtype=jnp.float32).init,
                            jax.random.PRNGKey(0))
    module = Transformer(cfg)
    leaves = {k: tuple(v.shape) for k, v in module.named_parameters()}
    assert all(v.is_meta for v in module.parameters())
    jleaves = {}
    bridge._walk(jshape, "", jleaves)
    assert leaves == {k: tuple(v.shape) for k, v in jleaves.items()}
    assert period_kinds(cfg) == (MAMBA,) * 4 + (ATTN,) + (MAMBA,) * 3
    assert cfg.param_count() == jcfg.param_count()
    mamba_layers = cfg.layer_kinds().count(MAMBA)
    heads = cfg.ssm.expand * cfg.d_model // cfg.ssm.d_head
    assert sum(int(np.prod(s)) for s in leaves.values()) == \
        cfg.param_count() + cfg.d_model + mamba_layers * heads


@pytest.mark.parametrize("window", [0, 16])
def test_serve_cli_runs_on_cpu(window, capsys):
    toks, stats = serve.main(["--arch", SMOKE, "--batch", "2", "--prompt-len",
                              "20", "--gen", "4", "--window", str(window),
                              "--device", "cpu"])
    assert toks.shape == (2, 4) and stats["decode_s"] > 0
    assert "[serve] generated (2, 4) tokens" in capsys.readouterr().out
