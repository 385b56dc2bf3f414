"""The port's encoder-decoder and cross-attention stacks against the JAX
package's, at smoke size: whisper-large-v3 (a 2-layer LayerNorm encoder
with sinusoidal positions and a GELU MLP; a decoder of a self-attention
layer without RoPE, sinusoidal positions instead, and a cross-attention
layer) and llama-3.2-vision-90b (no encoder layers at the model's width:
``enc_embeds`` go straight to the cross layer's keys and values; GQA 8/2,
RoPE).  Parameters come from the JAX init through the bridge; tokens,
masks and ``enc_embeds`` are made with numpy from a seed.

Tolerances, max |a-b| over max |b|: the masked loss and its metrics,
prefill logits, every cache entry (``enc_out`` too) and four
teacher-forced decode steps 1e-5 (the same fp32 model summed in another
order); the loss's gradients 1e-4 (the suite's gradient tolerance, as in
``test_torch_client.py``).  Full width is checked from shapes alone: the
port's module on the ``meta`` device against ``jax.eval_shape`` of the
JAX init and ``ArchConfig.param_count()``.  The flash-attention op's
non-causal path at Sq != Skv, which the cross layers take, is held to
JAX's ``attend`` and to the Pallas kernel in interpret mode."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_params_to_torch, max_tree_rel_err, rel_err
from repro.configs import get_arch as jax_get_arch
from repro.core.flat import make_flat_spec as jax_flat_spec
from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.models import layers as JL
from repro.models.attention import attend as jax_attend
from repro.models.model import build_model as jax_build_model
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.core.flat import make_flat_spec
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.launch import serve
from repro_torch.models import layers as TL
from repro_torch.models.model import build_model
from repro_torch.models.transformer import Transformer

NEW = ["whisper-large-v3", "llama-3.2-vision-90b"]
SMOKE = [f"{a}-smoke" for a in NEW]
B, P = 2, 24
TOL = 1e-5
GRAD_TOL = 1e-4


def _enc(cfg, seed):
    e = cfg.encoder
    return np.random.default_rng(seed).normal(
        0, 1, (B, e.enc_len, e.enc_dim)).astype(np.float32)


@pytest.fixture(scope="module", params=SMOKE)
def arch(request):
    name = request.param
    cfg = get_arch(name)
    jm = jax_build_model(jax_get_arch(name), dtype=jnp.float32,
                         loss_chunk=16)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(1))
    rng = np.random.default_rng(len(name))
    toks = rng.integers(0, 512, (B, P + 5)).astype(np.int32)
    mask = (rng.random((B, P + 1)) > 0.3).astype(np.float32)
    return dict(name=name, cfg=cfg, jm=jm, jp=jp, toks=toks, mask=mask,
                enc=_enc(cfg, len(name) + 1),
                tm=build_model(cfg, loss_chunk=16),
                tp=jax_params_to_torch(jp))


def _batches(arch, n, mask=True):
    toks = arch["toks"][:, :n]
    jb = {"tokens": jnp.asarray(toks), "enc_embeds": jnp.asarray(arch["enc"])}
    tb = {"tokens": torch.from_numpy(toks).long(),
          "enc_embeds": torch.from_numpy(arch["enc"])}
    if mask:
        jb["mask"] = jnp.asarray(arch["mask"][:, :n])
        tb["mask"] = torch.from_numpy(arch["mask"][:, :n])
    return jb, tb


@pytest.mark.parametrize("mask", [True, False], ids=["masked", "unmasked"])
def test_loss_and_metrics_match_jax(arch, mask):
    """The masked mean over kept labels (the mask shifted with them), the
    sequence chunked by 16 with a ragged last chunk; the encoder runs in
    the loss through the plain ``attend``."""
    jb, tb = _batches(arch, P + 1, mask)
    jl, jmet = jax.jit(arch["jm"].loss)(arch["jp"], jb)
    tl, tmet = arch["tm"].loss(arch["tp"], tb)
    assert rel_err(tl, np.asarray(jl)) <= TOL
    assert rel_err(tmet["xent"], np.asarray(jmet["xent"])) <= TOL
    assert float(tmet["aux"]) == 0.0
    assert float(tmet["acc"]) == pytest.approx(float(jmet["acc"]), abs=1e-6)


def test_loss_gradients_match_jax(arch):
    """Gradients of the masked loss with respect to every parameter, the
    encoder's included, ``torch.func.grad`` against ``jax.grad``."""
    jb, tb = _batches(arch, P + 1)
    jg = jax.jit(jax.grad(lambda p: arch["jm"].loss(p, jb)[0]))(arch["jp"])
    tg = torch.func.grad(lambda p: arch["tm"].loss(p, tb)[0])(arch["tp"])
    jg = jax_params_to_torch(jg)
    if arch["cfg"].encoder.enc_layers:
        assert any(k.startswith("encoder.layers.") for k in tg)
    assert max_tree_rel_err(tg, jg) <= GRAD_TOL


def test_masked_positions_do_not_move_the_loss(arch):
    """A label the mask drops leaves the loss unchanged whatever it is."""
    _, tb = _batches(arch, P + 1)
    drop = int(np.flatnonzero(arch["mask"][0, 1:P + 1] == 0)[0]) + 1
    other = dict(tb, tokens=tb["tokens"].clone())
    other["tokens"][0, drop] = (other["tokens"][0, drop] + 1) % 512
    other["tokens"] = other["tokens"][:, :drop + 1]
    base = dict(tb, tokens=tb["tokens"][:, :drop + 1],
                mask=tb["mask"][:, :drop + 1])
    other["mask"] = base["mask"]
    assert torch.equal(arch["tm"].loss(arch["tp"], base)[0],
                       arch["tm"].loss(arch["tp"], other)[0])


def test_prefill_cache_and_decode_match_jax(arch):
    """Prefill logits, every cache entry (self-attention k / v padded to
    the cache length, the cross layer's k / v over the encoder's
    positions) and ``enc_out``, then four decode steps fed the same
    tokens, against JAX."""
    jm, tm, toks = arch["jm"], arch["tm"], arch["toks"]
    cache_len = P + 5
    jb, tb = _batches(arch, P, mask=False)
    jlog, jc = jax.jit(lambda p, b: jm.prefill(p, b, cache_len=cache_len))(
        arch["jp"], jb)
    tlog, tc = tm.prefill(arch["tp"], tb, cache_len=cache_len)
    assert rel_err(tlog, np.asarray(jlog)) <= TOL
    assert sorted(tc) == sorted(jc) == ["enc_out", "index", "layers"]
    assert rel_err(tc["enc_out"], np.asarray(jc["enc_out"])) <= TOL
    assert len(tc["layers"]) == len(jc["layers"])
    for entry, jentry in zip(tc["layers"], jc["layers"]):
        assert sorted(entry) == sorted(jentry)
        for k in jentry:
            assert entry[k].shape == jentry[k].shape, k
            assert rel_err(entry[k], np.asarray(jentry[k])) <= TOL, k
    assert tc["layers"][1]["k"].shape[2] == arch["cfg"].encoder.enc_len
    decode = jax.jit(jm.decode)
    for i in range(4):
        tok = toks[:, P + i]
        jd, jc = decode(arch["jp"], jnp.asarray(tok), jc)
        td, tc = tm.decode(arch["tp"], torch.from_numpy(tok).long(), tc)
        assert rel_err(td, np.asarray(jd)) <= TOL, i
        assert "enc_out" in tc
    assert int(tc["index"]) == int(jc["index"]) == P + 4


def test_prefill_needs_enc_embeds(arch):
    with pytest.raises(ValueError, match="enc_embeds"):
        arch["tm"].prefill(arch["tp"], {"tokens": torch.zeros(
            (1, 4), dtype=torch.long)})


@pytest.mark.parametrize("window", [0, 16])
@pytest.mark.parametrize("name", SMOKE)
def test_make_cache_matches_jax(name, window):
    """Self-attention entries of the cache length (the window under a
    ring buffer), cross entries of the encoder's ``enc_len``."""
    jc = jax_build_model(jax_get_arch(name), dtype=jnp.float32,
                         decode_window=window).make_cache(3, 24)
    tc = build_model(get_arch(name), decode_window=window).make_cache(3, 24)
    assert [{k: tuple(v.shape) for k, v in e.items()} for e in tc["layers"]] \
        == [{k: tuple(v.shape) for k, v in e.items()} for e in jc["layers"]]
    assert all(not t.any() for e in tc["layers"] for t in e.values())


def test_cache_bridge_round_trip(arch):
    jb, _ = _batches(arch, 9, mask=False)
    _, jc = arch["jm"].prefill(arch["jp"], jb, cache_len=12)
    jc = jax.tree.map(np.asarray, jc)
    back = bridge.cache_to_numpy(bridge.cache_to_torch(jc))
    assert sorted(back) == sorted(jc)
    assert np.array_equal(back["enc_out"], jc["enc_out"])
    for a, b in zip(back["layers"], jc["layers"]):
        assert sorted(a) == sorted(b)
        assert all(np.array_equal(a[k], b[k]) for k in b)


def test_params_layout_and_bridge_match_jax(arch):
    """The port's init has JAX's leaves in JAX's order and its flat layout
    (the encoder subtree, or for llama-3.2-vision none: JAX's empty
    ``params["encoder"]`` has no leaves); the bridge's tree back goes
    through JAX's own loss to the same value."""
    jp, tp = arch["jp"], arch["tp"]
    init = arch["tm"].init(torch.Generator().manual_seed(0))
    assert list(init) == list(tp)
    assert all(init[k].shape == tp[k].shape for k in tp)
    if arch["cfg"].encoder.enc_layers == 0:
        assert jp["encoder"] == {}
        assert not any(k.startswith("encoder") for k in tp)
    spec, jspec = make_flat_spec(tp), jax_flat_spec(jp)
    assert [(g.rows, [(s.shape, s.offset) for s in g.leaves])
            for g in spec.groups] == \
        [(g.rows, [(tuple(s.shape), s.offset) for s in g.leaves])
         for g in jspec.groups]
    jb, _ = _batches(arch, P + 1)
    back = jax.tree.map(jnp.asarray, bridge.to_numpy(tp))
    assert float(arch["jm"].loss(back, jb)[0]) == \
        float(arch["jm"].loss(jp, jb)[0])


@pytest.mark.parametrize("name,count,leaves_sum", [
    ("whisper-large-v3", 1_810_662_400, 1_601_237_760),
    ("llama-3.2-vision-90b", 87_666_786_304, 87_666_794_496)])
def test_full_width_layout_and_count_match_jax(name, count, leaves_sum):
    """At full width from shapes alone: the same leaves and shapes in both
    packages, and ``param_count()`` equal in both.  The leaves' sum is the
    count plus the final norm's d_model scales for llama-3.2-vision; for
    whisper it is 209,424,640 under the count: JAX's analytic count takes
    each encoder layer's MLP as three d x d_ff matrices (SwiGLU's) where
    it is the GELU MLP's two and their biases, counts two of the layer's
    four LayerNorm vectors, and leaves out the final norms."""
    cfg, jcfg = get_arch(name), jax_get_arch(name)
    jshape = jax.eval_shape(jax_build_model(jcfg, dtype=jnp.float32).init,
                            jax.random.PRNGKey(0))
    module = Transformer(cfg)
    leaves = {k: tuple(v.shape) for k, v in module.named_parameters()}
    assert all(v.is_meta for v in module.parameters())
    jleaves = {}
    bridge._walk(jshape, "", jleaves)
    assert leaves == {k: tuple(v.shape) for k, v in jleaves.items()}
    assert cfg.param_count() == jcfg.param_count() == count
    assert sum(int(np.prod(s)) for s in leaves.values()) == leaves_sum
    assert sum(1 for k in leaves if k.startswith("encoder.")) == (
        12 + 2 if cfg.encoder.enc_layers else 0)


@pytest.mark.parametrize("window", [0, 16])
@pytest.mark.parametrize("name", SMOKE)
def test_serve_cli_runs_on_cpu(name, window, capsys):
    """``serve.main`` draws the prompts, then the encoder's input, from one
    numpy generator, as JAX's launcher does."""
    toks, stats = serve.main(["--arch", name, "--batch", "2", "--prompt-len",
                              "20", "--gen", "4", "--window", str(window),
                              "--device", "cpu"])
    assert toks.shape == (2, 4) and stats["decode_s"] > 0
    assert "[serve] generated (2, 4) tokens" in capsys.readouterr().out


def test_serve_inputs_are_jaxs(monkeypatch):
    """The prompts and frames ``serve.main`` hands to ``generate`` equal
    the JAX launcher's draws for the seed."""
    seen = {}

    def fake(model, params, prompts, **kw):
        seen.update(prompts=prompts, enc=kw["enc_embeds"])
        return torch.zeros((2, 3), dtype=torch.long), {
            "tok_per_s": 1.0, "decode_s": 1.0}

    monkeypatch.setattr(serve, "generate", fake)
    serve.main(["--arch", SMOKE[0], "--batch", "2", "--prompt-len", "7",
                "--gen", "3", "--seed", "5", "--device", "cpu"])
    e = get_arch(SMOKE[0]).encoder
    rng = np.random.default_rng(5)
    prompts = rng.integers(0, 512, (2, 7))
    enc = np.asarray(jnp.asarray(rng.normal(0, 1, (2, e.enc_len, e.enc_dim)),
                                 jnp.float32))
    assert np.array_equal(seen["prompts"].numpy(), prompts)
    assert seen["enc"].dtype == torch.float32
    assert np.array_equal(seen["enc"].numpy(), enc)


# ---------------------------------------------------------------------------
# The encoder's building blocks, and flash attention over encoder keys
# ---------------------------------------------------------------------------
def test_layernorm_sinusoidal_and_gelu_mlp_match_jax():
    """LayerNorm with the population variance; the sinusoidal table, and
    its row at a decode index; the GELU MLP in ``jax.nn.gelu``'s default
    tanh form (the exact erf form differs by more than 1e-5)."""
    rng = np.random.default_rng(3)
    x = rng.normal(0, 2, (3, 5, 48)).astype(np.float32) + 0.5
    s, b = rng.normal(size=(2, 48)).astype(np.float32)
    assert rel_err(TL.layernorm(*map(torch.from_numpy, (x, s, b))),
                   np.asarray(JL.layernorm(x, s, b))) <= TOL
    tab = TL.sinusoidal_positions(torch.arange(1500), 64)
    assert rel_err(tab, np.asarray(JL.sinusoidal_positions(1500, 64))) <= TOL
    assert torch.equal(TL.sinusoidal_positions(torch.tensor([417]), 64)[0],
                       tab[417])
    p = {k: rng.normal(0, 0.3, shape).astype(np.float32) for k, shape in
         (("w_in", (48, 96)), ("b_in", (96,)), ("w_out", (96, 48)),
          ("b_out", (48,)))}
    ref = np.asarray(JL.gelu_mlp(x, p))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    assert rel_err(TL.gelu_mlp(torch.from_numpy(x), tp), ref) <= TOL
    erf = torch.nn.functional.gelu(torch.from_numpy(x) @ tp["w_in"]
                                   + tp["b_in"]) @ tp["w_out"] + tp["b_out"]
    assert rel_err(erf, ref) > TOL


def _qkv(Sq, Skv, H=4, Hkv=2, D=64, seed=0):
    rng = np.random.default_rng([Sq, Skv, H, Hkv, D, seed])
    return (rng.standard_normal((2, Sq, H, D), dtype=np.float32),
            rng.standard_normal((2, Skv, Hkv, D), dtype=np.float32),
            rng.standard_normal((2, Skv, Hkv, D), dtype=np.float32))


@pytest.mark.parametrize("Sq,Skv", [(40, 64), (40, 63), (1, 100)])
def test_noncausal_flash_at_unequal_lengths_matches_jax_attend(Sq, Skv):
    """Queries of the decoder against the encoder's keys: non-causal, Sq !=
    Skv, a ragged key tail (63, 100), a single query."""
    q, k, v = _qkv(Sq, Skv)
    ref = jax_attend(*map(jnp.asarray, (q, k, v)), causal=False)
    out = flash_attention(*map(torch.from_numpy, (q, k, v)), causal=False)
    assert out.shape == (2, Sq, 4, 64)
    assert rel_err(out, np.asarray(ref)) <= TOL


def test_noncausal_flash_at_unequal_lengths_matches_pallas_interpret():
    """At a block-multiple shape (the Pallas wrapper refuses to zero-pad
    keys without causal masking), the kernel in interpret mode."""
    q, k, v = _qkv(32, 64, H=6, Hkv=2)
    pallas = jax_flash(*map(jnp.asarray, (q, k, v)), causal=False, bq=16,
                       bk=32, interpret=True)
    out = flash_attention(*map(torch.from_numpy, (q, k, v)), causal=False)
    assert rel_err(out, np.asarray(pallas)) <= TOL
