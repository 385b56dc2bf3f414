"""The port's serving path against the JAX package's, for smollm-360m-smoke
(dense: prefill through the flash-attention op) and mamba2-780m-smoke
(SSM: prefill through the SSD-scan op), with parameters from the JAX init
through the bridge and prompts made with numpy from a seed.

Tolerances, max |a-b| over max |b|: prefill logits and caches 1e-5 (the
same fp32 forward summed in another order; measured about 2e-6);
teacher-forced decode logits 1e-4, the JAX suite's tolerance for a
round's metrics, four steps deep.  Greedy tokens are held by a flip-aware
criterion: a row's tokens must be equal up to the first step where JAX's
top-two logit gap is at most 1e-3 (a tie within the decode tolerance may
go either way); after a flip the two sequences feed different tokens and
are no longer compared.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_params_to_torch, rel_err
from repro.configs import get_arch as jax_get_arch
from repro.models.model import build_model as jax_build_model
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.launch import serve
from repro_torch.models.model import build_model
from repro_torch.models.transformer import Transformer

ARCHS = ["smollm-360m-smoke", "mamba2-780m-smoke"]
B, P, GEN = 2, 40, 8           # P = 40: a ragged last chunk of 32 for mamba
TOL_PREFILL = 1e-5
TOL_DECODE = 1e-4
GAP = 1e-3


@pytest.fixture(scope="module", params=ARCHS)
def served(request):
    """JAX's greedy generation, its logits at every step and its prefill
    cache, beside the port's model on the same parameters."""
    arch = request.param
    jm = jax_build_model(jax_get_arch(arch), dtype=jnp.float32)
    jp = jm.init(jax.random.PRNGKey(1))
    prompts = np.random.default_rng(0).integers(
        0, 512, (B, P)).astype(np.int32)
    cache_len = P + GEN + 1
    logits, cache = jax.jit(lambda p, b: jm.prefill(p, b, cache_len=cache_len)
                            )(jp, {"tokens": jnp.asarray(prompts)})
    jcache = jax.tree.map(np.asarray, cache)
    decode = jax.jit(jm.decode)
    jlogits, jtoks = [np.asarray(logits)], [np.argmax(np.asarray(logits), -1)]
    for _ in range(GEN - 1):
        logits, cache = decode(jp, jnp.asarray(jtoks[-1]), cache)
        jlogits.append(np.asarray(logits))
        jtoks.append(np.argmax(jlogits[-1], -1))
    return dict(arch=arch, jp=jp, tm=build_model(get_arch(arch)),
                tp=jax_params_to_torch(jp), prompts=prompts,
                cache_len=cache_len, jcache=jcache, jlogits=jlogits,
                jtoks=np.stack(jtoks, 1))


def _prefill(s):
    return s["tm"].prefill(s["tp"], {"tokens": torch.from_numpy(
        s["prompts"]).long()}, cache_len=s["cache_len"])


def test_prefill_logits_and_cache_match_jax(served):
    logits, cache = _prefill(served)
    assert rel_err(logits, served["jlogits"][0]) <= TOL_PREFILL
    (entry,), (jentry,) = cache["layers"], served["jcache"]["layers"]
    assert sorted(entry) == sorted(jentry)
    for k in jentry:
        assert entry[k].shape == jentry[k].shape, k
        assert rel_err(entry[k], jentry[k]) <= TOL_PREFILL, k
    assert int(cache["index"]) == int(served["jcache"]["index"]) == P


@pytest.mark.parametrize("start", ["port_prefill", "jax_cache"])
def test_teacher_forced_decode_matches_jax(served, start):
    """Four decode steps fed JAX's greedy tokens, from the port's own
    prefill cache or from JAX's through ``bridge.cache_to_torch``."""
    cache = (_prefill(served)[1] if start == "port_prefill"
             else bridge.cache_to_torch(served["jcache"]))
    for i in range(4):
        tok = torch.from_numpy(served["jtoks"][:, i]).long()
        logits, cache = served["tm"].decode(served["tp"], tok, cache)
        assert rel_err(logits, served["jlogits"][i + 1]) <= TOL_DECODE, i
    assert int(cache["index"]) == P + 4


def test_greedy_tokens_match_jax_flip_aware(served):
    toks, stats = serve.generate(
        served["tm"], served["tp"], torch.from_numpy(served["prompts"]).long(),
        gen_len=GEN, cache_len=served["cache_len"])
    assert toks.shape == (B, GEN) and stats["tok_per_s"] > 0
    compared = 0
    for b in range(B):
        for i in range(GEN):
            top2 = np.sort(served["jlogits"][i][b])[-2:]
            if int(toks[b, i]) != int(served["jtoks"][b, i]):
                assert top2[1] - top2[0] <= GAP, (b, i, top2)
                break
            compared += 1
    assert compared >= GEN            # at least one row's worth agrees


@pytest.mark.parametrize("prompt,window", [(8, 64), (40, 16)])
def test_window_ring_buffer_decode_matches_jax(prompt, window):
    """smollm's sliding-window decode: while the context fits the window
    (8 + steps < 64) and once the ring wraps (a 40-token prompt, window
    16: the prefill's 40 slots become the ring, as in JAX)."""
    arch = "smollm-360m-smoke"
    jm = jax_build_model(jax_get_arch(arch), dtype=jnp.float32,
                         decode_window=window)
    jp = jm.init(jax.random.PRNGKey(3))
    tm = build_model(get_arch(arch), decode_window=window)
    tp = jax_params_to_torch(jp)
    toks = np.random.default_rng(1).integers(0, 512, (1, prompt + 3)).astype(
        np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :prompt])},
                        cache_len=window)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :prompt])
                             .long()}, cache_len=window)
    assert rel_err(tl, np.asarray(jl)) <= TOL_PREFILL
    decode = jax.jit(jm.decode)
    for i in range(3):
        jd, jc = decode(jp, jnp.asarray(toks[:, prompt + i]), jc)
        td, tc = tm.decode(tp, torch.from_numpy(toks[:, prompt + i]).long(),
                           tc)
        assert rel_err(td, np.asarray(jd)) <= TOL_DECODE, i


@pytest.mark.parametrize("window", [0, 16])
@pytest.mark.parametrize("arch", ARCHS)
def test_make_cache_matches_jax(arch, window):
    jc = jax_build_model(jax_get_arch(arch), dtype=jnp.float32,
                         decode_window=window).make_cache(3, 24)
    tc = build_model(get_arch(arch), decode_window=window).make_cache(3, 24)
    (jentry,), (entry,) = jc["layers"], tc["layers"]
    assert {k: tuple(v.shape) for k, v in entry.items()} == \
        {k: tuple(v.shape) for k, v in jentry.items()}
    assert all(not t.any() for t in entry.values())
    assert int(tc["index"]) == 0 and tc["index"].dtype == torch.int32


def test_cache_bridge_round_trip(served):
    cache = bridge.cache_to_torch(served["jcache"])
    back = bridge.cache_to_numpy(cache)
    (a,), (b,) = back["layers"], served["jcache"]["layers"]
    assert all(np.array_equal(a[k], b[k]) for k in b)
    assert back["index"] == served["jcache"]["index"]


def test_mamba2_full_width_matches_jax_layout_and_count():
    """mamba2-780m at full width, from shapes alone (the port's module on
    the meta device, JAX's init through ``jax.eval_shape``): the same
    names and shapes, 779,841,792 parameters."""
    jshape = jax.eval_shape(jax_build_model(jax_get_arch("mamba2-780m"),
                                            dtype=jnp.float32).init,
                            jax.random.PRNGKey(0))
    leaves = {k: tuple(v.shape) for k, v in
              Transformer(get_arch("mamba2-780m")).named_parameters()}
    jleaves = {}
    bridge._walk(jshape, "", jleaves)          # ShapeDtypeStruct leaves
    assert leaves == {k: tuple(v.shape) for k, v in jleaves.items()}
    assert sum(int(np.prod(s)) for s in leaves.values()) == 779_841_792


def test_smoke_init_matches_jax_layout():
    jshape = jax.eval_shape(jax_build_model(jax_get_arch(ARCHS[1]),
                                            dtype=jnp.float32).init,
                            jax.random.PRNGKey(0))
    tp = build_model(get_arch(ARCHS[1])).init(torch.Generator().manual_seed(0))
    ref = jax_params_to_torch(jax.tree.map(
        lambda s: np.zeros(s.shape, s.dtype), jshape))
    assert list(tp) == list(ref)
    for k in ref:
        assert tp[k].shape == ref[k].shape and tp[k].dtype == ref[k].dtype
    A = -torch.exp(tp["blocks.0.mamba.A_log"])
    assert float(A.max()) == pytest.approx(-1.0) and \
        float(A.min()) == pytest.approx(-16.0)


@pytest.mark.parametrize("window", [0, 16])
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_on_cpu(arch, window, capsys):
    toks, stats = serve.main(["--arch", arch, "--batch", "2", "--prompt-len",
                              "40", "--gen", "8", "--window", str(window),
                              "--device", "cpu"])
    assert toks.shape == (2, 8) and stats["decode_s"] > 0
    out = capsys.readouterr().out
    assert "[serve] generated (2, 8) tokens" in out and "[serve] sample:" in out


def test_temperature_sampling_is_seeded():
    tm = build_model(get_arch(ARCHS[1]))
    tp = tm.init(torch.Generator().manual_seed(0))
    prompts = torch.randint(0, 512, (2, 12), generator=torch.Generator()
                            .manual_seed(1))
    runs = [serve.generate(tm, tp, prompts, gen_len=6, cache_len=19,
                           temperature=0.8, seed=5)[0] for _ in range(2)]
    assert torch.equal(runs[0], runs[1]) and runs[0].shape == (2, 6)


def test_unported_paths_raise_naming_the_roadmap():
    """``--ckpt`` (ROADMAP Queue 1 item 4) is ported: a missing blob is
    the file's error (``tests/test_torch_ckpt.py`` serves from real ones).
    Training through mamba layers (item 10) is ported: the SSM and hybrid
    losses and a round of ``run_training`` on the SSM smoke arch run and
    are finite."""
    with pytest.raises(FileNotFoundError):
        serve.main(["--arch", ARCHS[1], "--ckpt", "no-such-blob.msgpack",
                    "--device", "cpu"])
    cfg = get_arch(ARCHS[1])
    tm = build_model(cfg)
    tp = tm.init(torch.Generator().manual_seed(0))
    toks = torch.zeros((2, 9), dtype=torch.long)
    loss, _ = tm.loss(tp, {"tokens": toks})
    assert torch.isfinite(loss)
    from repro_torch.launch.train import run_training
    state, hist = run_training(ARCHS[1], rounds=1, cohort=2, client_batch=2,
                               seq=8, num_clients=4, examples=32, fused=True,
                               device="cpu", log_every=0)
    assert all(math.isfinite(v) for v in hist[0].values())
    assert all(bool(torch.isfinite(p).all())
               for p in state["params"].values())
    jamba = build_model(get_arch("jamba-1.5-large-398b-smoke"))
    loss, _ = jamba.loss(jamba.init(torch.Generator().manual_seed(0)),
                         {"tokens": toks})
    assert torch.isfinite(loss)
