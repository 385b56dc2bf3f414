"""The port's SSD scan and Mamba2 block against the JAX package's: the
plain chunked form (``ref.ssd_chunked_ref``, what the kernel's wrapper
``ssd_scan_fwd`` runs on the CPU) against JAX's ``ssd_chunked`` (y and
h_final), the Pallas kernel in interpret mode (y) and the sequential
oracle ``ssd_ref``; chunk-size invariance, the decode step, the causal
convolution and the whole block, prefill and decode.

Inputs are made once with numpy from a seed, as JAX's own SSM tests make
them: dt = softplus(normal), A = -exp(0.3 normal), so |a| is about 1 and
the in-chunk cumsum reaches a few tens.  Tolerances, max |a-b| over
max |b|:

  * 1e-5 between chunked forms with the same chunk (JAX and the port, the
    port with grouped or repeated B and C): the same operations, summed
    in another order; the cumsum of a, at |acum| < 64, is exact to a few
    ulps (4e-6 each), which moves each decay exp(acum_t - acum_s) by as
    much relatively;
  * 2e-5 across chunk sizes and against the sequential recurrence (which
    multiplies exp(a_t) step by step instead of exp of a cumsum
    difference): one more rounding of the same size per chunk crossed;
  * 1e-5 for the block and its decode step, whose matrix products
    dominate.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import rel_err
from repro.configs.base import SSMConfig as JaxSSMConfig
from repro.kernels.ssd_scan.ops import ssd_scan as jax_pallas_ssd
from repro.kernels.ssd_scan.ref import ssd_ref as jax_ssd_ref
from repro.models import ssm as JS
from repro_torch.configs.base import SSMConfig
from repro_torch.kernels.ssd_scan import kernel as K
from repro_torch.kernels.ssd_scan import ref as R
from repro_torch.models import ssm as TS

TOL = 1e-5
TOL_ACROSS = 2e-5


def _inputs(S, *, B=2, H=4, P=16, N=8, G=None, seed=0):
    """numpy inputs; Bm, Cm per group (B, S, G, N) when G is given, else
    per head."""
    rng = np.random.default_rng(seed)
    G = H if G is None else G
    x = rng.standard_normal((B, S, H, P), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = -np.exp(0.3 * rng.standard_normal(H)).astype(np.float32)
    Bm = rng.standard_normal((B, S, G, N), dtype=np.float32)
    Cm = rng.standard_normal((B, S, G, N), dtype=np.float32)
    return x, dt, A, Bm, Cm


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _fold(t):
    """(B, S, H, X) -> (B * H, S, X)."""
    B, S, H = t.shape[:3]
    return t.transpose(0, 2, 1, 3).reshape(B * H, S, -1)


@pytest.mark.parametrize("S,chunk", [(64, 16), (64, 64), (50, 16), (33, 16),
                                     (40, 128)])
def test_ssd_chunked_matches_jax(S, chunk):
    """y and h_final, ragged S (zero-padded to the chunk) included."""
    x, dt, A, Bm, Cm = _inputs(S)
    jy, jh = JS.ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm)), chunk)
    y, h = K.ssd_scan_fwd(*_t(x, dt, A, Bm, Cm), chunk=chunk)
    assert rel_err(y, np.asarray(jy)) <= TOL
    assert rel_err(h, np.asarray(jh)) <= TOL


@pytest.mark.parametrize("G", [1, 2])
def test_grouped_b_c_equal_repeated_heads(G):
    """The port hands B and C by group, the kernel reads head h's group
    h // (H / G); JAX repeats them to heads first.  One function."""
    x, dt, A, Bm, Cm = _inputs(48, G=G)
    jy, jh = JS.ssd_chunked(*map(jnp.asarray, (
        x, dt, A, np.repeat(Bm, 4 // G, axis=2),
        np.repeat(Cm, 4 // G, axis=2))), 16)
    y, h = K.ssd_scan_fwd(*_t(x, dt, A, Bm, Cm), chunk=16)
    assert rel_err(y, np.asarray(jy)) <= TOL
    assert rel_err(h, np.asarray(jh)) <= TOL


@pytest.mark.parametrize("S,chunk", [(64, 16), (128, 32)])
def test_ssd_chunked_matches_pallas_interpret(S, chunk):
    x, dt, A, Bm, Cm = _inputs(S)
    jy = jax_pallas_ssd(*map(jnp.asarray, (x, dt, A, Bm, Cm)), chunk=chunk,
                        interpret=True)
    y, _ = K.ssd_scan_fwd(*_t(x, dt, A, Bm, Cm), chunk=chunk)
    assert rel_err(y, np.asarray(jy)) <= TOL


@pytest.mark.parametrize("S", [40, 37])
def test_sequential_oracles_agree(S):
    """The port's ``ssd_ref`` against JAX's (the same recurrence), and the
    chunked form against it."""
    x, dt, A, Bm, Cm = _inputs(S)
    a = dt * A[None, None, :]
    args = (_fold(x), _fold(dt[..., None]), _fold(a[..., None]), _fold(Bm),
            _fold(Cm))
    jref = np.asarray(jax_ssd_ref(*map(jnp.asarray, args)))
    ref = R.ssd_ref(*_t(*args))
    assert rel_err(ref, jref) <= TOL
    y, _ = K.ssd_scan_fwd(*_t(x, dt, A, Bm, Cm), chunk=16)
    assert rel_err(_fold(y.numpy()), jref) <= TOL_ACROSS


def test_chunk_size_invariance():
    x, dt, A, Bm, Cm = _t(*_inputs(64))
    y8, h8 = K.ssd_scan_fwd(x, dt, A, Bm, Cm, chunk=8)
    for chunk in (16, 64, 256):
        y, h = K.ssd_scan_fwd(x, dt, A, Bm, Cm, chunk=chunk)
        assert rel_err(y, y8) <= TOL_ACROSS, chunk
        assert rel_err(h, h8) <= TOL_ACROSS, chunk


@pytest.mark.parametrize("S,chunk", [(37, 16), (40, 16), (40, 64)])
def test_ragged_tail_carries_the_state(S, chunk):
    """A ragged S, zero-padded to the chunk, gives the y and h_final of
    one unpadded chunk over the same S: the padded positions read as dt =
    0, so exp(0) = 1 carries h unchanged to h_final (the decode cache)."""
    x, dt, A, Bm, Cm = _t(*_inputs(S))
    y1, h1 = K.ssd_scan_fwd(x, dt, A, Bm, Cm, chunk=S)
    y, h = K.ssd_scan_fwd(x, dt, A, Bm, Cm, chunk=chunk)
    assert rel_err(y, y1) <= TOL_ACROSS
    assert rel_err(h, h1) <= TOL_ACROSS


def test_decode_step_continues_the_scan():
    x, dt, A, Bm, Cm = _inputs(33)
    tx, tdt, tA, tB, tC = _t(x, dt, A, Bm, Cm)
    y_full, _ = K.ssd_scan_fwd(tx, tdt, tA, tB, tC, chunk=16)
    _, h = K.ssd_scan_fwd(tx[:, :32], tdt[:, :32], tA, tB[:, :32],
                          tC[:, :32], chunk=16)
    y_t, h2 = TS.ssd_decode_step(tx[:, 32], tdt[:, 32], tA, tB[:, 32],
                                 tC[:, 32], h)
    assert rel_err(y_t, y_full[:, 32]) <= TOL_ACROSS
    jy, jh = JS.ssd_decode_step(*map(jnp.asarray, (
        x[:, 32], dt[:, 32], A, Bm[:, 32], Cm[:, 32], h.numpy())))
    assert rel_err(y_t, np.asarray(jy)) <= TOL
    assert rel_err(h2, np.asarray(jh)) <= TOL


def test_causal_conv_matches_step_and_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 12, 6), dtype=np.float32)
    w = rng.standard_normal((4, 6), dtype=np.float32)
    y, cache = TS.causal_conv(*_t(x, w))
    jy, jc = JS.causal_conv(jnp.asarray(x), jnp.asarray(w))
    assert rel_err(y, np.asarray(jy)) <= 1e-6
    assert rel_err(cache, np.asarray(jc)) == 0.0
    c = torch.zeros((2, 3, 6))
    for t in range(12):
        yt, c = TS.causal_conv_step(torch.from_numpy(x[:, t]),
                                    torch.from_numpy(w), c)
        assert rel_err(yt, y[:, t]) <= 1e-6
    assert torch.equal(c, cache)


@pytest.fixture(scope="module")
def block():
    """A mamba2 block at d_model 32 (4 heads of 16, state 8, chunk 16),
    parameters from the JAX init."""
    jcfg = JaxSSMConfig(d_state=8, d_head=16, expand=2, chunk=16)
    jp = JS.mamba_init(jax.random.PRNGKey(2), 32, jcfg)
    tcfg = SSMConfig(d_state=8, d_head=16, expand=2, chunk=16)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    # A_log = log(linspace(1, 16)): A from -1 to -16, the init's range
    return jcfg, jp, tcfg, tp


def test_mamba_block_and_prefill_cache_match_jax(block):
    from repro.configs.base import ArchConfig as JaxArchConfig
    from repro.models.transformer import _mamba_prefill
    jcfg, jp, tcfg, tp = block
    u = np.random.default_rng(6).standard_normal((2, 40, 32)).astype(
        np.float32)
    jy = JS.mamba_block(jnp.asarray(u), jp, jcfg)
    y = TS.mamba_block(torch.from_numpy(u), tp, tcfg)
    assert rel_err(y, np.asarray(jy)) <= TOL
    arch = JaxArchConfig(name="t", family="ssm", num_layers=1, d_model=32,
                         num_heads=0, num_kv_heads=0, d_ff=0, vocab_size=8,
                         ssm=jcfg)
    jy2, jc = _mamba_prefill(jnp.asarray(u), jp, arch)
    y2, c = TS.mamba_block(torch.from_numpy(u), tp, tcfg, collect_cache=True)
    assert rel_err(y2, np.asarray(jy2)) <= TOL
    assert rel_err(c["ssm"], np.asarray(jc["ssm"])) <= TOL
    # the conv cache is the in_proj output itself: one matmul's rounding
    assert rel_err(c["conv"], np.asarray(jc["conv"])) <= 1e-6
    # and owns its memory (a view would pin the whole projection)
    assert c["conv"].untyped_storage().nbytes() == c["conv"].numel() * 4


def test_mamba_block_decode_matches_jax_and_the_prefill(block):
    jcfg, jp, tcfg, tp = block
    u = np.random.default_rng(7).standard_normal((2, 21, 32)).astype(
        np.float32)
    full = TS.mamba_block(torch.from_numpy(u), tp, tcfg)
    _, cache = TS.mamba_block(torch.from_numpy(u[:, :17]), tp, tcfg,
                              collect_cache=True)
    jcache = {k: jnp.asarray(v.numpy()) for k, v in cache.items()}
    for t in range(17, 21):
        y, cache = TS.mamba_block_decode(torch.from_numpy(u[:, t]), tp, tcfg,
                                         cache)
        jy, jcache = JS.mamba_block_decode(jnp.asarray(u[:, t]), jp, jcfg,
                                           jcache)
        assert rel_err(y, np.asarray(jy)) <= TOL
        assert rel_err(y, full[:, t]) <= TOL_ACROSS
        for k in ("ssm", "conv"):
            assert rel_err(cache[k], np.asarray(jcache[k])) <= TOL


def test_make_cache_matches_jax_shapes():
    jc = JS.mamba_make_cache(3, 32, JaxSSMConfig(d_state=8, d_head=16),
                             jnp.float32)
    tc = TS.mamba_make_cache(3, 32, SSMConfig(d_state=8, d_head=16),
                             torch.float32)
    assert {k: tuple(v.shape) for k, v in tc.items()} == \
        {k: tuple(v.shape) for k, v in jc.items()}


def test_wrapper_refuses_what_the_kernel_does_not_take():
    x, dt, A, Bm, Cm = _t(*_inputs(16, G=2))
    with pytest.raises(RuntimeError, match="no backward"):
        K.ssd_scan_fwd(x.clone().requires_grad_(), dt, A, Bm, Cm, chunk=8)
    with pytest.raises(TypeError, match="float32"):
        K.ssd_scan_fwd(x.double(), dt, A, Bm, Cm, chunk=8)
    with pytest.raises(ValueError, match="groups"):
        K.ssd_scan_fwd(x, dt, A, torch.cat([Bm, Bm[:, :, :1]], 2),
                       torch.cat([Cm, Cm[:, :, :1]], 2), chunk=8)
    with pytest.raises(ValueError, match="match"):
        K.ssd_scan_fwd(x, dt[:, :8], A, Bm, Cm, chunk=8)
    with pytest.raises(ValueError, match="chunk"):
        K.ssd_scan_fwd(x, dt, A, Bm, Cm, chunk=0)
    n0 = K.ssd_scan_fwd.launches
    y, h = K.ssd_scan_fwd(x, dt, A, Bm, Cm, chunk=8)     # the plain version
    assert K.ssd_scan_fwd.launches == n0
    assert y.shape == x.shape and h.shape == (2, 4, 8, 16)


# ---------------------------------------------------------------------------
# The CUDA kernel's decomposition, pinned on the CPU.  The kernel computes
# the scan chunk-parallel (arXiv:2405.21060 section 6): (i) acum within each
# chunk, sequentially in index order; (ii) each chunk's state; (iii) the
# states passed across the chunks; (iv) each chunk's outputs.
# ``ref.ssd_chunk_parallel_ref`` renders that order in plain PyTorch.
#
# Three cumsums meet here: the kernel's (fp32, one position at a time),
# torch's on the CPU (it accumulates fp32 in double) and XLA's on the CPU.
# At the init's decay range (A down to -16) acum reaches a few thousand
# within a chunk, where one ulp is 2.4e-4, so the three give decays that
# differ by more than 1e-5.  The decomposition is therefore held to each
# other implementation with that implementation's own cumsum handed in;
# the kernel's order is pinned on its own below, and on the card
# (tests/test_torch_kernels_cuda.py) against torch.cumsum there, which
# scans an outer axis in fp32 in index order.
# ---------------------------------------------------------------------------
def _regime_inputs(S, *, regime, B=1, H=4, P=16, N=16, G=2, seed=0):
    """numpy inputs.  "init": A = -linspace(1, 16) (the model's A_log
    init), dt = softplus(normal); "slow": A = -exp(0.3 normal), dt a
    hundredth of softplus(normal), so the state carries across chunks."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    if regime == "init":
        A = -np.linspace(1.0, 16.0, H).astype(np.float32)
    else:
        A = -np.exp(0.3 * rng.standard_normal(H)).astype(np.float32)
        dt = (dt * 0.01).astype(np.float32)
    Bm = rng.standard_normal((B, S, G, N), dtype=np.float32)
    Cm = rng.standard_normal((B, S, G, N), dtype=np.float32)
    return x, dt, A, Bm, Cm


def _jax_cumsum(a, dim):
    return torch.from_numpy(np.array(jnp.cumsum(jnp.asarray(a.numpy()),
                                                axis=dim)))


_GN = [(1, 16), (2, 64), (4, 128), (2, 12), (1, 10)]
_SHAPES = [(S, chunk) for S in (1, 63, 128, 1000, 1025)
           for chunk in (32, 64, 256)]


@pytest.mark.parametrize("regime", ["init", "slow"])
@pytest.mark.parametrize("S,chunk", _SHAPES)
def test_chunk_parallel_matches_chunked_ref(S, chunk, regime):
    """Steps (i)-(iv) against ``ssd_chunked_ref`` (torch's cumsum handed
    in): y and h_final at 1e-5, ragged tails and one-chunk S included; G
    and N (16, 64, 128 and ones not a multiple of 8) vary with the case."""
    G, N = _GN[(S + chunk) % len(_GN)]
    x, dt, A, Bm, Cm = _t(*_regime_inputs(S, regime=regime, G=G, N=N))
    ry, rh = R.ssd_chunked_ref(x, dt, A, Bm, Cm, chunk)
    y, h = R.ssd_chunk_parallel_ref(x, dt, A, Bm, Cm, chunk,
                                    cumsum=torch.cumsum)
    assert rel_err(y, ry) <= TOL and rel_err(h, rh) <= TOL


@pytest.mark.parametrize("G,N", _GN)
def test_chunk_parallel_groups_and_state_widths(G, N):
    """Every G and N of ``_GN`` at a ragged S of three chunks, the init's
    decays: the decomposition against ``ssd_chunked_ref``."""
    x, dt, A, Bm, Cm = _t(*_regime_inputs(200, regime="init", G=G, N=N,
                                          seed=G * N))
    ry, rh = R.ssd_chunked_ref(x, dt, A, Bm, Cm, 64)
    y, h = R.ssd_chunk_parallel_ref(x, dt, A, Bm, Cm, 64,
                                    cumsum=torch.cumsum)
    assert rel_err(y, ry) <= TOL and rel_err(h, rh) <= TOL


@pytest.mark.parametrize("regime", ["init", "slow"])
@pytest.mark.parametrize("S,chunk,G,N", [(63, 32, 1, 16), (1025, 256, 4, 128),
                                         (1000, 64, 2, 12), (128, 32, 2, 64)])
def test_chunk_parallel_matches_jax(S, chunk, G, N, regime):
    """Steps (i)-(iv) against JAX's ``ssd_chunked`` (B and C repeated to
    heads, XLA's cumsum handed in): y and h_final at 1e-5."""
    x, dt, A, Bm, Cm = _regime_inputs(S, regime=regime, G=G, N=N)
    rep = lambda t: np.repeat(t, 4 // G, axis=2)
    jy, jh = JS.ssd_chunked(*map(jnp.asarray, (x, dt, A, rep(Bm), rep(Cm))),
                            chunk)
    y, h = R.ssd_chunk_parallel_ref(*_t(x, dt, A, Bm, Cm), chunk,
                                    cumsum=_jax_cumsum)
    assert rel_err(y, np.asarray(jy)) <= TOL
    assert rel_err(h, np.asarray(jh)) <= TOL


@pytest.mark.parametrize("regime", ["init", "slow"])
@pytest.mark.parametrize("S,chunk", [(128, 32), (128, 64)])
def test_chunk_parallel_matches_pallas_interpret(S, chunk, regime):
    x, dt, A, Bm, Cm = _regime_inputs(S, regime=regime, G=4, N=16)
    jy = jax_pallas_ssd(*map(jnp.asarray, (x, dt, A, Bm, Cm)), chunk=chunk,
                        interpret=True)
    y, _ = R.ssd_chunk_parallel_ref(*_t(x, dt, A, Bm, Cm), chunk,
                                    cumsum=_jax_cumsum)
    assert rel_err(y, np.asarray(jy)) <= TOL


@pytest.mark.parametrize("L", [1, 32, 256])
def test_sequential_cumsum_is_fp32_in_index_order(L):
    """The kernel's acum: one position at a time, each sum rounded to fp32
    (numpy's float32 add.accumulate), at the init's decay range, where
    torch's CPU cumsum (accumulated in double) differs by ulps."""
    rng = np.random.default_rng(L)
    dt = np.log1p(np.exp(rng.standard_normal((3, L, 4)))).astype(np.float32)
    a = (dt * -np.linspace(1.0, 16.0, 4).astype(np.float32)).astype(
        np.float32)
    got = R.sequential_cumsum(torch.from_numpy(a), 1).numpy()
    assert np.array_equal(got, np.add.accumulate(a, axis=1, dtype=np.float32))
    wide = np.cumsum(a.astype(np.float64), axis=1).astype(np.float32)
    assert np.array_equal(torch.cumsum(torch.from_numpy(a), 1).numpy(), wide)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """TF32 rounding as the kernel takes it (cvt.rna: to nearest, ties
    away from zero, on the sign-magnitude bits)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mm_3xtf32(a, b):
    """a @ b as the kernel's tensor cores take it: a_lo.b_hi + a_hi.b_lo +
    a_hi.b_hi, each product of TF32 values exact in fp32."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _mm_1xtf32(a, b):
    return _tf32(a) @ _tf32(b)


@pytest.mark.parametrize("regime", ["init", "slow"])
def test_3xtf32_ssd_keeps_fp32_accuracy(regime):
    """At the prefill's widths (P 64, N 128, chunk 256) over four chunks
    and a ragged tail: every product of the decomposition split into TF32
    high and low parts stays within 1e-5 of ``ssd_chunked_ref``; one TF32
    product does not."""
    x, dt, A, Bm, Cm = _t(*_regime_inputs(1025, regime=regime, P=64, N=128,
                                          G=1, H=2))
    ry, rh = R.ssd_chunked_ref(x, dt, A, Bm, Cm, 256)
    y3, h3 = R.ssd_chunk_parallel_ref(x, dt, A, Bm, Cm, 256, mm=_mm_3xtf32,
                                      cumsum=torch.cumsum)
    assert rel_err(y3, ry) <= TOL and rel_err(h3, rh) <= TOL
    y1, h1 = R.ssd_chunk_parallel_ref(x, dt, A, Bm, Cm, 256, mm=_mm_1xtf32,
                                      cumsum=torch.cumsum)
    assert max(rel_err(y1, ry), rel_err(h1, rh)) > 10 * TOL
