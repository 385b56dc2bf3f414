"""The port's flash attention against the JAX package's: the plain version
(``ref.attention_ref``) and the public op (``ops.flash_attention``, which
takes the plain version on the CPU) against JAX's ``attention_ref``, the
Pallas kernel in interpret mode and the model's ``attend``.

Inputs are made once with numpy from a seed.  Tolerance <= 1e-5 relative
(max |a-b| over max |b|): the same fp32 softmax attention, summed in
another order (the online softmax of the Pallas kernel and of ``attend``
rescales by exp of max differences block by block; a few ulps)."""
import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import rel_err
from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref as jax_ref
from repro.models.attention import attend as jax_attend
from repro.models.attention import simple_attention
from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.flash_attention import ref as R
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import attention as TA

TOL = 1e-5
SHAPES = [(S, H, Hkv, D) for S in (8, 32, 40) for H, Hkv in ((4, 4), (6, 2))
          for D in (16, 64)]
MASKS = [(True, 0), (True, 8), (False, 0), (False, 8)]


@functools.lru_cache(maxsize=None)
def _inputs(S, H, Hkv, D, B=2):
    rng = np.random.default_rng([S, H, Hkv, D, B])
    q = rng.standard_normal((B, S, H, D), dtype=np.float32)
    k = rng.standard_normal((B, S, Hkv, D), dtype=np.float32)
    v = rng.standard_normal((B, S, Hkv, D), dtype=np.float32)
    return q, k, v


def _fold(x):
    """(B, S, H, D) -> (B * H, S, D), heads ordered (b, h)."""
    B, S, H, D = x.shape
    return x.transpose(0, 2, 1, 3).reshape(B * H, S, D)


@functools.lru_cache(maxsize=None)
def _jax_ref(S, H, Hkv, D, causal, window):
    """JAX's oracle on the batch-2 inputs, back in (B, S, H, D)."""
    q, k, v = _inputs(S, H, Hkv, D)
    out = jax_ref(jnp.asarray(_fold(q)), jnp.asarray(_fold(k)),
                  jnp.asarray(_fold(v)), causal=causal, window=window)
    return np.asarray(out).reshape(2, H, S, D).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("causal,window", MASKS,
                         ids=[f"causal{int(c)}-w{w}" for c, w in MASKS])
@pytest.mark.parametrize("S,H,Hkv,D", SHAPES)
@pytest.mark.parametrize("B", [1, 2])
def test_flash_attention_matches_jax_ref(B, S, H, Hkv, D, causal, window):
    """The sweep: B {1, 2} (batch 1 is the first row of JAX's batch 2),
    S {8, 32, 40}, (H, Hkv) {(4, 4), (6, 2)}, D {16, 64}, causal on and
    off, window {0, 8}."""
    q, k, v = (torch.from_numpy(t[:B]) for t in _inputs(S, H, Hkv, D))
    ref = _jax_ref(S, H, Hkv, D, causal, window)[:B]
    out = flash_attention(q, k, v, causal=causal, window=window)
    assert out.shape == (B, S, H, D)
    assert rel_err(out, ref) <= TOL
    plain = R.attention_ref(torch.from_numpy(_fold(q.numpy())),
                            torch.from_numpy(_fold(k.numpy())),
                            torch.from_numpy(_fold(v.numpy())),
                            causal=causal, window=window)
    assert rel_err(plain, _fold(ref)) <= TOL


@pytest.mark.parametrize("S,H,Hkv,D,causal,window", [
    (40, 6, 2, 64, True, 8), (32, 4, 4, 16, False, 0),
    (8, 6, 2, 16, True, 0), (40, 4, 4, 64, False, 8)])
def test_flash_attention_matches_pallas_interpret_and_attend(
        S, H, Hkv, D, causal, window):
    q, k, v = _inputs(S, H, Hkv, D)
    pallas = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       causal=causal, window=window, interpret=True)
    att = jax_attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=causal, window=window)
    out = flash_attention(*(torch.from_numpy(t) for t in (q, k, v)),
                          causal=causal, window=window)
    assert rel_err(out, np.asarray(pallas)) <= TOL
    assert rel_err(out, np.asarray(att)) <= TOL


def test_ragged_length_matches_jax_chunked_attend():
    """At S = 520 JAX's ``attend`` cannot block the sequence by 512 and
    computes the same function through ``chunked_attention``, padding and
    masking the tail; the port's op takes any length."""
    q, k, v = _inputs(520, 2, 1, 16, B=1)
    att = jax_attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=True)
    out = flash_attention(*(torch.from_numpy(t) for t in (q, k, v)),
                          causal=True)
    assert rel_err(out, np.asarray(att)) <= TOL


@pytest.mark.parametrize("S,H,Hkv,causal,window", [
    (40, 4, 4, True, 0), (33, 6, 2, True, 8), (17, 4, 2, False, 0)])
def test_head_dim_96_matches_pallas_interpret(S, H, Hkv, causal, window):
    """phi3-mini's head dim (96), a form the kernel is built for: the op
    against the Pallas kernel in interpret mode and the model's
    ``attend``."""
    q, k, v = _inputs(S, H, Hkv, 96)
    pallas = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       causal=causal, window=window, interpret=True)
    out = flash_attention(*(torch.from_numpy(t) for t in (q, k, v)),
                          causal=causal, window=window)
    assert out.shape == (2, S, H, 96)
    assert rel_err(out, np.asarray(pallas)) <= TOL
    assert rel_err(TA.attend(*(torch.from_numpy(t) for t in (q, k, v)),
                             causal=causal), np.asarray(jax_attend(
                                 jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=causal))) <= TOL


@pytest.mark.parametrize("S,H,Hkv,causal,window", [
    (24, 4, 4, True, 0), (37, 4, 2, True, 0), (16, 2, 2, False, 0),
    (30, 4, 4, True, 8)])
def test_wide_keys_narrow_values_match_jax_simple_attention(
        S, H, Hkv, causal, window):
    """MLA's form, Dk 192 > Dv 128 (the Pallas kernel takes one head
    dim): the op, its plain version and ``attend`` against JAX's
    ``simple_attention``, which scales by 1 / sqrt(Dk)."""
    rng = np.random.default_rng([S, H, Hkv])
    q = rng.standard_normal((2, S, H, 192), dtype=np.float32)
    k = rng.standard_normal((2, S, Hkv, 192), dtype=np.float32)
    v = rng.standard_normal((2, S, Hkv, 128), dtype=np.float32)
    ref = np.asarray(simple_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), causal=causal,
                                      window=window))
    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    out = flash_attention(tq, tk, tv, causal=causal, window=window)
    assert out.shape == (2, S, H, 128) and out.is_contiguous()
    assert rel_err(out, ref) <= TOL
    o4 = K.flash_attention_fwd(tq.transpose(1, 2), tk.transpose(1, 2),
                               tv.transpose(1, 2), causal=causal,
                               window=window)
    assert o4.shape == (2, H, S, 128) and torch.equal(o4.transpose(1, 2), out)
    if window == 0:
        assert rel_err(TA.attend(tq, tk, tv, causal=causal), ref) <= TOL


def test_kernel_forms_and_shape_refusals():
    """The CUDA kernel is built for (Dk, Dv) in (64, 64), (96, 96), (128,
    128) and (192, 128) (a CUDA tensor at any other pair raises
    ``NotImplementedError``, checked on the card); on every device the
    wrapper refuses keys whose head dim is not the queries', and values
    whose batch, heads or length are not the keys'."""
    assert K.FORMS == ((64, 64), (96, 96), (128, 128), (192, 128))
    q = torch.zeros((1, 4, 8, 192))
    k, v = torch.zeros((1, 2, 8, 192)), torch.zeros((1, 2, 8, 128))
    assert K.flash_attention_fwd(q, k, v).shape == (1, 4, 8, 128)
    with pytest.raises(ValueError, match="do not match"):
        K.flash_attention_fwd(q, k[..., :128], v)
    with pytest.raises(ValueError, match="do not match"):
        K.flash_attention_fwd(q, k, v[:, :, :5])
    with pytest.raises(ValueError, match="do not match"):
        K.flash_attention_fwd(q, k, v[:, :1])


def test_prefill_attention_equals_training_attend():
    """Within the port: the prefill's attention (the kernel's entry
    point, which ``transformer._apply_layer`` calls under
    ``collect_cache``) and the training path's plain ``attend`` compute one
    function."""
    q, k, v = (torch.from_numpy(t) for t in _inputs(40, 6, 2, 64))
    a = flash_attention(q, k, v, causal=True)
    b = TA.attend(q, k, v, causal=True)
    assert rel_err(a, b) <= TOL


def test_flash_attention_returns_the_models_layout():
    """The op hands the kernel (B, H, S, D) views of the model's (B, S, H,
    D) tensors and gets o back in (B, S, H, D) storage, so the prefill's
    ``reshape(B, S, H * D)`` is a view, not a copy; the folded (BH, S, D)
    form is the case B = 1."""
    q, k, v = (torch.from_numpy(t) for t in _inputs(8, 6, 2, 16))
    out = flash_attention(q, k, v, causal=True)
    assert out.is_contiguous()
    assert out.reshape(2, 8, -1).data_ptr() == out.data_ptr()
    o4 = K.flash_attention_fwd(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2))
    assert o4.shape == (2, 6, 8, 16) and o4.transpose(1, 2).is_contiguous()
    assert torch.equal(o4.transpose(1, 2), out)
    of = K.flash_attention_fwd(*(torch.from_numpy(_fold(t)).unsqueeze(0)
                                 for t in _inputs(8, 6, 2, 16)))
    assert of.shape == (1, 12, 8, 16) and torch.equal(
        of[0], torch.from_numpy(_fold(out.numpy())))


def test_decode_attention_matches_jax():
    from repro.models.attention import decode_attention as jax_decode
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 6, 16), dtype=np.float32)
    kc, vc = rng.standard_normal((2, 2, 12, 2, 16), dtype=np.float32)
    for index, window in ((5, 0), (11, 0), (5, 12), (30, 12)):
        ref = jax_decode(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                         jnp.asarray(index, jnp.int32), window=window)
        out = TA.decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                                  torch.from_numpy(vc),
                                  torch.tensor(index, dtype=torch.int32),
                                  window=window)
        assert rel_err(out, np.asarray(ref)) <= TOL, (index, window)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    q, k, v = (torch.from_numpy(t).transpose(1, 2)
               for t in _inputs(8, 6, 2, 16))
    with pytest.raises(RuntimeError, match="no backward"):
        K.flash_attention_fwd(q.clone().requires_grad_(), k, v)
    with pytest.raises(TypeError, match="float32"):
        K.flash_attention_fwd(q.to(torch.bfloat16), k, v)
    with pytest.raises(ValueError, match="multiple"):
        K.flash_attention_fwd(q[:, :5], k, v)
    with pytest.raises(ValueError, match="B, heads, S, D"):
        K.flash_attention_fwd(q[0], k[0], v[0])
    with pytest.raises(ValueError, match="unit stride"):
        K.flash_attention_fwd(q.transpose(2, 3).contiguous().transpose(2, 3),
                              k, v)
    with pytest.raises(ValueError, match="window"):
        K.flash_attention_fwd(q, k, v, window=-1)
    n0 = K.flash_attention_fwd.launches
    K.flash_attention_fwd(q, k, v)            # the CPU: the plain version
    assert K.flash_attention_fwd.launches == n0


# ---------------------------------------------------------------------------
# The CUDA kernel's numerics, pinned on the CPU: both products run on the
# tensor cores as 3xTF32.  TF32 keeps 10 of fp32's 23 mantissa bits;
# ``cvt.rna.tf32.f32`` rounds to nearest with ties away from zero, which on
# the sign-magnitude bits is "add half of the dropped part, then mask".
# ---------------------------------------------------------------------------
def _tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mm_3xtf32(a, b):
    """a @ b as the kernel takes it: a_lo.b_hi + a_hi.b_lo + a_hi.b_hi,
    each product of TF32 values exact in fp32."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _mm_1xtf32(a, b):
    return _tf32(a) @ _tf32(b)


def _attention_emulated(q, k, v, mm):
    """Causal attention with both products through ``mm``: (BH, S, D)."""
    S, D = q.shape[1], q.shape[2]
    s = mm(q, k.transpose(1, 2)) / math.sqrt(D)
    rel = torch.arange(S)[:, None] - torch.arange(S)[None, :]
    p = torch.softmax(torch.where(rel >= 0, s, R.NEG_INF), dim=-1)
    return mm(p, v)


def test_tf32_rounding_is_round_to_nearest_ties_away():
    ulp = 2.0 ** -10                     # TF32's unit in the last place at 1
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2 ** -23,
                      1 + 3 * ulp / 2, 0.0, -0.0, 3.0], dtype=torch.float32)
    want = [1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp, 0.0, -0.0, 3.0]
    assert _tf32(x).tolist() == want
    hi = _tf32(x)
    assert torch.equal(hi + (x - hi), x)          # x - hi is exact


def test_3xtf32_attention_keeps_fp32_accuracy():
    """At S 1024, D 64 (the prefill's head): the three-term split is
    within 1e-5 of fp32 attention (about 3e-7); one TF32 product is not
    (about 4e-4)."""
    rng = np.random.default_rng(1024)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 1024, 64),
                                                    dtype=np.float32))
               for _ in range(3))
    ref = R.attention_ref(q, k, v, causal=True)
    assert rel_err(_attention_emulated(q, k, v, _mm_3xtf32), ref) <= TOL
    assert rel_err(_attention_emulated(q, k, v, _mm_1xtf32), ref) > 10 * TOL


def test_score_fragments_are_the_pv_a_fragments():
    """The kernel stores K's rows permuted within each group of 8 (key r at
    storage row 2r for r < 4, 2(r - 4) + 1 for r >= 4), so the q.k
    product's mma C fragment (rows g, g + 8; columns 2t, 2t + 1) holds keys
    t and t + 4: the A fragment (columns t, t + 4) that the p.v product
    takes.  Checked for every lane on one 16 x 8 tile, with the storage
    formula of ``csrc/flash_attention.cu``."""
    rr = lambda r: (r & ~7) | ((r & 3) << 1) | ((r >> 2) & 1)
    assert sorted(rr(r) for r in range(16)) == list(range(16))
    rng = np.random.default_rng(0)
    s = rng.standard_normal((16, 8))                 # scores, true key order
    stored = np.empty_like(s)
    for r in range(8):
        stored[:, rr(r)] = s[:, r]                   # column n = storage row
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        c = [stored[g, 2 * t], stored[g, 2 * t + 1],
             stored[g + 8, 2 * t], stored[g + 8, 2 * t + 1]]
        a = [s[g, t], s[g + 8, t], s[g, t + 4], s[g + 8, t + 4]]
        assert [c[0], c[2], c[1], c[3]] == a, lane
