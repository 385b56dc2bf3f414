"""The bf16 forms of the prefill's two kernels (rows 11-12), their plain
versions on the CPU, against the JAX package's Pallas kernels in
interpret mode at bf16, and the wrappers' dtype contract.

Inputs are made with numpy from a seed, rounded to bf16 and handed to
both.  Tolerance 1e-2, max |a-b| over max |b|, on outputs rounded to
bf16 (a bf16 step is 2^-8 of a value): flash attention computes in fp32
from the bf16 operands in both packages but rounds its exponentials to
bf16 at other places (JAX's relative to each 128-key block's running max,
the plain version's to the row's max), and both round o; the SSD scan
upcasts the bf16 inputs and computes in fp32 in both, so they differ by
fp32 summation order before y's rounding.  Tighter than the 3e-2 (flash)
and 6e-2 / 3e-2 (SSD) that JAX's own bf16 kernel tests hold
(``tests/test_kernels.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import rel_err
from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.ssd_scan.ops import ssd_scan as jax_ssd
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.ssd_scan import kernel as SK

TOL = 1e-2


def _bf16(rng, shape):
    """A bf16 tensor and the same values as a JAX bf16 array."""
    t = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
        torch.bfloat16)
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _np(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else
                      jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("B,S,H,Hkv,D", [
    (2, 128, 4, 2, 64), (1, 256, 8, 8, 128), (2, 128, 4, 1, 64),
    (1, 192, 2, 2, 96)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 64)])
def test_flash_plain_at_bf16_matches_pallas_interpret(B, S, H, Hkv, D,
                                                      causal, window):
    rng = np.random.default_rng([B, S, H, Hkv, D, window])
    (q, jq), (k, jk), (v, jv) = (_bf16(rng, s) for s in (
        (B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    out = flash_attention(q, k, v, causal=causal, window=window)
    ref = jax_flash(jq, jk, jv, causal=causal, window=window, bq=128,
                    bk=128, interpret=True)
    assert out.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    assert out.shape == ref.shape
    assert rel_err(_np(out), _np(ref)) <= TOL


@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (2, 128, 4, 64, 32, 32), (1, 256, 2, 128, 64, 64),
    (2, 64, 8, 64, 16, 16), (2, 128, 4, 64, 32, 128)])
def test_ssd_plain_at_bf16_matches_pallas_interpret(B, S, H, P, N, chunk):
    rng = np.random.default_rng([B, S, H, P, N, chunk])
    (x, jx), (Bm, jB), (Cm, jC) = (_bf16(rng, s) for s in (
        (B, S, H, P), (B, S, H, N), (B, S, H, N)))
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = (-np.exp(0.3 * rng.standard_normal(H))).astype(np.float32)
    y, h = SK.ssd_scan_fwd(x, torch.from_numpy(dt), torch.from_numpy(A), Bm,
                           Cm, chunk=chunk)
    ref = jax_ssd(jx, jnp.asarray(dt), jnp.asarray(A), jB, jC, chunk=chunk,
                  interpret=True)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    assert ref.dtype == jnp.bfloat16
    assert rel_err(_np(y), _np(ref)) <= TOL


def test_wrappers_take_fp32_or_bf16_and_raise_otherwise():
    """q, k and v of one dtype among fp32 and bf16; x, B and C of one
    among them with dt and A fp32; anything else raises, naming its row,
    before any device dispatch."""
    t = lambda *s, dt=torch.bfloat16: torch.zeros(s, dtype=dt)
    assert FK.flash_attention_fwd(t(1, 2, 4, 8), t(1, 2, 4, 8),
                                  t(1, 2, 4, 8)).dtype == torch.bfloat16
    for q, k in ((t(1, 2, 4, 8), t(1, 2, 4, 8, dt=torch.float32)),
                 (t(1, 2, 4, 8, dt=torch.float16),) * 2):
        with pytest.raises(TypeError, match="row 11"):
            FK.flash_attention_fwd(q, k, k)
    x, Bm = t(1, 8, 2, 64), t(1, 8, 1, 16)
    dt, A = t(1, 8, 2, dt=torch.float32), t(2, dt=torch.float32)
    y, h = SK.ssd_scan_fwd(x, dt, A, Bm, Bm, chunk=4)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    for args in ((x, dt, A, Bm.float(), Bm), (x, dt.bfloat16(), A, Bm, Bm),
                 (x.half(), dt, A, Bm.half(), Bm.half())):
        with pytest.raises(TypeError, match="row 12"):
            SK.ssd_scan_fwd(*args, chunk=4)


def test_declared_costs_at_bf16():
    """Flash at bf16: its products one bf16 tensor-core operation each, at
    half the bytes; the SSD scan keeps its 3xTF32 operations with x, B, C
    and y at half the bytes (dt, a and h_final fp32)."""
    f32 = FK.attention_cost(8, 15, 5, 1024, 1024, 64, 64)
    b16 = FK.attention_cost(8, 15, 5, 1024, 1024, 64, 64, nbytes=2)
    assert b16.bf16_flops * 3 == f32.tc_flops and b16.tc_flops == 0
    assert b16.flops == f32.flops
    assert 2 * b16.bytes_read == f32.bytes_read
    s32 = SK.ssd_cost(8, 48, 1024, 64, 128, 256, G=1)
    s16 = SK.ssd_cost(8, 48, 1024, 64, 128, 256, G=1, nbytes=2)
    assert (s16.flops, s16.tc_flops) == (s32.flops, s32.tc_flops)
    assert s16.bytes_read < s32.bytes_read and \
        s16.bytes_written < s32.bytes_written
