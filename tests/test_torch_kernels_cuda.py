"""Each CUDA kernel of the port against its plain PyTorch version, on the
card.  Every test needs an NVIDIA GPU and skips without one; the file
imports no JAX, so it runs on a machine that has only the port:

    python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Tolerance <= 1e-6 relative (max |a-b| over max |b|): the forward kernels
contract multiply-adds into FMAs where the plain version rounds twice; the
backward kernels round as the plain version does and their sums (fp64)
agree to fp32 rounding.  ``ssq``, ``dw`` and ``dscal`` are also checked
bitwise across two launches (no atomics).  The four codec kernels round
every operation as their plain versions do and are held to them bitwise,
on inputs with exact half-way products and signed zeros, with the pad
mask cutting inside a row, and in place.  The serving prefill's flash
attention and SSD scan have their tolerances stated beside their tests.
"""
import pytest
import torch

from _torch_parity import rel_err
from repro_torch.kernels.comm import kernel as CK
from repro_torch.kernels.comm import ref as CR
from repro_torch.kernels.fused_update import kernel as K
from repro_torch.kernels.fused_update import ops as O
from repro_torch.kernels.fused_update import ref as R

TOL = 1e-6
OPTS = ["sgd", "sgdm", "adam", "yogi"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [8, 264, 4104])
@pytest.mark.parametrize("cohort", [1, 4])
def test_aggregate_kernel_matches_plain(cuda_device, cohort, rows):
    gen = torch.Generator(device=cuda_device).manual_seed(rows)
    g = torch.randn((cohort, rows, 128), generator=gen, device=cuda_device)
    w = O.normalize_weights(torch.rand(cohort, generator=gen,
                                       device=cuda_device) + 0.5)
    n0 = K.aggregate_pass.launches
    G, ssq = K.aggregate_pass(g, w)
    G2, ssq2 = K.aggregate_pass(g, w)
    torch.cuda.synchronize()
    assert K.aggregate_pass.launches == n0 + 2
    RG, rssq = R.aggregate_ref(g, w)
    assert rel_err(G, RG) <= TOL
    assert abs(float(ssq) - float(rssq)) <= TOL * float(rssq)
    assert torch.equal(G, G2) and torch.equal(ssq, ssq2)   # no atomics


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [8, 4104])
def test_accumulate_kernel_matches_plain(cuda_device, rows):
    gen = torch.Generator(device=cuda_device).manual_seed(rows)
    acc, g = torch.randn((2, rows, 128), generator=gen, device=cuda_device)
    w = torch.tensor([0.37], device=cuda_device)
    out = K.accumulate_pass(acc, g, w)
    torch.cuda.synchronize()
    assert rel_err(out, R.accumulate_ref(acc, g, w[0])) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [8, 4099, 40003, 2_826_728])
def test_accumulate_kernel_in_place_equals_out_of_place(cuda_device, rows):
    """Row counts that end inside a block (4099, 40003), and the full width
    of smollm-360m; in place (``out=acc``, as the scan executor calls it)
    bitwise equal to out of place, both within 1e-6 of the plain
    version."""
    gen = torch.Generator(device=cuda_device).manual_seed(rows + 5)
    acc, g = torch.randn((2, rows, 128), generator=gen, device=cuda_device)
    w = torch.tensor([0.37], device=cuda_device)
    ref = R.accumulate_ref(acc, g, w[0])
    out = K.accumulate_pass(acc, g, w)
    n0 = K.accumulate_pass.launches
    same = K.accumulate_pass(acc, g, w, out=acc)
    torch.cuda.synchronize()
    assert same is acc and K.accumulate_pass.launches == n0 + 1
    assert rel_err(out, ref) <= TOL
    assert torch.equal(acc, out)


@pytest.mark.cuda
@pytest.mark.parametrize("opt", OPTS)
def test_update_kernel_matches_plain(cuda_device, opt):
    rows = 4104
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    G, p, m = torch.randn((3, rows, 128), generator=gen, device=cuda_device)
    v = torch.rand((rows, 128), generator=gen, device=cuda_device) + 1e-3
    m = m if opt != "sgd" else None
    v = v if opt in ("adam", "yogi") else None
    scal = torch.tensor([0.7, 0.05, 1.7, 1.2], device=cuda_device)
    outs = K.update_pass(G, p, m, v, scal, opt=opt)
    refs = R.update_ref(G, p, m, v, scal, opt=opt)
    torch.cuda.synchronize()
    for a, b in zip(outs, refs):
        assert (a is None) == (b is None)
        if a is not None:
            assert rel_err(a, b) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("opt", OPTS)
def test_update_kernel_bitwise_its_earlier_form(cuda_device, opt):
    """The streaming stores changed how update_pass moves its bytes, not
    its arithmetic: every instance is bitwise the kernel as it was before
    (form 0 of tools/csrc/update_forms.cu)."""
    import os
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools"))
    import update_forms as UF
    before = UF.launcher(UF.library().load(), opt, 0)
    rows = 4104
    gen = torch.Generator(device=cuda_device).manual_seed(17)
    G, p, m = torch.randn((3, rows, 128), generator=gen, device=cuda_device)
    v = torch.rand((rows, 128), generator=gen, device=cuda_device) + 1e-3
    m = m if opt != "sgd" else None
    v = v if opt in ("adam", "yogi") else None
    scal = torch.tensor([0.7, 0.05, 1.7, 1.2], device=cuda_device)
    got = K.update_pass(G, p, m, v, scal, opt=opt, **UF.HYPER)
    want = [None if t is None else torch.empty_like(p) for t in got]
    before(G, p, m, v, scal, *want)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [8, 4104])
def test_accumulate_bwd_kernel_matches_plain(cuda_device, rows):
    gen = torch.Generator(device=cuda_device).manual_seed(rows + 1)
    g, d = torch.randn((2, rows, 128), generator=gen, device=cuda_device)
    w = torch.tensor([0.37], device=cuda_device)
    dg, dw = K.accumulate_pass_bwd(g, w, d)
    dg2, dw2 = K.accumulate_pass_bwd(g, w, d)
    torch.cuda.synchronize()
    rdg, rdw = R.accumulate_bwd_ref(g, w[0], d)
    assert rel_err(dg, rdg) <= TOL and rel_err(dw, rdw) <= TOL
    assert torch.equal(dw, dw2) and torch.equal(dg, dg2)   # no atomics


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [8, 264, 4104])
@pytest.mark.parametrize("cohort", [1, 4, 11])
def test_aggregate_bwd_kernel_matches_plain(cuda_device, cohort, rows):
    """Cohort 11 runs two launches of the 8-client kernel."""
    gen = torch.Generator(device=cuda_device).manual_seed(rows + cohort)
    g = torch.randn((cohort, rows, 128), generator=gen, device=cuda_device)
    w = O.normalize_weights(torch.rand(cohort, generator=gen,
                                       device=cuda_device) + 0.5)
    G, dG = torch.randn((2, rows, 128), generator=gen, device=cuda_device)
    dssq = torch.tensor(0.3, device=cuda_device)
    dg, dw = K.aggregate_pass_bwd(g, w, G, dG, dssq)
    dg2, dw2 = K.aggregate_pass_bwd(g, w, G, dG, dssq)
    torch.cuda.synchronize()
    rdg, rdw = R.aggregate_bwd_ref(g, w, G, dG, dssq)
    assert rel_err(dg, rdg) <= TOL and rel_err(dw, rdw) <= TOL
    assert torch.equal(dw, dw2) and torch.equal(dg, dg2)


@pytest.mark.cuda
@pytest.mark.parametrize("opt", OPTS)
def test_update_bwd_kernel_matches_plain(cuda_device, opt):
    """Warm state; the last 5 rows zero-padded, which must give back exact
    zeros."""
    rows, pad = 4104, 5
    gen = torch.Generator(device=cuda_device).manual_seed(12)
    G, m, dp, dm, dv = torch.randn((5, rows, 128), generator=gen,
                                   device=cuda_device)
    v = torch.rand((rows, 128), generator=gen, device=cuda_device) * 0.01
    v += 1e-3
    for t in (G, m, v, dp, dm, dv):
        t[rows - pad:] = 0.0
    has_m, has_v = opt != "sgd", opt in ("adam", "yogi")
    args = (G, m if has_m else None, v if has_v else None,
            torch.tensor([0.7, 0.05, 2.1, 20.4], device=cuda_device), dp,
            dm if has_m else None, dv if has_v else None)
    outs = K.update_pass_bwd(*args, opt=opt)
    again = K.update_pass_bwd(*args, opt=opt)
    refs = R.update_bwd_ref(*args, opt=opt)
    torch.cuda.synchronize()
    for a, b in zip(outs[:3], refs[:3]):
        assert (a is None) == (b is None)
        if a is not None:
            assert rel_err(a, b) <= TOL
            assert not a[rows - pad:].any()
    for i in range(4):
        assert abs(float(outs[3][i] - refs[3][i])) <= \
            TOL * max(abs(float(refs[3][i])), 1e-30)
    assert torch.equal(outs[3], again[3])                  # no atomics


def _codec_input(rows, gen, dev):
    """Normal values with amax = 127 / 16, so the int8 scale is 1/16 and the
    products g * 16 below are exact half-way points; and +0.0, -0.0."""
    g = torch.randn((rows, 128), generator=gen, device=dev)
    g = g.clamp(-7.5, 7.5)
    g[0, :8] = torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 0.0, -0.0],
                            device=dev) / 16
    g[0, 8] = 127.0 / 16
    return g


@pytest.mark.cuda
@pytest.mark.parametrize("with_error", [False, True])
@pytest.mark.parametrize("rows", [8, 264, 4104])
def test_quantize_i8_kernel_matches_plain(cuda_device, rows, with_error):
    gen = torch.Generator(device=cuda_device).manual_seed(rows)
    g = _codec_input(rows, gen, cuda_device)
    for scal in ([16.0, 1 / 16], [1 / 0.0371, 0.0371]):
        scal = torch.tensor(scal, device=cuda_device)
        n0 = CK.quantize_i8_pass.launches
        out = CK.quantize_i8_pass(g, scal, with_error=with_error)
        ref = CR.quantize_i8_ref(g, scal, with_error=with_error)
        torch.cuda.synchronize()
        assert CK.quantize_i8_pass.launches == n0 + 1
        for a, b in zip(out, ref) if with_error else [(out, ref)]:
            assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [8, 264, 4104])
def test_dequant_i8_fma_kernel_matches_plain(cuda_device, rows):
    gen = torch.Generator(device=cuda_device).manual_seed(rows + 1)
    acc = torch.randn((rows, 128), generator=gen, device=cuda_device)
    q = torch.randint(-127, 128, (rows, 128), generator=gen,
                      device=cuda_device, dtype=torch.int8)
    sw = torch.tensor([0.0371 * 0.3], device=cuda_device)
    ref = CR.dequant_i8_fma_ref(acc, q, sw[0])
    assert torch.equal(CK.dequant_i8_fma_pass(acc, q, sw), ref)
    CK.dequant_i8_fma_pass(acc, q, sw, out=acc)             # in place
    torch.cuda.synchronize()
    assert torch.equal(acc, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("with_error", [False, True])
@pytest.mark.parametrize("cut", [0, 77])
@pytest.mark.parametrize("rows", [8, 264, 4104])
def test_sign_pack_kernel_matches_plain(cuda_device, rows, cut, with_error):
    gen = torch.Generator(device=cuda_device).manual_seed(rows + 2)
    g = _codec_input(rows, gen, cuda_device)
    n_valid = rows * 128 - cut
    mu = torch.tensor([0.7977], device=cuda_device)
    out = CK.sign_pack_pass(g, mu, n_valid, with_error=with_error)
    ref = CR.sign_pack_ref(g, mu[0], n_valid, with_error=with_error)
    torch.cuda.synchronize()
    for a, b in zip(out, ref) if with_error else [(out, ref)]:
        assert a.dtype == b.dtype and torch.equal(a, b)
    bits = out[0] if with_error else out
    assert int(bits[0, 6]) & 1 and int(bits[0, 7]) & 1     # +0.0, -0.0


@pytest.mark.cuda
@pytest.mark.parametrize("cut", [0, 77])
@pytest.mark.parametrize("rows", [8, 264, 4104])
def test_sign_unpack_fma_kernel_matches_plain(cuda_device, rows, cut):
    gen = torch.Generator(device=cuda_device).manual_seed(rows + 3)
    acc = torch.randn((rows, 128), generator=gen, device=cuda_device)
    bits = torch.randint(0, 256, (rows // 8, 128), generator=gen,
                         device=cuda_device, dtype=torch.uint8)
    n_valid = rows * 128 - cut
    muw = torch.tensor([0.7977 * 0.3], device=cuda_device)
    ref = CR.sign_unpack_fma_ref(acc, bits, muw[0], n_valid)
    assert torch.equal(CK.sign_unpack_fma_pass(acc, bits, muw, n_valid), ref)
    CK.sign_unpack_fma_pass(acc, bits, muw, n_valid, out=acc)   # in place
    torch.cuda.synchronize()
    assert torch.equal(acc, ref)


# ---------------------------------------------------------------------------
# The serving prefill's kernels: flash attention and the SSD scan.  Flash
# attention against its plain version at <= 1e-5 relative (an online
# softmax against a global one, fp32, a few ulps); the SSD scan against the
# chunked plain version at <= 1e-5 relative in every decay regime: both
# take the cumsum of a sequentially in index order (``torch.cumsum`` on the
# card sums along S in order), so the decays agree and only the products'
# summation orders differ, a few ulps.  The init's decay range (|acum| up
# to a few thousand within a chunk) leaves little state across a chunk;
# the slow decays (|a| about 0.01) carry it, at the prefill's own shape
# too.
# ---------------------------------------------------------------------------
from repro_torch.kernels.flash_attention import kernel as FK   # noqa: E402
from repro_torch.kernels.flash_attention import ref as FR      # noqa: E402
from repro_torch.kernels.ssd_scan import kernel as SK          # noqa: E402
from repro_torch.kernels.ssd_scan import ref as SR             # noqa: E402


@pytest.mark.cuda
@pytest.mark.parametrize("S,causal,window,G,D", [
    (1, True, 0, 1, 64), (63, False, 0, 3, 64), (128, True, 0, 3, 128),
    (1000, True, 256, 1, 64), (1025, False, 256, 3, 128),
    (1025, True, 0, 3, 64)])
def test_flash_attention_kernel_matches_plain(cuda_device, S, causal, window,
                                              G, D):
    gen = torch.Generator(device=cuda_device).manual_seed(S + D)
    Hkv, B = 2, 2
    q = torch.randn((B * Hkv * G, S, D), generator=gen, device=cuda_device)
    k, v = torch.randn((2, B * Hkv, S, D), generator=gen, device=cuda_device)
    n0 = FK.flash_attention_fwd.launches
    out = FK.flash_attention_fwd(q[None], k[None], v[None], causal=causal,
                                 window=window)[0]
    ref = FR.attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert FK.flash_attention_fwd.launches == n0 + 1
    assert rel_err(out, ref) <= 1e-5


@pytest.mark.cuda
def test_flash_attention_kernel_matches_plain_at_prefill_shape(cuda_device):
    """smollm-360m's prefill: B 8, 15 query and 5 key/value heads, S 1024,
    D 64, causal."""
    gen = torch.Generator(device=cuda_device).manual_seed(1024)
    q = torch.randn((8 * 15, 1024, 64), generator=gen, device=cuda_device)
    k, v = torch.randn((2, 8 * 5, 1024, 64), generator=gen,
                       device=cuda_device)
    out = FK.flash_attention_fwd(q[None], k[None], v[None], causal=True)[0]
    ref = FR.attention_ref(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert rel_err(out, ref) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("S,causal,window,D", [(1024, True, 0, 64),
                                               (100, False, 32, 128)])
def test_flash_attention_kernel_strided_views(cuda_device, S, causal, window,
                                              D):
    """The model's (B, S, H, D) tensors handed over as (B, H, S, D) views
    (as ``ops.flash_attention`` does), k and v slices of one projection
    buffer, against the same input folded and contiguous; the output in
    the model's layout."""
    from repro_torch.kernels.flash_attention import flash_attention
    gen = torch.Generator(device=cuda_device).manual_seed(S + 7)
    B, H, Hkv = 2, 6, 2
    q = torch.randn((B, S, H, D), generator=gen, device=cuda_device)
    kv = torch.randn((B, S, 2 * Hkv, D), generator=gen, device=cuda_device)
    k, v = kv[:, :, :Hkv], kv[:, :, Hkv:]
    out = flash_attention(q, k, v, causal=causal, window=window)
    fold = lambda t: t.transpose(1, 2).reshape(-1, S, D)
    folded = FK.flash_attention_fwd(fold(q)[None], fold(k)[None],
                                    fold(v)[None], causal=causal,
                                    window=window)[0]
    torch.cuda.synchronize()
    assert out.shape == (B, S, H, D) and out.is_contiguous()
    assert torch.equal(fold(out), folded)
    ref = FR.attention_ref(fold(q), fold(k), fold(v), causal=causal,
                           window=window)
    assert rel_err(folded, ref) <= 1e-5


@pytest.mark.cuda
def test_flash_attention_kernel_refuses_grad(cuda_device):
    q = torch.randn((1, 2, 8, 64), device=cuda_device, requires_grad=True)
    k = torch.randn((1, 2, 8, 64), device=cuda_device)
    with pytest.raises(RuntimeError, match="no backward"):
        FK.flash_attention_fwd(q, k, k)
    with pytest.raises(NotImplementedError, match="head dim"):
        FK.flash_attention_fwd(*(torch.randn((1, 2, 8, 32),
                                             device=cuda_device)
                                 for _ in range(3)))
    buf = torch.randn((1, 2, 8, 68), device=cuda_device)
    with pytest.raises(ValueError, match="16-byte"):
        FK.flash_attention_fwd(buf[..., 1:65], buf[..., :64], buf[..., :64])


@pytest.mark.cuda
@pytest.mark.parametrize("Dk,Dv", [(96, 96), (192, 128)])
@pytest.mark.parametrize("S,causal,window,G", [
    (1, True, 0, 1), (63, True, 0, 3), (100, False, 0, 1),
    (1000, True, 256, 3), (1025, True, 0, 1), (1025, False, 256, 3)])
def test_flash_attention_kernel_new_forms_match_plain(cuda_device, Dk, Dv, S,
                                                      causal, window, G):
    """phi3-mini's head dim 96 and MLA's Dk 192 / Dv 128, at ragged S,
    causal and not, windowed, group 1 and 3."""
    gen = torch.Generator(device=cuda_device).manual_seed(S + Dk)
    q = torch.randn((2 * 2 * G, S, Dk), generator=gen, device=cuda_device)
    k = torch.randn((2 * 2, S, Dk), generator=gen, device=cuda_device)
    v = torch.randn((2 * 2, S, Dv), generator=gen, device=cuda_device)
    n0 = FK.flash_attention_fwd.launches
    out = FK.flash_attention_fwd(q[None], k[None], v[None], causal=causal,
                                 window=window)[0]
    ref = FR.attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert FK.flash_attention_fwd.launches == n0 + 1
    assert out.shape == ref.shape == (2 * 2 * G, S, Dv)
    assert rel_err(out, ref) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("model,H,Hkv,Dk,Dv,S", [
    ("phi3-medium-14b", 40, 10, 128, 128, 1025),
    ("phi3-mini-3.8b", 32, 32, 96, 96, 1024),
    ("deepseek-v2-lite-16b", 16, 16, 192, 128, 1024)])
def test_flash_attention_kernel_at_served_heads(cuda_device, model, H, Hkv,
                                                Dk, Dv, S):
    """The served models' heads on the model's (B, S, H, D) views, B 2,
    causal: phi3-medium's GQA 40/10 (a ragged S), phi3-mini's 32 heads of
    96, deepseek's MLA form."""
    from repro_torch.kernels.flash_attention import flash_attention
    gen = torch.Generator(device=cuda_device).manual_seed(H + Dk)
    q = torch.randn((2, S, H, Dk), generator=gen, device=cuda_device)
    k = torch.randn((2, S, Hkv, Dk), generator=gen, device=cuda_device)
    v = torch.randn((2, S, Hkv, Dv), generator=gen, device=cuda_device)
    out = flash_attention(q, k, v, causal=True)
    fold = lambda t: t.transpose(1, 2).reshape(-1, S, t.shape[-1])
    ref = FR.attention_ref(fold(q), fold(k), fold(v), causal=True)
    torch.cuda.synchronize()
    assert out.shape == (2, S, H, Dv) and out.is_contiguous()
    assert rel_err(fold(out), ref) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("Dk,Dv", FK.FORMS)
@pytest.mark.parametrize("G", [1, 8])
@pytest.mark.parametrize("Sq,Skv", [(1, 1500), (63, 1500), (416, 1500),
                                    (1024, 1601), (1500, 1500)])
def test_flash_attention_kernel_noncausal_encoder_keys(cuda_device, Sq, Skv,
                                                       G, Dk, Dv):
    """Queries against an encoder's keys, as the cross layers and the
    encoder call it: non-causal, Sq != Skv (whisper's 1500 frames,
    llama-3.2-vision's 1601 patches, a ragged key tail), and S 1500 square
    (whisper's encoder), group 1 and 8, every form; nothing zero-padded."""
    gen = torch.Generator(device=cuda_device).manual_seed(Sq + Skv + Dk)
    q = torch.randn((2 * 2 * G, Sq, Dk), generator=gen, device=cuda_device)
    k = torch.randn((2 * 2, Skv, Dk), generator=gen, device=cuda_device)
    v = torch.randn((2 * 2, Skv, Dv), generator=gen, device=cuda_device)
    n0 = FK.flash_attention_fwd.launches
    out = FK.flash_attention_fwd(q[None], k[None], v[None], causal=False)[0]
    ref = FR.attention_ref(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert FK.flash_attention_fwd.launches == n0 + 1
    assert out.shape == ref.shape == (2 * 2 * G, Sq, Dv)
    assert rel_err(out, ref) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("Dk,Dv", [(192, 192), (128, 64), (96, 64), (32, 32)])
def test_flash_attention_kernel_refuses_other_forms(cuda_device, Dk, Dv):
    q, k = (torch.randn((1, 2, 8, Dk), device=cuda_device) for _ in range(2))
    v = torch.randn((1, 2, 8, Dv), device=cuda_device)
    n0 = FK.flash_attention_fwd.launches
    with pytest.raises(NotImplementedError, match="head dim"):
        FK.flash_attention_fwd(q, k, v)
    assert FK.flash_attention_fwd.launches == n0


def _ssd_inputs(gen, dev, B, S, H, G, N, regime):
    """"init": A from -1 to -16 (the model's init), dt = softplus(normal);
    "unit": |a| about 1; "slow": |a| about 0.01, the state carries."""
    x = torch.randn((B, S, H, 64), generator=gen, device=dev)
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, H), generator=gen, device=dev))
    A = (-torch.linspace(1.0, 16.0, H, device=dev) if regime == "init" else
         -torch.exp(0.3 * torch.randn(H, generator=gen, device=dev)))
    if regime == "slow":
        dt = dt * 0.01
    Bm, Cm = torch.randn((2, B, S, G, N), generator=gen,
                         device=dev)
    return x, dt, A, Bm, Cm


@pytest.mark.cuda
@pytest.mark.parametrize("S,chunk,G,N", [
    (128, 256, 2, 128), (256, 64, 2, 128), (1000, 256, 2, 128),
    (1025, 256, 2, 128), (1025, 64, 2, 128),
    # one chunk, two, and five with a ragged tail; N 16 (the smoke
    # config's, with its chunk 32), N not a multiple of 8 (padded with
    # zeros), N not a multiple of 4 (B and C loaded one float at a time);
    # G 1, 2 and 4 of 4 heads
    (1, 256, 1, 128), (63, 256, 4, 64), (200, 128, 1, 128),
    (300, 64, 4, 16), (150, 32, 2, 16), (100, 32, 4, 12), (130, 64, 1, 10),
    (257, 256, 4, 100)])
@pytest.mark.parametrize("init_range", [False, True])
def test_ssd_scan_kernel_matches_plain(cuda_device, S, chunk, G, N,
                                       init_range):
    """y and h_final against the chunked plain version at 1e-5: both take
    acum in fp32 in index order (torch.cumsum scans an outer axis so on
    the card), so only the products' summation orders differ."""
    gen = torch.Generator(device=cuda_device).manual_seed(S + chunk + N)
    x, dt, A, Bm, Cm = _ssd_inputs(gen, cuda_device, 2, S, 4, G, N,
                                   "init" if init_range else "unit")
    n0 = SK.ssd_scan_fwd.launches
    y, h = SK.ssd_scan_fwd(x, dt, A, Bm, Cm, chunk=chunk)
    ry, rh = SR.ssd_chunked_ref(x, dt, A, Bm, Cm, chunk)
    torch.cuda.synchronize()
    assert SK.ssd_scan_fwd.launches == n0 + 1
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    assert rel_err(y, ry) <= 1e-5 and rel_err(h, rh) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("L", [1, 32, 256])
def test_torch_cumsum_on_the_card_is_sequential_fp32(cuda_device, L):
    """What the kernel's acum relies on to meet the plain version at the
    init's decay range: torch.cumsum along S of (B, L, H) on the card
    equals the sum one position at a time in fp32, bit for bit."""
    gen = torch.Generator(device=cuda_device).manual_seed(L)
    dt = torch.nn.functional.softplus(
        torch.randn((8, L, 48), generator=gen, device=cuda_device))
    a = dt * -torch.linspace(1.0, 16.0, 48, device=cuda_device)
    assert torch.equal(torch.cumsum(a, dim=1), SR.sequential_cumsum(a, 1))


@pytest.mark.cuda
def test_ssd_scan_kernel_launches_per_call(cuda_device):
    """``launches`` counts calls; each call runs two device kernels (the
    states with C B^T, then the outputs)."""
    from torch.profiler import ProfilerActivity, profile
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    args = _ssd_inputs(gen, cuda_device, 2, 300, 4, 2, 128, "unit")
    SK.ssd_scan_fwd(*args, chunk=64)
    torch.cuda.synchronize()
    n0 = SK.ssd_scan_fwd.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        SK.ssd_scan_fwd(*args, chunk=64)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and "ssd_" in e.name]
    assert SK.ssd_scan_fwd.launches == n0 + 1
    assert SK.kernels_per_call() == 2 == len(names), names


@pytest.mark.cuda
@pytest.mark.parametrize("regime", ["init", "slow"])
def test_ssd_scan_kernel_matches_plain_at_prefill_shape(cuda_device, regime):
    """mamba2-780m's prefill: B 8, 48 heads, 1 group, S 1024, chunk 256."""
    gen = torch.Generator(device=cuda_device).manual_seed(1024)
    x, dt, A, Bm, Cm = _ssd_inputs(gen, cuda_device, 8, 1024, 48, 1, 128,
                                   regime)
    y, h = SK.ssd_scan_fwd(x, dt, A, Bm, Cm, chunk=256)
    ry, rh = SR.ssd_chunked_ref(x, dt, A, Bm, Cm, 256)
    torch.cuda.synchronize()
    assert rel_err(y, ry) <= 1e-5 and rel_err(h, rh) <= 1e-5


@pytest.mark.cuda
def test_ssd_scan_kernel_strided_views_and_grad(cuda_device):
    """Views of one (B, S, C) buffer, as the mamba block hands them over,
    and refusal of tensors that require grad."""
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    B, S, H, N = 2, 100, 4, 16
    buf = torch.randn((B, S, H * 64 + 2 * N), generator=gen,
                      device=cuda_device)
    x = buf[..., :H * 64].reshape(B, S, H, 64)
    Bm = buf[..., H * 64:H * 64 + N].reshape(B, S, 1, N)
    Cm = buf[..., H * 64 + N:].reshape(B, S, 1, N)
    dt = torch.rand((B, S, H), generator=gen, device=cuda_device)
    A = -torch.rand(H, generator=gen, device=cuda_device) - 0.5
    y, h = SK.ssd_scan_fwd(x, dt, A, Bm, Cm, chunk=32)
    ry, rh = SR.ssd_chunked_ref(x, dt, A, Bm, Cm, 32)
    torch.cuda.synchronize()
    assert rel_err(y, ry) <= 1e-5 and rel_err(h, rh) <= 1e-5
    with pytest.raises(RuntimeError, match="no backward"):
        SK.ssd_scan_fwd(x.clone().requires_grad_(), dt, A, Bm, Cm, chunk=32)


@pytest.mark.cuda
def test_training_path_launches_no_ssd_scan(cuda_device):
    """A stack with mamba layers trains through ``models/ssm.py::
    ssd_chunked`` (differentiable, plain PyTorch): its loss, gradient and
    a UGA client update on the card launch no SSD-scan kernel."""
    from repro_torch.configs import get_arch
    from repro_torch.core.client import uga_update
    from repro_torch.models.model import build_model
    model = build_model(get_arch("mamba2-780m-smoke"), loss_chunk=16)
    params = model.init(torch.Generator(device=cuda_device).manual_seed(0))
    toks = torch.randint(0, 512, (2, 17), device=cuda_device,
                         generator=torch.Generator(device=cuda_device)
                         .manual_seed(1))
    n0 = SK.ssd_scan_fwd.launches
    g, loss = uga_update(model.loss, params, {"tokens": toks}, 0.05,
                         local_steps=2)
    torch.cuda.synchronize()
    assert SK.ssd_scan_fwd.launches == n0
    assert torch.isfinite(loss) and all(bool(torch.isfinite(v).all())
                                        for v in g.values())


@pytest.mark.cuda
def test_all_failed_round_launches_no_update_pass(cuda_device):
    """A fused round whose every client crashed runs nothing: no fused-
    update kernel launches and the state keeps its bytes; the next,
    stepped round launches one aggregate and one update pass."""
    import numpy as np
    from repro_torch.configs import FedConfig
    from repro_torch.core.round import (draw_round, init_server_state,
                                        make_federated_round)
    from repro_torch.models.model import Model

    def loss(w, batch, rng=None):
        logits = torch.tanh(batch["x"] @ w["w1"]) @ w["w2"]
        return -torch.mean(torch.gather(torch.log_softmax(logits, -1), 1,
                                        batch["y"][:, None])), {}

    gen = torch.Generator(device=cuda_device).manual_seed(0)
    params = {"w1": 0.3 * torch.randn((10, 16), generator=gen,
                                      device=cuda_device),
              "w2": 0.3 * torch.randn((16, 4), generator=gen,
                                      device=cuda_device)}
    batch = {"x": torch.randn((4, 8, 10), generator=gen, device=cuda_device),
             "y": torch.randint(0, 4, (4, 8), generator=gen,
                                device=cuda_device)}
    meta = {"x": batch["x"][0], "y": batch["y"][0]}
    weights = torch.full((4,), 32.0, device=cuda_device)
    model = Model(name="mlp", init=None, loss=loss)
    for crash, want in ((1.0, 0), (0.0, 1)):
        # a deadline no client misses keeps the fault path on at crash 0
        fed = FedConfig(cohort=4, fused_update=True, fault_crash=crash,
                        round_deadline=100.0)
        state = init_server_state(model, fed, params=params)
        before = {k: v.clone() for k, v in state["params"].items()}
        K.reset_launch_counts()
        new, m = make_federated_round(model, fed)(
            state, batch, meta, weights, draw_round(fed, 0, 0, 4))
        torch.cuda.synchronize()
        counts = K.launch_counts()
        assert counts["update_pass"] == counts["aggregate_pass"] == want
        assert float(m["arrivals"]) == 4 * (1 - crash)
        if not want:
            for k, v in before.items():
                assert np.array_equal(new["params"][k].cpu().numpy().view(
                    np.uint32), v.cpu().numpy().view(np.uint32))


# ---------------------------------------------------------------------------
# The bf16 forms of both prefill kernels against their plain versions at
# bf16, max |a-b| over max |b| <= 1e-2: both compute in fp32 from the same
# bf16 inputs and round their outputs to bf16 (a step is 2^-8 of a value);
# flash also rounds its exponentials to bf16, the kernel relative to each
# key tile's running max and the plain version to the row's max.  JAX's
# own bf16 kernel tests hold 3e-2 (flash) and 6e-2 / 3e-2 (SSD).
# ---------------------------------------------------------------------------
BF16_TOL = 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("Dk,Dv", FK.FORMS)
@pytest.mark.parametrize("S,causal,window,G", [
    (1, True, 0, 1), (63, False, 0, 3), (128, True, 0, 3),
    (1000, True, 256, 1), (1025, False, 256, 3), (1025, True, 0, 1)])
def test_flash_attention_bf16_kernel_matches_plain(cuda_device, Dk, Dv, S,
                                                   causal, window, G):
    gen = torch.Generator(device=cuda_device).manual_seed(S + Dk + G)
    q = torch.randn((2 * 2 * G, S, Dk), generator=gen, device=cuda_device)
    k = torch.randn((2 * 2, S, Dk), generator=gen, device=cuda_device)
    v = torch.randn((2 * 2, S, Dv), generator=gen, device=cuda_device)
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    n0 = FK.flash_attention_fwd.launches
    out = FK.flash_attention_fwd(q[None], k[None], v[None], causal=causal,
                                 window=window)[0]
    ref = FR.attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert FK.flash_attention_fwd.launches == n0 + 1
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    assert rel_err(out.float(), ref.float()) <= BF16_TOL


@pytest.mark.cuda
def test_flash_attention_bf16_kernel_on_prefill_views(cuda_device):
    """smollm-360m's prefill at bf16 on the model's (B, S, H, D) views,
    and non-causal queries against 1500 encoder keys (whisper's cross)."""
    from repro_torch.kernels.flash_attention import flash_attention
    gen = torch.Generator(device=cuda_device).manual_seed(16)
    for (H, Hkv, Sq, Skv, causal) in ((15, 5, 1024, 1024, True),
                                      (20, 20, 416, 1500, False)):
        q = torch.randn((8, Sq, H, 64), generator=gen, device=cuda_device)
        k, v = torch.randn((2, 8, Skv, Hkv, 64), generator=gen,
                           device=cuda_device)
        q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
        out = flash_attention(q, k, v, causal=causal)
        fold = lambda t: t.transpose(1, 2).reshape(-1, t.shape[1], 64)
        ref = FR.attention_ref(fold(q), fold(k), fold(v), causal=causal)
        torch.cuda.synchronize()
        assert out.shape == (8, Sq, H, 64) and out.is_contiguous()
        assert rel_err(fold(out).float(), ref.float()) <= BF16_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("regime", ["init", "slow"])
@pytest.mark.parametrize("S,chunk,G,N,P", [
    (128, 256, 2, 128, 64), (1000, 64, 1, 128, 64), (1025, 256, 2, 64, 128),
    (100, 32, 1, 16, 64)])
def test_ssd_scan_bf16_kernel_matches_plain(cuda_device, S, chunk, G, N, P,
                                            regime):
    import torch.nn.functional as F
    gen = torch.Generator(device=cuda_device).manual_seed(S + N + P)
    B, H = 2, 4
    x = torch.randn((B, S, H, P), generator=gen, device=cuda_device)
    dt = F.softplus(torch.randn((B, S, H), generator=gen,
                                device=cuda_device))
    if regime == "init":
        A = -torch.linspace(1.0, 16.0, H, device=cuda_device)
    else:
        A = -torch.exp(0.3 * torch.randn(H, generator=gen,
                                         device=cuda_device))
        dt = dt * 0.01
    Bm, Cm = torch.randn((2, B, S, G, N), generator=gen, device=cuda_device)
    x, Bm, Cm = (t.to(torch.bfloat16) for t in (x, Bm, Cm))
    n0 = SK.ssd_scan_fwd.launches
    y, h = SK.ssd_scan_fwd(x, dt, A, Bm, Cm, chunk=chunk)
    ry, rh = SR.ssd_chunked_ref(x, dt, A, Bm, Cm, chunk)
    torch.cuda.synchronize()
    assert SK.ssd_scan_fwd.launches == n0 + 1
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    assert rel_err(y.float(), ry.float()) <= BF16_TOL
    assert rel_err(h, rh) <= BF16_TOL


@pytest.mark.cuda
def test_bf16_kernels_refuse_mixed_dtypes(cuda_device):
    bf = dict(dtype=torch.bfloat16, device=cuda_device)
    q = torch.randn((1, 2, 8, 64), **bf)
    with pytest.raises(TypeError, match="row 11"):
        FK.flash_attention_fwd(q, q.float(), q)
    x, Bm = torch.randn((1, 8, 2, 64), **bf), torch.randn((1, 8, 1, 16), **bf)
    dt = torch.rand((1, 8, 2), device=cuda_device)
    A = -torch.ones(2, device=cuda_device)
    with pytest.raises(TypeError, match="row 12"):
        SK.ssd_scan_fwd(x, dt, A, Bm.float(), Bm, chunk=4)
