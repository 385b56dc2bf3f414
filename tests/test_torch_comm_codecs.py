"""The communication-compression modules of the port against the JAX
package, at module level: the plain versions of the four codec kernels,
the codecs, the uplink transport, the byte accounting and the registry.

The same numpy inputs go through both packages; the JAX kernels run as the
JAX suite runs them on the CPU (Pallas in interpret mode, and their
``ref``).  Tolerances: the int8 codes and the packed sign bits bitwise;
every float output (FMA results, decodes) <= 1e-6 relative (max |a-b| over
max |b|) — interpret-mode Pallas and XLA may contract a multiply-add into
one FMA where the port rounds twice.  The error-feedback residual
``e - q * scale`` is a cancellation: there one ulp of ``q * scale`` (which
XLA folds into an FMA, and the port rounds) is up to 1/254 of max |e| away
from a residual whose largest entry is scale / 2, so residuals are held to
1e-6 of max |e|, the input they were computed from.  Inputs include exact
half-way products (round half to even) and signed zeros.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import rel_err
from repro.comm import codecs as JC
from repro.comm import transport as JT
from repro.configs import FedConfig as JaxFedConfig
from repro.configs import get_arch as jax_get_arch
from repro.core.flat import GroupSpec as JaxGroupSpec
from repro.core.flat import make_flat_spec as jax_make_flat_spec
from repro.kernels.comm import kernel as JK
from repro.kernels.comm import ref as JR
from repro.models.model import build_model as jax_build_model
from repro_torch import bridge
from repro_torch.comm import codecs as TC
from repro_torch.comm import transport as TT
from repro_torch.configs import FedConfig
from repro_torch.core.flat import GroupSpec, make_flat_spec
from repro_torch.kernels.comm import kernel as TK
from repro_torch.kernels.comm import ops as TO

TOL = 1e-6
ROWS = [8, 24, 264]
LOSSY = ["int8", "sign1bit", "topk"]


def _buf(rows, n_valid, seed, scale=1.0):
    """(rows, 128) fp32 with a zero tail past n_valid, like a flat group,
    plus exact half-way products for a power-of-two int8 scale and both
    signed zeros."""
    rng = np.random.default_rng(seed)
    g = (scale * rng.standard_normal((rows, 128))).astype(np.float32)
    flat = g.reshape(-1)
    flat[:8] = np.float32(scale) * np.array(
        [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 0.0, -0.0], np.float32) / 16
    flat[8] = 127.0 * np.float32(scale) / 16       # amax: scale / 16 * 127
    flat[n_valid:] = 0.0
    return g


def _cases():
    return [(rows, n) for rows in ROWS
            for n in sorted({rows * 128, rows * 128 - 77})]


def _int8_scalars(g):
    amax = np.float32(np.max(np.abs(g)))
    scale = np.float32(max(amax, np.float32(1e-30)) / np.float32(127.0))
    return np.float32(1.0) / scale, scale


def res_err(a, b, e) -> float:
    """max |a - b| of two residuals over max |e| of their input."""
    return rel_err(a, b) * float(np.max(np.abs(np.asarray(b)))) / float(
        np.max(np.abs(np.asarray(e))))


def _jax_interp_and_ref(kernel_fn, ref_fn, *args, **kw):
    return kernel_fn(*args, interpret=True, **kw), ref_fn(*args, **kw)


# ---------------------------------------------------------------------------
# the kernels' plain versions against the JAX kernels and their ref
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("with_error", [False, True])
@pytest.mark.parametrize("rows,n_valid", _cases())
def test_quantize_i8_plain_matches_jax(rows, n_valid, with_error):
    g = _buf(rows, n_valid, rows)
    inv, scale = _int8_scalars(g)
    assert scale == np.float32(1 / 16)     # the half-way products are exact
    port = TO.quantize_i8(torch.from_numpy(g), float(inv), float(scale),
                          with_error=with_error)
    for out in _jax_interp_and_ref(JK.quantize_i8_pass, JR.quantize_i8_ref,
                                   jnp.asarray(g), inv, scale,
                                   with_error=with_error):
        q_j, q_t = (out[0], port[0]) if with_error else (out, port)
        assert q_t.dtype == torch.int8
        np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
        if with_error:
            assert res_err(port[1], np.asarray(out[1]), g) <= TOL
    q = (port[0] if with_error else port).numpy().reshape(-1)
    np.testing.assert_array_equal(q[:8], [0, 2, 2, 0, -2, -2, 0, 0])
    assert q[8] == 127


@pytest.mark.parametrize("rows", ROWS)
def test_dequant_i8_fma_plain_matches_jax(rows):
    g = _buf(rows, rows * 128, rows + 1)
    inv, scale = _int8_scalars(g)
    q = np.asarray(JR.quantize_i8_ref(jnp.asarray(g), inv, scale))
    acc = _buf(rows, rows * 128, rows + 2)
    sw = np.float32(scale * np.float32(0.37))
    port = TO.dequant_i8_fma(torch.from_numpy(acc), torch.from_numpy(q),
                             float(sw))
    for out in _jax_interp_and_ref(JK.dequant_i8_fma_pass,
                                   JR.dequant_i8_fma_ref, jnp.asarray(acc),
                                   jnp.asarray(q), sw):
        assert rel_err(port, np.asarray(out)) <= TOL


@pytest.mark.parametrize("with_error", [False, True])
@pytest.mark.parametrize("rows,n_valid", _cases())
def test_sign_pack_plain_matches_jax(rows, n_valid, with_error):
    g = _buf(rows, rows * 128, rows + 3)       # nonzero past n_valid too
    mu = np.float32(np.abs(g.reshape(-1)[:n_valid]).sum() / n_valid)
    port = TO.sign_pack(torch.from_numpy(g), float(mu), n_valid,
                        with_error=with_error)
    for out in _jax_interp_and_ref(JK.sign_pack_pass, JR.sign_pack_ref,
                                   jnp.asarray(g), mu, n_valid,
                                   with_error=with_error):
        b_j, b_t = (out[0], port[0]) if with_error else (out, port)
        assert b_t.dtype == torch.uint8 and b_t.shape == (rows // 8, 128)
        np.testing.assert_array_equal(b_t.numpy(), np.asarray(b_j))
        if with_error:
            assert res_err(port[1], np.asarray(out[1]), g) <= TOL
            # past n_valid the residual is g itself
            np.testing.assert_array_equal(
                port[1].numpy().reshape(-1)[n_valid:],
                g.reshape(-1)[n_valid:])
    bits = (port[0] if with_error else port).numpy()
    assert bits[0, 6] & 1 and bits[0, 7] & 1        # +0.0 and -0.0 -> +1


@pytest.mark.parametrize("rows,n_valid", _cases())
def test_sign_unpack_fma_plain_matches_jax(rows, n_valid):
    rng = np.random.default_rng(rows)
    packed = rng.integers(0, 256, (rows // 8, 128)).astype(np.uint8)
    acc = _buf(rows, rows * 128, rows + 4)
    muw = np.float32(0.0123)
    port = TO.sign_unpack_fma(torch.from_numpy(acc), torch.from_numpy(packed),
                              float(muw), n_valid)
    for out in _jax_interp_and_ref(JK.sign_unpack_fma_pass,
                                   JR.sign_unpack_fma_ref, jnp.asarray(acc),
                                   jnp.asarray(packed), muw, n_valid):
        assert rel_err(port, np.asarray(out)) <= TOL
    np.testing.assert_array_equal(port.numpy().reshape(-1)[n_valid:],
                                  acc.reshape(-1)[n_valid:])


def test_fma_wrappers_update_in_place():
    rows = 24
    acc = torch.from_numpy(_buf(rows, rows * 128, 5))
    q = torch.randint(-127, 128, (rows, 128), dtype=torch.int8,
                      generator=torch.Generator().manual_seed(0))
    bits = torch.randint(0, 256, (rows // 8, 128), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(1))
    sw = torch.tensor([0.01])
    want = TK.dequant_i8_fma_pass(acc, q, sw)
    a = acc.clone()
    assert TK.dequant_i8_fma_pass(a, q, sw, out=a) is a
    assert torch.equal(a, want)
    want = TK.sign_unpack_fma_pass(acc, bits, sw, rows * 128 - 9)
    a = acc.clone()
    assert TK.sign_unpack_fma_pass(a, bits, sw, rows * 128 - 9, out=a) is a
    assert torch.equal(a, want)


def test_wrappers_check_their_inputs():
    g = torch.zeros((24, 128))
    before = TK.launch_counts()
    assert set(before) == {"quantize_i8_pass", "dequant_i8_fma_pass",
                           "sign_pack_pass", "sign_unpack_fma_pass"}
    with pytest.raises(ValueError, match="multiple of 8"):
        TK.sign_pack_pass(torch.zeros((12, 128)), torch.ones(1), 10)
    with pytest.raises(ValueError, match="n_valid"):
        TK.sign_pack_pass(g, torch.ones(1), 24 * 128 + 1)
    with pytest.raises(TypeError, match="int8"):
        TK.dequant_i8_fma_pass(g, torch.zeros((24, 128)), torch.ones(1))
    with pytest.raises(ValueError, match="shape"):
        TK.quantize_i8_pass(g, torch.ones(3))
    TK.quantize_i8_pass(g, torch.ones(2))
    assert TK.launch_counts() == before          # CPU calls launch nothing


# ---------------------------------------------------------------------------
# the codecs
# ---------------------------------------------------------------------------
def _groups(rows, n_valid):
    return (JaxGroupSpec(dtype="float32", leaves=(), size=n_valid,
                         rows=rows),
            GroupSpec(dtype=torch.float32, leaves=(), size=n_valid,
                      rows=rows))


def _jfed(**kw):
    return JaxFedConfig(fused_update=True, **kw)


def _tfed(**kw):
    return FedConfig(fused_update=True, **kw)


def _cmp_payload(name, tp, jp):
    if name == "int8":
        np.testing.assert_array_equal(tp["q"].numpy(), np.asarray(jp["q"]))
        assert float(tp["scale"]) == float(jp["scale"])      # amax exact
    elif name == "sign1bit":
        np.testing.assert_array_equal(tp["bits"].numpy(),
                                      np.asarray(jp["bits"]))
        assert rel_err(tp["mu"], np.asarray(jp["mu"])) <= TOL
    else:
        # the support away from ties at the k-th magnitude, the values
        # exactly (gathers); normal data has no ties here
        ti, ji = tp["indices"].numpy(), np.asarray(jp["indices"])
        assert set(ti.tolist()) == set(ji.tolist())
        t_order, j_order = np.argsort(ti), np.argsort(ji)
        np.testing.assert_array_equal(tp["values"].numpy()[t_order],
                                      np.asarray(jp["values"])[j_order])


@pytest.mark.parametrize("name", LOSSY)
@pytest.mark.parametrize("rows,n_valid", [(24, 24 * 128 - 77), (264, 33792)])
def test_codecs_match_jax(name, rows, n_valid):
    jg, tg = _groups(rows, n_valid)
    jc = JC.get_codec(name)(_jfed(topk_ratio=0.05))
    tc = TC.get_codec(name)(_tfed(topk_ratio=0.05))
    g = _buf(rows, n_valid, 40 + rows)
    res = 0.01 * _buf(rows, n_valid, 41 + rows)
    acc = _buf(rows, rows * 128, 42 + rows)
    w = np.float32(0.3)

    jp, tp = jc.encode(jg, jnp.asarray(g)), tc.encode(tg, torch.from_numpy(g))
    _cmp_payload(name, tp, jp)
    jd, td = jc.decode(jg, jp), tc.decode(tg, tp)
    assert rel_err(td, np.asarray(jd)) <= TOL
    assert not td.numpy().reshape(-1)[n_valid:].any()        # pad decodes 0
    jfma = jc.decode_fma(jg, jnp.asarray(acc), jp, w)
    tfma = tc.decode_fma(tg, torch.from_numpy(acc.copy()), tp,
                         torch.tensor(w))
    assert rel_err(tfma, np.asarray(jfma)) <= TOL

    e = g + res
    (jp, jr), (tp, tr) = (jc.encode_ef(jg, jnp.asarray(e)),
                          tc.encode_ef(tg, torch.from_numpy(e)))
    _cmp_payload(name, tp, jp)
    assert res_err(tr, np.asarray(jr), e) <= TOL
    # the fused residual is the generic definition e - decode(encode(e)),
    # rounded the same way in the port
    np.testing.assert_array_equal(tr.numpy(),
                                  e - tc.decode(tg, tp).numpy())


def test_none_codec_is_the_identity():
    jg, tg = _groups(8, 1000)
    g = torch.from_numpy(_buf(8, 1000, 3))
    c = TC.get_codec("none")(_tfed())
    assert not c.lossy and c.decode(tg, c.encode(tg, g)) is g
    assert c.payload_bytes(tg) == JC.get_codec("none")(_jfed()).payload_bytes(
        jg) == 4000


# ---------------------------------------------------------------------------
# the uplink transport
# ---------------------------------------------------------------------------
TREE_SHAPES = {"a": (40, 70), "b": (201,)}        # 3001 elements, 24 rows


def _specs():
    jspec = jax_make_flat_spec({k: jnp.zeros(s, jnp.float32)
                                for k, s in TREE_SHAPES.items()})
    tspec = make_flat_spec({k: torch.zeros(s) for k, s in TREE_SHAPES.items()})
    assert jspec.groups[0].rows == tspec.groups[0].rows == 24
    return jspec, tspec


@pytest.mark.parametrize("ef", [False, True], ids=["plain", "ef"])
@pytest.mark.parametrize("name", LOSSY)
def test_coded_aggregate_stacked_matches_jax(name, ef):
    """Cohort 4 with a w = 0 client (slot 2): its contribution is zero and,
    under error feedback, its residual stays bitwise unchanged."""
    jspec, tspec = _specs()
    rows, n = 24, tspec.groups[0].size
    cohort = 4
    g = np.stack([_buf(rows, n, 60 + k) for k in range(cohort)])
    w = np.array([3.0, 1.0, 0.0, 2.0], np.float32)
    res = (np.stack([0.02 * _buf(rows, n, 70 + k) for k in range(cohort)])
           if ef else None)
    jc = JC.get_codec(name)(_jfed(topk_ratio=0.05))
    tc = TC.get_codec(name)(_tfed(topk_ratio=0.05))
    jG, jres = JT.coded_aggregate_stacked(
        jc, jspec, [jnp.asarray(g)], jnp.asarray(w),
        None if res is None else (jnp.asarray(res),))
    t_res = None if res is None else (torch.from_numpy(res.copy()),)
    tG, tres = TT.coded_aggregate_stacked(tc, tspec, [torch.from_numpy(g)],
                                          torch.from_numpy(w), t_res)
    assert rel_err(tG[0], np.asarray(jG[0])) <= TOL
    if not ef:
        assert tres is None and jres is None
        return
    assert tres[0] is t_res[0]                     # updated in place
    assert res_err(tres[0], np.asarray(jres[0]), g + res) <= TOL
    np.testing.assert_array_equal(tres[0][2].numpy(), res[2])
    assert not np.array_equal(tres[0][0].numpy(), res[0])


@pytest.mark.parametrize("name", ["int8", "sign1bit"])
def test_client_coded_accumulate_matches_jax(name):
    jspec, tspec = _specs()
    rows, n = 24, tspec.groups[0].size
    g, acc = _buf(rows, n, 80), _buf(rows, rows * 128, 81)
    res = 0.02 * _buf(rows, n, 82)
    jc, tc = JC.get_codec(name)(_jfed()), TC.get_codec(name)(_tfed())
    for w in (np.float32(0.25), np.float32(0.0)):
        (ja,), (jr,) = JT.client_coded_accumulate(
            jc, jspec, (jnp.asarray(acc),), (jnp.asarray(g),), w,
            (jnp.asarray(res),))
        t_acc, t_res = torch.from_numpy(acc.copy()), torch.from_numpy(
            res.copy())
        (ta,), (tr,) = TT.client_coded_accumulate(
            tc, tspec, (t_acc,), (torch.from_numpy(g),), torch.tensor(w),
            (t_res,))
        assert ta is t_acc and tr is t_res                 # in place
        assert rel_err(ta, np.asarray(ja)) <= TOL
        assert res_err(tr, np.asarray(jr), g + res) <= TOL
    np.testing.assert_array_equal(tr.numpy(), res)        # w = 0: unchanged
    np.testing.assert_array_equal(ta.numpy(), acc)


def test_init_comm_state_matches_jax():
    jspec, tspec = _specs()
    j = JT.init_comm_state(_jfed(cohort=3), jspec)
    t = TT.init_comm_state(_tfed(cohort=3), tspec)
    assert len(t["residual"]) == len(j["residual"]) == 1
    assert t["residual"][0].shape == j["residual"][0].shape == (3, 24, 128)
    assert not t["residual"][0].any()


# ---------------------------------------------------------------------------
# the byte accounting and the registry
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def full_width_specs():
    """smollm-360m's flat layout in both packages, from shapes alone."""
    jm = jax_build_model(jax_get_arch("smollm-360m"), dtype=jnp.float32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    flat = {}
    bridge._walk(shapes, "", flat)
    named = {k: torch.empty(v.shape, device="meta") for k, v in flat.items()}
    return jax_make_flat_spec(shapes), make_flat_spec(named)


@pytest.mark.parametrize("name", ["none", *LOSSY])
@pytest.mark.parametrize("ratio", [0.01, 0.3])
def test_payload_bytes_match_jax(full_width_specs, name, ratio):
    jspec, tspec = full_width_specs
    assert tspec.groups[0].size == 361_821_120
    jc = JC.get_codec(name)(_jfed(topk_ratio=ratio))
    tc = TC.get_codec(name)(_tfed(topk_ratio=ratio))
    for jg, tg in zip(jspec.groups, tspec.groups):
        assert tc.payload_bytes(tg) == jc.payload_bytes(jg)
    assert (TT.comm_bytes_per_client(tc, tspec)
            == JT.comm_bytes_per_client(jc, jspec))
    if name == "int8":
        assert TT.comm_bytes_per_client(tc, tspec) == 361_821_124


def test_registry_matches_jax():
    assert TC.available_codecs() == JC.available_codecs() == (
        "int8", "none", "sign1bit", "topk")
    for get in (TC.get_codec, JC.get_codec):
        with pytest.raises(ValueError, match="unknown gradient codec "
                                             "'nope'.*registered"):
            get("nope")
    assert isinstance(TC.resolve_codec(_tfed(codec="int8")), TC.Int8Codec)
    assert isinstance(TC.resolve_codec(_tfed(), codec="topk"), TC.TopKCodec)


def test_registered_codec_is_resolved():
    @TC.register_codec("test_half")
    @dataclasses.dataclass
    class Half(TC.GradientCodec):
        fed: object = None
        name = "test_half"
    try:
        assert isinstance(TC.resolve_codec(_tfed(), codec="test_half"), Half)
        with pytest.raises(ValueError, match="already registered"):
            TC.register_codec("test_half")(Half)
    finally:
        TC._CODECS._items.pop("test_half")
