"""The port's cost model (``repro_torch.roofline``): the H100 hardware
model against the JAX package's ``roofline/analysis.py``, the fake-tensor
op counter (``roofline/cost.py``), the twelve kernel wrappers' declared
costs, and the smoke round traced on fake tensors.

Exact where the count is a formula: ``model_flops_per_round`` equals
JAX's for every arch and shape, the counter gives 2MNK for a product,
the wrappers charge ``PERF.md`` §6's bounds to the byte, and a traced
round's kernel launches are its path's.  The port's counted product FLOPs
of smollm-360m-smoke's round are held within [0.5, 2] of JAX's
trip-count-aware ``hlo_flops`` of the same round (one JAX compile, in a
module-scoped fixture; ``-s`` prints the ratio).  On a torch built
without CUDA a ``cuda`` trace runs on CPU stand-ins while the kernels
charge their declared costs (``roofline/cost.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode

import _torch_parity  # noqa: F401  (one torch thread)
from _torch_parity import SMOKE
from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import FedConfig as JaxFedConfig
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_arch as jax_get_arch
from repro.roofline.analysis import \
    model_flops_per_round as jax_model_flops
from repro_torch.configs import ARCHS, SHAPES, FedConfig, get_arch
from repro_torch.core.trainer import FederatedTrainer
from repro_torch.kernels.comm import kernel as CK
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.fused_update import kernel as K
from repro_torch.kernels.ssd_scan import kernel as SK
from repro_torch.launch.train import build_synthetic_fed_data
from repro_torch.models.model import build_model
from repro_torch.roofline import (FP32_FLOPS, HBM_BW, LINK_BW, TF32_FLOPS,
                                  TensorSpec, model_flops_per_round,
                                  roofline_terms, trace_cost)
from repro_torch.roofline.cost import HostReadError

ROWS = 2_826_728                    # smollm-360m's flat layout
BUF = ROWS * 128 * 4                # one fp32 flat buffer, bytes
CPU = torch.device("cpu")
FED = dict(algorithm="uga", meta=True, cohort=2, local_steps=2,
           client_lr=0.05, server_lr=0.05, meta_lr=0.05, fused_update=True)


def spec(shape, dtype=torch.float32):
    shape = tuple(shape)
    stride, acc = [], 1
    for d in reversed(shape):
        stride.insert(0, acc)
        acc *= d
    return TensorSpec(shape, dtype, torch.device("cuda"), tuple(stride))


def _real_launches():
    out = {}
    for m in (K, CK, FK, SK):
        out.update(m.launch_counts())
    return out


# ---------------------------------------------------------------------------
# the hardware model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_per_round_equals_jax(arch):
    assert set(ARCHS) == set(JAX_ARCHS)
    cfg, jcfg = get_arch(arch), jax_get_arch(arch)
    feds = [(None, None),
            (FedConfig(local_steps=3, meta=False),
             JaxFedConfig(local_steps=3, meta=False))]
    for name in SHAPES:
        for fed, jfed in feds:
            assert model_flops_per_round(cfg, SHAPES[name], fed) == \
                jax_model_flops(jcfg, JAX_SHAPES[name], jfed), (name, fed)


def test_roofline_terms_pick_the_bottleneck():
    assert (FP32_FLOPS, TF32_FLOPS, HBM_BW, LINK_BW) == \
        (67e12, 495e12, 3.35e12, 450e9)
    r = roofline_terms(67e12, 1e9, 0.0)
    assert r.bottleneck == "compute" and r.compute_s == pytest.approx(1.0)
    r = roofline_terms(1e9, 3.35e12, 1e6)
    assert r.bottleneck == "memory" and r.memory_s == pytest.approx(1.0)
    r = roofline_terms(1e9, 1e9, 450e9)
    assert r.bottleneck == "collective" \
        and r.collective_s == pytest.approx(1.0)
    # tensor-core operations at 495 TFLOP/s, the rest at fp32's 67
    r = roofline_terms(67e12 + 495e12, 0.0, 0.0, tc_flops_per_chip=495e12)
    assert r.compute_s == pytest.approx(2.0)
    r = roofline_terms(2e12, 1.0, 0.0, model_flops_global=4e12, chips=2)
    assert r.flops_ratio == pytest.approx(1.0)


# ---------------------------------------------------------------------------
# the counter
# ---------------------------------------------------------------------------
def test_counter_gives_2mnk_for_products_under_vmap_and_a_conv():
    B, M, Kd, N = 3, 5, 7, 11
    c, out = trace_cost(
        lambda x, w: torch.func.vmap(lambda a: a @ w)(x),
        (torch.randn(B, M, Kd), torch.randn(Kd, N)), device=CPU)
    assert c.flops == 2 * B * M * N * Kd and tuple(out.shape) == (B, M, N)
    c, _ = trace_cost(torch.bmm, (torch.randn(B, M, Kd),
                                  torch.randn(B, Kd, N)), device=CPU)
    assert c.flops == 2 * B * M * N * Kd
    assert c.bytes_read == 4 * (B * M * Kd + B * Kd * N)
    assert c.bytes_written == 4 * B * M * N
    x, k = torch.randn(2, 3, 8, 8), torch.randn(4, 3, 3, 3)
    c, out = trace_cost(lambda a, b: F.conv2d(a, b, padding=1), (x, k),
                        device=CPU)
    assert c.flops == 2 * out.numel() * 3 * 3 * 3
    assert c.tc_flops == 0 and not c.launches


def test_counter_charges_nothing_for_views():
    def views(x):
        return (x.view(6, 4), x.t(), x.unsqueeze(0).expand(3, 4, 6), x[1],
                x.reshape(24), x.transpose(0, 1)[::2])
    c, _ = trace_cost(views, (torch.randn(4, 6),), device=CPU)
    assert (c.flops, c.bytes, c.n_ops) == (0.0, 0.0, 0)
    assert c.memory["temp_size_in_bytes"] == 0
    assert c.memory["alias_size_in_bytes"] == 4 * 24


def test_counter_gives_the_peak_of_live_storages():
    N = 1000

    def seq(x):
        y = x * 2              # live: y
        z = y * 3              # live: y, z
        del y
        w = z + 1              # live: z, w
        del z
        return w.sum(), w[:10]
    c, _ = trace_cost(seq, (torch.randn(N),), device=CPU)
    assert c.memory == {"argument_size_in_bytes": 4 * N,
                        "output_size_in_bytes": 4 * N + 4,
                        "alias_size_in_bytes": 0,
                        "temp_size_in_bytes": 2 * 4 * N}
    assert c.bytes_written == 3 * 4 * N + 4


def test_a_trace_moves_no_generator_and_reads_no_value():
    torch.manual_seed(3)
    np.random.seed(3)
    t_state, n_state = torch.get_rng_state(), np.random.get_state()[1].copy()
    c, out = trace_cost(lambda x: x + torch.randn(x.shape),
                        (torch.ones(5),), device=CPU)
    assert torch.equal(torch.get_rng_state(), t_state)
    assert np.array_equal(np.random.get_state()[1], n_state)
    with pytest.raises(HostReadError, match="host"):
        trace_cost(lambda x: float(x.sum()), (torch.ones(3),), device=CPU)


# ---------------------------------------------------------------------------
# the twelve wrappers' declared costs: PERF.md §6's bounds
# ---------------------------------------------------------------------------
def _fused_calls():
    s3, s1 = spec((4, ROWS, 128)), spec((ROWS, 128))
    w4, w1, sc = spec((4,)), spec((1,)), spec((4,))
    d0 = spec(())
    return {
        "aggregate_pass": (lambda g, w: K.aggregate_pass(g, w), (s3, w4),
                           5 * BUF, 0, 0, [(ROWS, 128), ()]),
        "accumulate_pass": (lambda a, g, w: K.accumulate_pass(a, g, w),
                            (s1, s1, w1), 3 * BUF, 0, 0, [(ROWS, 128)]),
        "update_pass[adam]": (
            lambda G, p, m, v, s: K.update_pass(G, p, m, v, s, opt="adam"),
            (s1, s1, s1, s1, sc), 7 * BUF, 0, 0, [(ROWS, 128)] * 3),
        "update_pass[sgd]": (
            lambda G, p, s: K.update_pass(G, p, None, None, s, opt="sgd"),
            (s1, s1, sc), 3 * BUF, 0, 0, [(ROWS, 128)]),
        "accumulate_pass_bwd": (
            lambda g, w, d: K.accumulate_pass_bwd(g, w, d), (s1, w1, s1),
            3 * BUF, 0, 0, [(ROWS, 128), ()]),
        "aggregate_pass_bwd": (
            lambda g, w, G, dG, ds: K.aggregate_pass_bwd(g, w, G, dG, ds),
            (s3, w4, s1, s1, d0), 10 * BUF, 0, 0, [(4, ROWS, 128), (4,)]),
        "update_pass_bwd[adam]": (
            lambda G, m, v, s, dp, dm, dv: K.update_pass_bwd(
                G, m, v, s, dp, dm, dv, opt="adam"),
            (s1, s1, s1, sc, s1, s1, s1), 9 * BUF, 0, 0,
            [(ROWS, 128)] * 3 + [(4,)]),
        "update_pass_bwd[sgd]": (
            lambda G, s, dp: K.update_pass_bwd(G, None, None, s, dp, None,
                                               None, opt="sgd"),
            (s1, sc, s1), 3 * BUF, 0, 0, [(ROWS, 128), (4,)]),
        "quantize_i8_pass": (
            lambda g, s: CK.quantize_i8_pass(g, s, with_error=True),
            (s1, spec((2,))), 2 * BUF + BUF // 4, 0, 0,
            [(ROWS, 128), (ROWS, 128)]),
        "quantize_i8_pass[no residual]": (
            lambda g, s: CK.quantize_i8_pass(g, s), (s1, spec((2,))),
            BUF + BUF // 4, 0, 0, [(ROWS, 128)]),
        "dequant_i8_fma_pass": (
            lambda a, q, s: CK.dequant_i8_fma_pass(a, q, s),
            (s1, spec((ROWS, 128), torch.int8), w1), 2 * BUF + BUF // 4,
            0, 0, [(ROWS, 128)]),
        "sign_pack_pass": (
            lambda g, mu: CK.sign_pack_pass(g, mu, ROWS * 128,
                                            with_error=True),
            (s1, w1), 2 * BUF + BUF // 32, 0, 0,
            [(ROWS // 8, 128), (ROWS, 128)]),
        "sign_pack_pass[no residual]": (
            lambda g, mu: CK.sign_pack_pass(g, mu, ROWS * 128), (s1, w1),
            BUF + BUF // 32, 0, 0, [(ROWS // 8, 128)]),
        "sign_unpack_fma_pass": (
            lambda a, p, mu: CK.sign_unpack_fma_pass(a, p, mu, ROWS * 128),
            (s1, spec((ROWS // 8, 128), torch.uint8), w1),
            2 * BUF + BUF // 32, 0, 0, [(ROWS, 128)]),
        # the serving prefill of smollm-360m, one layer (B 8, 15/5 heads,
        # S 1024, D 64, causal): 83.9 MB, 48.4 GFLOP 3xTF32, 0.25 fp32
        "flash_attention_fwd": (
            lambda q, k, v: FK.flash_attention_fwd(q, k, v, causal=True),
            (spec((8, 15, 1024, 64)), spec((8, 5, 1024, 64)),
             spec((8, 5, 1024, 64))), 83_886_080, 251_904_000,
            48_365_568_000, [(8, 15, 1024, 64)]),
        # the serving prefill of mamba2-780m, one layer (B 8, 48 heads of
        # 64, one group, N 128, chunk 256): 225.4 MB, 19.912 GFLOP in fp32
        "ssd_scan_fwd": (
            lambda x, dt, A, B, C: SK.ssd_scan_fwd(x, dt, A, B, C,
                                                   chunk=256),
            (spec((8, 1024, 48, 64)), spec((8, 1024, 48)), spec((48,)),
             spec((8, 1024, 1, 128)), spec((8, 1024, 1, 128))),
            225_443_840, None, None, [(8, 1024, 48, 64), (8, 48, 128, 64)]),
    }


@pytest.mark.parametrize("name", list(_fused_calls()))
def test_wrapper_charges_its_bound_on_fake_tensors(name):
    fn, args, nbytes, flops, tc, shapes = _fused_calls()[name]
    before = _real_launches()
    c, out = trace_cost(fn, args, device="cuda")
    kern = name.split("[")[0]
    assert c.launches == {kern: 1}
    assert c.bytes_read + c.bytes_written == nbytes
    assert _real_launches() == before          # nothing launched for real
    outs = out if isinstance(out, tuple) else (out,)
    assert [tuple(o.shape) for o in outs if o is not None] == \
        [tuple(s) for s in shapes]
    if kern == "ssd_scan_fwd":
        # C.B^T once for the one group; fp32 form = fp32 + one product
        assert round((c.flops - c.tc_flops + c.tc_flops / 3) / 1e9, 3) \
            == 19.912
    else:
        assert (c.flops - c.tc_flops, c.tc_flops) == (flops, tc)


def test_fake_tensor_without_a_counter_raises():
    with FakeTensorMode():
        a = torch.empty(8, 128)
        with pytest.raises(RuntimeError, match="no cost counter"):
            K.accumulate_pass(a, a, torch.empty(1))


def test_wrapper_refuses_a_form_the_kernel_lacks():
    q = spec((1, 2, 16, 32))
    with pytest.raises(NotImplementedError, match="head dims"):
        trace_cost(lambda a, b, c: FK.flash_attention_fwd(a, b, c),
                   (q, q, q), device="cuda")


# ---------------------------------------------------------------------------
# the smoke round on fake tensors
# ---------------------------------------------------------------------------
PATHS = {
    "post vmap/sgd": (dict(), {"aggregate_pass": 1, "update_pass": 1}),
    "post scan/adam": (dict(cohort_strategy="scan", server_opt="adam"),
                       {"accumulate_pass": 2, "update_pass": 1}),
    "through_aggregation vmap/sgd": (
        dict(meta_mode="through_aggregation"),
        {"aggregate_pass": 1, "update_pass": 1, "aggregate_pass_bwd": 1,
         "update_pass_bwd": 1}),
    "through_aggregation scan/sgd": (
        dict(meta_mode="through_aggregation", cohort_strategy="scan"),
        {"accumulate_pass": 2, "update_pass": 1, "accumulate_pass_bwd": 2,
         "update_pass_bwd": 1}),
    "int8+ef scan/adam": (
        dict(codec="int8", error_feedback=True, cohort_strategy="scan",
             server_opt="adam"),
        {"quantize_i8_pass": 2, "dequant_i8_fma_pass": 2, "update_pass": 1}),
    "sign1bit vmap/sgd": (
        dict(codec="sign1bit"),
        {"sign_pack_pass": 2, "sign_unpack_fma_pass": 2, "update_pass": 1}),
}


def _smoke_round(**kw):
    cfg = get_arch(SMOKE)
    tr = FederatedTrainer(build_model(cfg, dtype=torch.float32,
                                      loss_chunk=256),
                          FedConfig(**{**FED, **kw}), seed=0, device="cpu")
    data = build_synthetic_fed_data(cfg, num_clients=8, examples=64,
                                    seq=32, iid=True, seed=0)
    staged = tr._stage([data.sample_round(0, cohort=2, batch=4, share=True)],
                       [data.sample_meta(0, 8)], [None])
    return tr, staged


@pytest.mark.parametrize("path", list(PATHS))
def test_smoke_round_traced_gives_its_paths_launches(path):
    kw, want = PATHS[path]
    tr, staged = _smoke_round(**kw)
    state0 = {k: v.clone() for k, v in tr.state["params"].items()}
    before = _real_launches()
    c, (new_state, metrics) = trace_cost(tr._cache(1), (tr.state, *staged),
                                         device="cuda")
    assert c.launches == want
    assert _real_launches() == before
    assert all(torch.equal(v, tr.state["params"][k])
               for k, v in state0.items())
    assert set(new_state["params"]) == set(state0)
    assert c.memory["argument_size_in_bytes"] > 0 and c.flops > 0


@pytest.fixture(scope="module")
def jax_round_flops():
    """JAX's trip-count-aware hlo_flops of the same smoke round, one
    compile."""
    from repro.configs import get_arch as jget
    from repro.core import FederatedTrainer as JaxTrainer
    from repro.core.rngtags import round_key
    from repro.launch.train import build_synthetic_fed_data as jdata
    from repro.models.model import build_model as jbuild
    from repro.roofline.live import compiled_cost_summary
    cfg = jget(SMOKE)
    tr = JaxTrainer(jbuild(cfg, dtype=jnp.float32, loss_chunk=256),
                    JaxFedConfig(**FED), seed=0)
    data = jdata(cfg, num_clients=8, examples=64, seq=32, iid=True, seed=0)
    staged = tr._stage_inputs(
        [data.sample_round(0, cohort=2, batch=4, share=True)],
        [data.sample_meta(0, 8)], [round_key(tr.key, 0)])
    absargs = jax.tree.map(
        lambda x: jax.ShapeDtypeStruct(jnp.shape(x), jnp.result_type(x)),
        (tr.state, *staged))
    return compiled_cost_summary(
        tr._cache(1).lower(*absargs).compile())["hlo_flops"]


def test_counted_flops_within_2x_of_jax_hlo_flops(jax_round_flops):
    tr, staged = _smoke_round()
    c, _ = trace_cost(tr._cache(1), (tr.state, *staged), device="cpu")
    ratio = c.flops / jax_round_flops
    print(f"smoke round: port {c.flops:.4e} FLOP, JAX hlo_flops "
          f"{jax_round_flops:.4e}, ratio {ratio:.4f}")
    assert 0.5 <= ratio <= 2.0, ratio
