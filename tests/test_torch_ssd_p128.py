"""The SSD scan at head dim P = 128 (jamba's mamba layers: d_head 128,
d_state 128, chunk 256), which the CUDA kernel takes as two 64-column
passes over P sharing C B^T.

On the CPU: the wrapper's plain version at P = 128 against JAX's Pallas
kernel in interpret mode (y) and JAX's ``ssd_chunked`` (y and h_final),
and the kernel's chunk-parallel decomposition against the plain version,
at 1e-5 (max |a-b| over max |b|, ``tests/test_torch_ssd_scan.py``'s
tolerance); the declared cost at P = 128 as two P = 64 halves that share
C B^T and the P-free terms; a ``cuda`` trace charging one launch at P =
128 and refusing the P the kernel does not take, naming Queue 2 row 12.

On the card (marker ``cuda``, skipped without one): the kernel against
its plain version at P = 128, ragged tails, groups and state widths, at
1e-5 as the P = 64 cases of ``tests/test_torch_kernels_cuda.py``.  JAX is
imported only inside the CPU tests, so the card tests run where only the
port is installed:

    python -m pytest -q --noconftest -m cuda tests/test_torch_ssd_p128.py
"""
import numpy as np
import pytest
import torch

from _torch_parity import rel_err
from repro_torch.kernels.ssd_scan import kernel as K
from repro_torch.kernels.ssd_scan import ref as R

TOL = 1e-5


def _inputs(S, *, B=1, H=2, P=128, N=16, G=1, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = -np.exp(0.3 * rng.standard_normal(H)).astype(np.float32)
    Bm = rng.standard_normal((B, S, G, N), dtype=np.float32)
    Cm = rng.standard_normal((B, S, G, N), dtype=np.float32)
    return x, dt, A, Bm, Cm


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def test_plain_p128_matches_pallas_interpret_and_ssd_chunked():
    """S 64, chunk 32, N 16: y against the Pallas kernel in interpret
    mode, y and h_final against ``ssd_chunked`` (B and C per head, as
    JAX takes them)."""
    import jax.numpy as jnp

    from repro.kernels.ssd_scan.ops import ssd_scan as jax_pallas_ssd
    from repro.models import ssm as JS
    x, dt, A, Bm, Cm = _inputs(64, G=2)
    jx = [jnp.asarray(a) for a in (x, dt, A, Bm, Cm)]
    jy = jax_pallas_ssd(*jx, chunk=32, interpret=True)
    cy, ch = JS.ssd_chunked(*jx, 32)
    y, h = K.ssd_scan_fwd(*_t(x, dt, A, Bm, Cm), chunk=32)
    assert y.shape == (1, 64, 2, 128) and h.shape == (1, 2, 16, 128)
    assert rel_err(y, np.asarray(jy)) <= TOL
    assert rel_err(y, np.asarray(cy)) <= TOL
    assert rel_err(h, np.asarray(ch)) <= TOL


@pytest.mark.parametrize("S,G", [(64, 1), (50, 2)])
def test_chunk_parallel_p128_matches_plain(S, G):
    """The kernel's decomposition at P = 128 (its columns independent)
    against the chunked plain version, ragged S included."""
    x, dt, A, Bm, Cm = _t(*_inputs(S, H=4, G=G, seed=S))
    ry, rh = R.ssd_chunked_ref(x, dt, A, Bm, Cm, 32)
    y, h = R.ssd_chunk_parallel_ref(x, dt, A, Bm, Cm, 32,
                                    cumsum=torch.cumsum)
    assert rel_err(y, ry) <= TOL and rel_err(h, rh) <= TOL
    # each 64-column half is the P = 64 scan of its columns
    for p0 in (0, 64):
        hy, hh = R.ssd_chunked_ref(x[..., p0:p0 + 64].contiguous(), dt, A,
                                   Bm, Cm, 32)
        assert torch.equal(hy, ry[..., p0:p0 + 64])
        assert torch.equal(hh, rh[..., p0:p0 + 64])


@pytest.mark.parametrize("B,H,S,N,chunk,G", [
    (1, 128, 4096, 128, 256, 1),      # one jamba mamba layer at 4096
    (1, 128, 32768, 128, 256, 1),     # jamba x prefill_32k
    (2, 4, 300, 16, 64, 2)])
def test_ssd_cost_at_p128_is_two_halves_sharing_cb(B, H, S, N, chunk, G):
    """P = 128 declares two P = 64 passes less what they share: C B^T
    (taken once per group), the decays and masks, and the dt, B and C
    reads; h_final and y are written once each."""
    c64 = K.ssd_cost(B, H, S, 64, N, chunk, G=G)
    c128 = K.ssd_cost(B, H, S, 128, N, chunk, G=G)
    L = min(chunk, S)
    nc = -(-S // L)
    pairs = L * (L + 1) // 2
    cb = B * nc * G * pairs * 2 * N                 # C B^T, once a group
    p_free = B * nc * H * (3 * pairs + L * (2 * N + 1))
    assert c128.tc_flops == 2 * c64.tc_flops - 3.0 * cb
    assert c128.flops == 2 * c64.flops - p_free
    assert c128.bytes_read == 2 * c64.bytes_read - 4.0 * (
        B * H * S * 2 + B * G * S * 2 * N)
    assert c128.bytes_written == 2 * c64.bytes_written


def test_cuda_trace_takes_p128_and_refuses_other_p():
    """A ``cuda`` trace runs the wrapper's form checks: P = 128 charges
    one launch at ``ssd_cost``; P = 96 and 256 raise naming the row."""
    from repro_torch.roofline.cost import TensorSpec, trace_cost

    def spec(*shape):
        st = [1] * len(shape)
        for i in range(len(shape) - 2, -1, -1):
            st[i] = st[i + 1] * shape[i + 1]
        return TensorSpec(shape, torch.float32, torch.device("cuda"),
                          tuple(st))

    def call(P):
        args = (spec(1, 512, 4, P), spec(1, 512, 4), spec(4),
                spec(1, 512, 1, 128), spec(1, 512, 1, 128))
        return trace_cost(lambda *a: K.ssd_scan_fwd(*a, chunk=256), args,
                          device="cuda")

    cost, (y, h) = call(128)
    assert cost.launches == {"ssd_scan_fwd": 1}
    want = K.ssd_cost(1, 4, 512, 128, 128, 256, G=1)
    assert cost.tc_flops == want.tc_flops
    assert tuple(y.shape) == (1, 512, 4, 128)
    assert tuple(h.shape) == (1, 4, 128, 128)
    for P in (96, 256):
        with pytest.raises(NotImplementedError, match="row 12"):
            call(P)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("S,chunk,G,N", [
    (1, 256, 1, 128), (300, 64, 2, 16), (257, 256, 4, 100),
    (1024, 256, 1, 128)])
def test_ssd_kernel_p128_matches_plain(cuda_device, S, chunk, G, N):
    gen = torch.Generator(device=cuda_device).manual_seed(S + N)
    x = torch.randn((2, S, 4, 128), generator=gen, device=cuda_device)
    dt = torch.nn.functional.softplus(
        torch.randn((2, S, 4), generator=gen, device=cuda_device))
    A = -torch.linspace(1.0, 16.0, 4, device=cuda_device)
    Bm, Cm = torch.randn((2, 2, S, G, N), generator=gen,
                         device=cuda_device)
    n0 = K.ssd_scan_fwd.launches
    y, h = K.ssd_scan_fwd(x, dt, A, Bm, Cm, chunk=chunk)
    ry, rh = R.ssd_chunked_ref(x, dt, A, Bm, Cm, chunk)
    torch.cuda.synchronize()
    assert K.ssd_scan_fwd.launches == n0 + 1
    assert rel_err(y, ry) <= TOL and rel_err(h, rh) <= TOL
    # the halves are the P = 64 kernel on each half's columns, bitwise
    for p0 in (0, 64):
        hy, hh = K.ssd_scan_fwd(x[..., p0:p0 + 64], dt, A, Bm, Cm,
                                chunk=chunk)
        assert torch.equal(hy, y[..., p0:p0 + 64])
        assert torch.equal(hh, h[..., p0:p0 + 64])
