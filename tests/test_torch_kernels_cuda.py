"""Each CUDA kernel of the port against its plain PyTorch version, on the
card.  Every test needs an NVIDIA GPU and skips without one; the file
imports no JAX, so it runs on a machine that has only the port:

    python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Tolerance <= 1e-6 relative (max |a-b| over max |b|): the kernels contract
multiply-adds into FMAs where the plain version rounds twice.  ``ssq`` is
also checked bitwise across two launches (no atomics).
"""
import pytest
import torch

from _torch_parity import rel_err
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
