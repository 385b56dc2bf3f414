"""A quick card check of the SSD scan: build, hold against the plain
version, time.

Builds ``src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu`` (``nvcc``,
``-Xptxas -v`` printed), holds ``ssd_scan_fwd`` against
``ref.ssd_chunked_ref`` at 1e-5 (max |a-b| over max |b|, y and h_final)
at twenty shapes (S 1 to 1025, chunk 32 to 256, G 1/2/4 of 4 heads, N 10
to 128, both decay regimes) and at the serving prefill's shape (mamba2-780m:
B 8, 48 heads, one group, S 1024, N 128, chunk 256), then times the call
there (CUDA events, 20 calls after 3 warm ones) and each of its device
kernels (torch.profiler, 5 calls).  Then head dim P = 128: four shapes
and one jamba mamba layer (B 1, 128 heads, one group, S 4096, N 128,
chunk 256) held to the plain version at 1e-5, each 64-column half
bitwise the P = 64 call on its columns, and the layer's call timed beside
its 3xTF32 bound (``ssd_cost``).  Last, the sha256 of y and h_final of
the P = 64 call at the prefill's shape on inputs from a generator seeded
12, in both decay regimes, with the torch and CUDA versions they were
taken under; ``--parent DIR`` builds the SSD source of another tree (a
``git archive`` of the parent commit) and holds this tree's P = 64 call
to it bitwise there.  The same checks run in ``chip_smoke.py`` phases 3b
and 5d, among everything else; this script takes a minute where the
smoke run takes fifteen.

Run on one card from the repo's root::

    python3 tools/ssd_check.py [--parent DIR]

It exits non-zero without a CUDA device or when a shape is off.
"""
from __future__ import annotations

import argparse
import hashlib
import os
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

TOL = 1e-5
SHAPES = [(1, 256, 1, 128), (63, 32, 2, 16), (128, 256, 2, 128),
          (1000, 256, 2, 128), (1025, 64, 4, 128), (1025, 256, 1, 64),
          (100, 32, 4, 12), (130, 64, 2, 10), (300, 256, 1, 100),
          (320, 64, 2, 16)]              # (S, chunk, G, N), 4 heads
P128_SHAPES = [(1, 256, 1, 128), (300, 64, 2, 16), (257, 256, 4, 100),
               (1025, 256, 1, 128)]
JAMBA_LAYER = dict(B=1, S=4096, H=128, G=1, N=128)   # chunk 256, P 128


def digest(*ts) -> str:
    h = hashlib.sha256()
    for t in ts:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tools/ssd_check.py")
    ap.add_argument("--parent", default=None,
                    help="another tree's root: hold this tree's P = 64 "
                         "call to that tree's kernel bitwise")
    args = ap.parse_args(argv)
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("ssd_check: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.device import strict_fp32
    from repro_torch.kernels.ssd_scan import kernel as SK
    from repro_torch.kernels.ssd_scan import ref as SR

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    strict_fp32()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "--id=0"],
                         capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    SK.LIB.build(True)
    print(SK.LIB.build_log.strip(), flush=True)
    print(f"device kernels per call: {SK.kernels_per_call()}")
    gen = torch.Generator(device=dev).manual_seed(0)

    def inputs(B, S, H, G, N, regime, P=64, g=None):
        g = gen if g is None else g
        x = torch.randn((B, S, H, P), generator=g, device=dev)
        dt = F.softplus(torch.randn((B, S, H), generator=g, device=dev))
        if regime == "init":
            A = -torch.linspace(1.0, 16.0, H, device=dev)
        else:
            A = -torch.exp(0.3 * torch.randn(H, generator=g, device=dev))
            dt = dt * 0.01
        Bm, Cm = torch.randn((2, B, S, G, N), generator=g, device=dev)
        return x, dt, A, Bm, Cm

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))

    bad = 0
    for regime in ("init", "slow"):
        for S, chunk, G, N in SHAPES:
            x, dt, A, Bm, Cm = inputs(2, S, 4, G, N, regime)
            y, h = SK.ssd_scan_fwd(x, dt, A, Bm, Cm, chunk=chunk)
            ry, rh = SR.ssd_chunked_ref(x, dt, A, Bm, Cm, chunk)
            torch.cuda.synchronize()
            ey, eh = rel(y, ry), rel(h, rh)
            ok = ey <= TOL and eh <= TOL and bool(torch.isfinite(y).all())
            bad += not ok
            print(f"{regime} S {S} chunk {chunk} G {G} N {N}: y {ey:.3e} "
                  f"h {eh:.3e} {'ok' if ok else 'OFF'}", flush=True)
    for regime in ("init", "slow"):
        x, dt, A, Bm, Cm = inputs(8, 1024, 48, 1, 128, regime)
        call = lambda: SK.ssd_scan_fwd(x, dt, A, Bm, Cm, chunk=256)
        y, h = call()
        ry, rh = SR.ssd_chunked_ref(x, dt, A, Bm, Cm, 256)
        torch.cuda.synchronize()
        ey, eh = rel(y, ry), rel(h, rh)
        bad += not (ey <= TOL and eh <= TOL)
        for _ in range(3):
            call()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            call()
        end.record()
        torch.cuda.synchronize()
        print(f"prefill shape, {regime} decays: y {ey:.3e} h {eh:.3e}; "
              f"{start.elapsed_time(end) / 20:.4f} ms a call", flush=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            call()
        torch.cuda.synchronize()
    times = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            k = e.name.replace("(anonymous namespace)::", "")
            k = k.replace("void ", "").split("(")[0]
            times[k] = times.get(k, 0.0) + e.time_range.elapsed_us() / 5
    print("; ".join(f"{k} {v:.1f} us" for k, v in times.items()))
    del x, dt, A, Bm, Cm, y, h, ry, rh

    # head dim 128: two 64-column passes sharing C B^T
    from repro_torch.roofline.analysis import bound_s
    for regime in ("init", "slow"):
        for S, chunk, G, N in P128_SHAPES:
            x, dt, A, Bm, Cm = inputs(2, S, 4, G, N, regime, P=128)
            y, h = SK.ssd_scan_fwd(x, dt, A, Bm, Cm, chunk=chunk)
            ry, rh = SR.ssd_chunked_ref(x, dt, A, Bm, Cm, chunk)
            halves = all(
                torch.equal(hy, y[..., p0:p0 + 64])
                and torch.equal(hh, h[..., p0:p0 + 64])
                for p0 in (0, 64)
                for hy, hh in [SK.ssd_scan_fwd(x[..., p0:p0 + 64], dt, A,
                                               Bm, Cm, chunk=chunk)])
            ey, eh = rel(y, ry), rel(h, rh)
            ok = ey <= TOL and eh <= TOL and halves
            bad += not ok
            print(f"P 128, {regime} S {S} chunk {chunk} G {G} N {N}: y "
                  f"{ey:.3e} h {eh:.3e}, halves bitwise P 64: {halves} "
                  f"{'ok' if ok else 'OFF'}", flush=True)
    j = JAMBA_LAYER
    kc = SK.ssd_cost(j["B"], j["H"], j["S"], 128, j["N"], 256, G=j["G"])
    b_s, by = bound_s(kc.bytes_read + kc.bytes_written, kc.flops,
                      kc.tc_flops)
    for regime in ("init", "slow"):
        x, dt, A, Bm, Cm = inputs(j["B"], j["S"], j["H"], j["G"], j["N"],
                                  regime, P=128)
        call = lambda: SK.ssd_scan_fwd(x, dt, A, Bm, Cm, chunk=256)
        y, h = call()
        ry, rh = SR.ssd_chunked_ref(x, dt, A, Bm, Cm, 256)
        torch.cuda.synchronize()
        ey, eh = rel(y, ry), rel(h, rh)
        bad += not (ey <= TOL and eh <= TOL)
        for _ in range(3):
            call()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            call()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / 20
        print(f"jamba layer (B 1, 128 heads, P 128, N 128, S 4096, chunk "
              f"256), {regime} decays: y {ey:.3e} h {eh:.3e}; {ms:.4f} ms a "
              f"call; 3xTF32 bound {b_s * 1e3:.4f} ms ({by}), "
              f"{b_s * 1e3 / ms:.1%} of it", flush=True)
        del x, dt, A, Bm, Cm, y, h, ry, rh

    # P = 64 at the prefill's shape: this tree's bits, and another tree's
    cuda_v = subprocess.run([os.path.join(os.environ.get(
        "CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"), "--version"],
        capture_output=True, text=True).stdout.strip().splitlines()[-1:]
    other = None
    if args.parent:
        from repro_torch.kernels._cuda import CudaLibrary
        other = CudaLibrary(
            "ssd_scan_parent", os.path.join(
                os.path.abspath(args.parent), "src", "repro_torch",
                "kernels", "ssd_scan", "csrc", "ssd_scan.cu"), SK._bind)
    for regime in ("init", "slow"):
        g = torch.Generator(device=dev).manual_seed(12)
        x, dt, A, Bm, Cm = inputs(8, 1024, 48, 1, 128, regime, g=g)
        y, h = SK.ssd_scan_fwd(x, dt, A, Bm, Cm, chunk=256)
        line = (f"P 64 prefill shape, {regime} decays, seed 12: y+h sha256 "
                f"{digest(y, h)} (torch {torch.__version__}, {cuda_v})")
        if other is not None:
            mine = SK.LIB
            try:
                SK.LIB = other
                py, ph = SK.ssd_scan_fwd(x, dt, A, Bm, Cm, chunk=256)
            finally:
                SK.LIB = mine
            same = torch.equal(py, y) and torch.equal(ph, h)
            bad += not same
            line += (f"; parent tree {digest(py, ph)}, bitwise "
                     f"{'equal' if same else 'DIFFERENT'}")
        print(line, flush=True)
    print(f"{bad} shape(s) off")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
