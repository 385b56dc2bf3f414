#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):

  1. the card's name and power limit (nvidia-smi);
  2. build the fused-update kernels from ``src/repro_torch`` with nvcc
     (``-Xptxas -v`` printed);
  3. hold each of the six kernels (three forward passes, three backward
     passes) against its plain PyTorch version, at the full-width shapes of
     smollm-360m (rows = 2,826,728) and at ragged small shapes, for every
     optimizer and with a nonzero ssq cotangent, to <= 1e-6 relative (max
     |a-b| over max |b|);
  4. check that the sums (the aggregate kernel's ||G||^2, the backward
     kernels' dw and dscal) are bitwise equal across two launches;
  5. time each kernel (CUDA events, warm, buffers far larger than the 50 MB
     L2) beside its byte bound, its plain version and one library call
     where a single PyTorch call computes the same function;
  6. the main path: ``repro_torch.launch.train.run_training`` on
     smollm-360m at full width (361,821,120 parameters), UGA + FedMeta,
     fused engine: 3 rounds each of vmap/sgd, scan/sgd and scan/adam with
     ``meta_mode='post'``, then 2 rounds each of the same three with
     ``meta_mode='through_aggregation'``.  The launch counts are zeroed
     just before each run and read just after, and must be exactly those
     of its path; every metric must be finite; vmap and scan must agree
     after round 1 to <= 1e-5 (params under post, ctrl under
     through_aggregation).  Then one unprofiled and one profiled vmap/sgd
     round for the device's busy time by kernel, its idle share and the
     host's time in operators;
  7. a reference check on a small input: the same trainer at smoke size on
     the card against the plain versions on the CPU, in both meta modes;
  8. one JSON line of per-kernel numbers, then the card line, then
     ``{"ok": true, "device": {...}}`` as the last line.

Exits 2 without a result when no CUDA device is present.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12         # H100 SXM, fp32 outside the tensor cores
TOL = 1e-6
FULL_ROWS = 2_826_728            # smollm-360m flat layout (rows, 128)
COHORT = 4
SOURCE = "src/repro_torch/kernels/fused_update/csrc/fused_update.cu"
REPLACES = {
    "aggregate_pass": "src/repro/kernels/fused_update/kernel.py:111",
    "accumulate_pass": "src/repro/kernels/fused_update/kernel.py:146",
    "update_pass": "src/repro/kernels/fused_update/kernel.py:241",
    "accumulate_pass_bwd": "src/repro/kernels/fused_update/kernel.py:180",
    "aggregate_pass_bwd": "src/repro/kernels/fused_update/kernel.py:293",
    "update_pass_bwd": "src/repro/kernels/fused_update/kernel.py:406",
}
OPTS = ("sgd", "sgdm", "adam", "yogi")


def log(*a):
    print(*a, flush=True)


def rel_err(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def max_abs_err(a, b) -> float:
    return float((a - b).abs().max())


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "--id=0"],
                         check=True, capture_output=True, text=True)
    return out.stdout.strip()


# ---------------------------------------------------------------------------
# phases 3-5: kernels against their plain versions, then timed
# ---------------------------------------------------------------------------
def check_kernels(K, R, O, dev, rows_list):
    import torch
    errs = {"aggregate_pass": 0.0, "accumulate_pass": 0.0, "update_pass": 0.0}
    gen = torch.Generator(device=dev).manual_seed(0)
    for rows in rows_list:
        for cohort in sorted({1, COHORT}):
            g = torch.randn((cohort, rows, 128), generator=gen, device=dev)
            w = O.normalize_weights(torch.rand(cohort, generator=gen,
                                               device=dev) + 0.5)
            G, ssq = K.aggregate_pass(g, w)
            RG, rssq = R.aggregate_ref(g, w)
            e = rel_err(G, RG)
            es = abs(float(ssq) - float(rssq)) / float(rssq)
            log(f"  aggregate_pass rows={rows} cohort={cohort}: rel {e:.3e}"
                f" ssq rel {es:.3e} (tol {TOL:g})")
            assert e <= TOL and es <= TOL, (rows, cohort, e, es)
            errs["aggregate_pass"] = max(errs["aggregate_pass"],
                                         max_abs_err(G, RG))
            G2, ssq2 = K.aggregate_pass(g, w)
            assert torch.equal(ssq, ssq2) and torch.equal(G, G2), \
                "aggregate_pass is not bitwise stable across launches"
            del g, G, RG, G2
        acc, g = torch.randn((2, rows, 128), generator=gen, device=dev)
        w = torch.tensor([0.37], device=dev)
        out = K.accumulate_pass(acc, g, w)
        ref = R.accumulate_ref(acc, g, w[0])
        e = rel_err(out, ref)
        log(f"  accumulate_pass rows={rows}: rel {e:.3e} (tol {TOL:g})")
        assert e <= TOL, (rows, e)
        errs["accumulate_pass"] = max(errs["accumulate_pass"],
                                      max_abs_err(out, ref))
        del acc, g, out, ref
        for opt in ("sgd", "sgdm", "adam", "yogi"):
            G, p = torch.randn((2, rows, 128), generator=gen, device=dev)
            m = (0.1 * torch.randn((rows, 128), generator=gen, device=dev)
                 if opt != "sgd" else None)
            v = (torch.rand((rows, 128), generator=gen, device=dev) * 0.01
                 + 1e-3 if opt in ("adam", "yogi") else None)
            scal = torch.tensor([0.7, 0.01, 1.7, 1.2], device=dev)
            outs = K.update_pass(G, p, m, v, scal, opt=opt)
            refs = R.update_ref(G, p, m, v, scal, opt=opt)
            for a, b in zip(outs, refs):
                if b is None:
                    assert a is None
                    continue
                e = rel_err(a, b)
                assert e <= TOL, (rows, opt, e)
                errs["update_pass"] = max(errs["update_pass"],
                                          max_abs_err(a, b))
            log(f"  update_pass[{opt}] rows={rows}: ok (tol {TOL:g})")
            del G, p, m, v, outs, refs
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return errs


def check_bwd_kernels(K, R, O, dev, rows_list):
    """Phases 3-4 for the three backward kernels: every output against the
    plain version (each sum relative to itself), the zero-padded tail rows
    exact zeros, and dw / dscal bitwise equal across two launches."""
    import torch
    errs = {"accumulate_pass_bwd": 0.0, "aggregate_pass_bwd": 0.0,
            "update_pass_bwd": 0.0}
    gen = torch.Generator(device=dev).manual_seed(2)

    def cmp(name, what, a, b):
        e = rel_err(a, b)
        assert e <= TOL, (name, what, a.shape, e)
        errs[name] = max(errs[name], max_abs_err(a, b))
        return e

    for rows in rows_list:
        g, d = torch.randn((2, rows, 128), generator=gen, device=dev)
        w = torch.tensor([0.37], device=dev)
        dg, dw = K.accumulate_pass_bwd(g, w, d)
        dw2 = K.accumulate_pass_bwd(g, w, d)[1]
        rdg, rdw = R.accumulate_bwd_ref(g, w[0], d)
        e = max(cmp("accumulate_pass_bwd", "dg", dg, rdg),
                cmp("accumulate_pass_bwd", "dw", dw, rdw))
        assert torch.equal(dw, dw2), "accumulate_pass_bwd: dw not bitwise"
        log(f"  accumulate_pass_bwd rows={rows}: rel {e:.3e} (tol {TOL:g})")
        del g, d, dg, rdg
        for cohort in sorted({1, COHORT}):
            gs = torch.randn((cohort, rows, 128), generator=gen, device=dev)
            wn = O.normalize_weights(torch.rand(cohort, generator=gen,
                                                device=dev) + 0.5)
            G, dG = torch.randn((2, rows, 128), generator=gen, device=dev)
            dssq = torch.tensor(0.3, device=dev)
            dg, dw = K.aggregate_pass_bwd(gs, wn, G, dG, dssq)
            dw2 = K.aggregate_pass_bwd(gs, wn, G, dG, dssq)[1]
            rdg, rdw = R.aggregate_bwd_ref(gs, wn, G, dG, dssq)
            e = max(cmp("aggregate_pass_bwd", "dg", dg, rdg),
                    cmp("aggregate_pass_bwd", "dw", dw, rdw))
            assert torch.equal(dw, dw2), "aggregate_pass_bwd: dw not bitwise"
            log(f"  aggregate_pass_bwd rows={rows} cohort={cohort} "
                f"dssq=0.3: rel {e:.3e} (tol {TOL:g})")
            del gs, G, dG, dg, rdg
            torch.cuda.empty_cache()
        pad = min(5, rows)
        for opt in OPTS:
            has_m, has_v = opt != "sgd", opt in ("adam", "yogi")
            G, dp = torch.randn((2, rows, 128), generator=gen, device=dev)
            m = dm = v = dv = None
            if has_m:
                m = 0.1 * torch.randn((rows, 128), generator=gen, device=dev)
                dm = torch.randn((rows, 128), generator=gen, device=dev)
            if has_v:
                v = (torch.rand((rows, 128), generator=gen, device=dev)
                     * 0.01 + 1e-3)
                dv = torch.randn((rows, 128), generator=gen, device=dev)
            for t in (G, dp, m, dm, v, dv):
                if t is not None:
                    t[rows - pad:] = 0.0          # a flat layout's zero pad
            scal = torch.tensor([0.7, 0.01, 1 / (1 - 0.9 ** 5),
                                 1 / (1 - 0.99 ** 5)], device=dev)
            args = (G, m, v, scal, dp, dm, dv)
            outs = K.update_pass_bwd(*args, opt=opt)
            dscal2 = K.update_pass_bwd(*args, opt=opt)[3]
            refs = R.update_bwd_ref(*args, opt=opt)
            e = 0.0
            for what, a, b in zip(("dG", "dm", "dv"), outs[:3], refs[:3]):
                assert (a is None) == (b is None), (opt, what)
                if a is not None:
                    e = max(e, cmp("update_pass_bwd", what, a, b))
                    assert not a[rows - pad:].any(), (opt, what, "pad")
            for i, what in enumerate(("dscale", "dlr", "dbc1", "dbc2")):
                e = max(e, cmp("update_pass_bwd", what, outs[3][i],
                               refs[3][i]))
            assert torch.equal(outs[3], dscal2), \
                f"update_pass_bwd[{opt}]: dscal not bitwise"
            log(f"  update_pass_bwd[{opt}] rows={rows}: rel {e:.3e} "
                f"(tol {TOL:g}), pad rows exact zeros")
            del G, dp, m, dm, v, dv, args, outs, refs
            torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return errs


def time_kernels(K, R, dev):
    import torch
    rows, n = FULL_ROWS, FULL_ROWS * 128
    f4 = 4.0
    gen = torch.Generator(device=dev).manual_seed(1)
    res = {}

    g = torch.randn((COHORT, rows, 128), generator=gen, device=dev)
    w = torch.full((COHORT,), 1.0 / COHORT, device=dev)
    b, by = bound_ms((COHORT + 1) * n * f4, (2 * COHORT + 2) * n)
    res["aggregate_pass"] = dict(
        ms=cuda_ms(lambda: K.aggregate_pass(g, w)),
        plain_ms=cuda_ms(lambda: R.aggregate_ref(g, w)),
        library_ms=cuda_ms(lambda: torch.tensordot(w, g, dims=1)),
        library="torch.tensordot(w, g, dims=1) (G only, no ssq)",
        bound_ms=b, bound_by=by, bytes=(COHORT + 1) * n * f4)
    del g
    torch.cuda.empty_cache()

    acc, g, out = torch.randn((3, rows, 128), generator=gen, device=dev)
    wk = torch.tensor([0.25], device=dev)
    b, by = bound_ms(3 * n * f4, 2 * n)
    res["accumulate_pass"] = dict(
        ms=cuda_ms(lambda: K.accumulate_pass(acc, g, wk, out=out)),
        plain_ms=cuda_ms(lambda: R.accumulate_ref(acc, g, wk[0])),
        library_ms=cuda_ms(lambda: torch.add(acc, g, alpha=0.25, out=out)),
        library="torch.add(acc, g, alpha=w, out=out)",
        bound_ms=b, bound_by=by, bytes=3 * n * f4)
    del acc, g, out
    torch.cuda.empty_cache()

    G, p, m = torch.randn((3, rows, 128), generator=gen, device=dev) * 0.1
    v = torch.rand((rows, 128), generator=gen, device=dev) * 0.01 + 1e-3
    scal = torch.tensor([1.0, 0.01, 1.0 / (1 - 0.9), 1.0 / (1 - 0.99)],
                        device=dev)
    b, by = bound_ms(3 * n * f4, 3 * n)
    sgd = dict(
        ms=cuda_ms(lambda: K.update_pass(G, p, None, None, scal, opt="sgd")),
        plain_ms=cuda_ms(lambda: R.update_ref(G, p, None, None, scal,
                                              opt="sgd")),
        library_ms=cuda_ms(lambda: torch.add(p, G, alpha=-0.01)),
        library="torch.add(p, G, alpha=-lr)", bound_ms=b, bound_by=by,
        bytes=3 * n * f4)
    b, by = bound_ms(7 * n * f4, 16 * n)
    step = torch.tensor(1.0, device=dev)
    pl, ml, vl = p.clone(), m.clone(), v.clone()
    adam = dict(
        ms=cuda_ms(lambda: K.update_pass(G, p, m, v, scal, opt="adam")),
        plain_ms=cuda_ms(lambda: R.update_ref(G, p, m, v, scal,
                                              opt="adam")),
        library_ms=(cuda_ms(lambda: torch._fused_adam_(
            [pl], [G], [ml], [vl], [], [step], lr=0.01, beta1=0.9,
            beta2=0.99, weight_decay=0.0, eps=1e-8, amsgrad=False,
            maximize=False)) if hasattr(torch, "_fused_adam_") else None),
        library="torch._fused_adam_ (in place)", bound_ms=b, bound_by=by,
        bytes=7 * n * f4)
    res["update_pass"] = adam
    res["update_pass[sgd]"] = sgd
    del G, p, m, v, pl, ml, vl
    torch.cuda.empty_cache()
    for name, r in res.items():
        lib = ("null" if r["library_ms"] is None
               else f"{r['library_ms']:.4f}")
        log(f"  {name}: {r['ms']:.4f} ms  bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}, {r['bytes'] / 1e9:.3f} GB, "
            f"{100 * r['bound_ms'] / r['ms']:.1f}% of bound)  plain "
            f"{r['plain_ms']:.4f} ms  library {lib} ms [{r['library']}]")
    return res


def time_bwd_kernels(K, R, dev):
    """Phase 5 for the backward kernels, at full width.  No single PyTorch
    call computes any of them (each returns a buffer and a reduction), so
    there is no library time."""
    import torch
    rows, n = FULL_ROWS, FULL_ROWS * 128
    f4 = 4.0
    gen = torch.Generator(device=dev).manual_seed(3)
    none = "none: no single PyTorch call computes it"
    res = {}

    g, d = torch.randn((2, rows, 128), generator=gen, device=dev)
    w = torch.tensor([0.25], device=dev)
    b, by = bound_ms(3 * n * f4, 3 * n)
    res["accumulate_pass_bwd"] = dict(
        ms=cuda_ms(lambda: K.accumulate_pass_bwd(g, w, d)),
        plain_ms=cuda_ms(lambda: R.accumulate_bwd_ref(g, w[0], d)),
        library_ms=None, library=none, bound_ms=b, bound_by=by,
        bytes=3 * n * f4)
    del g, d
    torch.cuda.empty_cache()

    gs = torch.randn((COHORT, rows, 128), generator=gen, device=dev)
    wn = torch.full((COHORT,), 1.0 / COHORT, device=dev)
    G, dG = torch.randn((2, rows, 128), generator=gen, device=dev)
    dssq = torch.tensor(0.3, device=dev)
    nbytes = (2 * COHORT + 2) * n * f4
    b, by = bound_ms(nbytes, (2 + 3 * COHORT) * n)
    res["aggregate_pass_bwd"] = dict(
        ms=cuda_ms(lambda: K.aggregate_pass_bwd(gs, wn, G, dG, dssq)),
        plain_ms=cuda_ms(lambda: R.aggregate_bwd_ref(gs, wn, G, dG, dssq)),
        library_ms=None, library=none, bound_ms=b, bound_by=by,
        bytes=nbytes)
    del gs, G, dG
    torch.cuda.empty_cache()

    G, m, dp, dm, dv = torch.randn((5, rows, 128), generator=gen,
                                   device=dev) * 0.1
    v = torch.rand((rows, 128), generator=gen, device=dev) * 0.01 + 1e-3
    scal = torch.tensor([1.0, 0.01, 1 / (1 - 0.9 ** 5), 1 / (1 - 0.99 ** 5)],
                        device=dev)
    b, by = bound_ms(9 * n * f4, 44 * n)
    adam = (G, m, v, scal, dp, dm, dv)
    res["update_pass_bwd"] = dict(
        ms=cuda_ms(lambda: K.update_pass_bwd(*adam, opt="adam")),
        plain_ms=cuda_ms(lambda: R.update_bwd_ref(*adam, opt="adam")),
        library_ms=None, library=none, bound_ms=b, bound_by=by,
        bytes=9 * n * f4)
    sgd = (G, None, None, scal, dp, None, None)
    b, by = bound_ms(3 * n * f4, 9 * n)
    res["update_pass_bwd[sgd]"] = dict(
        ms=cuda_ms(lambda: K.update_pass_bwd(*sgd, opt="sgd")),
        plain_ms=cuda_ms(lambda: R.update_bwd_ref(*sgd, opt="sgd")),
        library_ms=None, library=none, bound_ms=b, bound_by=by,
        bytes=3 * n * f4)
    del G, m, v, dp, dm, dv, adam, sgd
    torch.cuda.empty_cache()
    for name, r in res.items():
        log(f"  {name}: {r['ms']:.4f} ms  bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}, {r['bytes'] / 1e9:.3f} GB, "
            f"{100 * r['bound_ms'] / r['ms']:.1f}% of bound)  plain "
            f"{r['plain_ms']:.4f} ms  library {r['library']}")
    return res


def attention_bound(B=8, H=15, Hkv=5, S=128, D=64, nbytes=4):
    """One causal GQA flash-attention call (one layer) at smollm-360m's
    heads and the main path's client batch and sequence: q, k, v read once,
    o written once; per causal (query, key) pair 2D for q.k, 2D for p.v and
    4 for scale, max, exp and sum, over the fp32 rate (the port keeps fp32
    matrix products, no TF32)."""
    rw = (2 * B * H * S * D + 2 * B * Hkv * S * D) * nbytes
    pairs = B * H * S * (S + 1) // 2
    return rw, pairs * (4 * D + 4)


def ssd_bound(B=8, H=48, S=128, P=64, N=128, chunk=256, nbytes=4):
    """One Mamba2 SSD chunked-scan call (one layer) at mamba2-780m's widths
    (d_inner 3072 = 48 heads of 64, d_state 128, chunk 256) and the main
    path's client batch and sequence: x, dt, a, B, C read once and y
    written once.  Per head and chunk of L: the causal half of C.B^T and
    of M.(x dt) (2N + 2P + 3 a pair), the carried state's term (2NP + N a
    position) and the state update (2NP + N a position, NP a chunk)."""
    L = min(chunk, S)
    rw = B * H * S * (2 * P + 2 + 2 * N) * nbytes
    per_chunk = (L * (L + 1) // 2 * (2 * N + 2 * P + 3)
                 + L * (4 * N * P + 2 * N + P + 1) + N * P)
    return rw, B * H * (S // L) * per_chunk


def print_all_bounds():
    """Bounds of the twelve Pallas kernels, ported or not.  The fused-update
    and codec kernels at full width (fp32 flat buffers of FULL_ROWS rows,
    cohort 4, adam for the optimizer passes, error feedback on for the
    codecs): each input read once, each output written once, over the
    card's memory rate.  Flash attention and the SSD scan at one layer of
    the models that would run them: the larger of bytes over the memory
    rate and operations over the fp32 rate."""
    buf = FULL_ROWS * 128 * 4.0                   # one fp32 flat buffer
    i8, bits = buf / 4, buf / 32                  # int8 payload, sign bits
    rows = [
        ("1 aggregate_pass", COHORT * buf, buf),
        ("2 accumulate_pass", 2 * buf, buf),
        ("3 update_pass[adam]", 4 * buf, 3 * buf),
        ("3 update_pass[sgd]", 2 * buf, buf),
        ("4 accumulate_pass_bwd", 2 * buf, buf),
        ("5 aggregate_pass_bwd", (COHORT + 2) * buf, COHORT * buf),
        ("6 update_pass_bwd[adam]", 6 * buf, 3 * buf),
        ("6 update_pass_bwd[sgd]", 2 * buf, buf),
        ("7 quantize_i8_pass (+residual)", buf, i8 + buf),
        ("8 dequant_i8_fma_pass", buf + i8, buf),
        ("9 sign_pack_pass (+residual)", buf, bits + buf),
        ("10 sign_unpack_fma_pass", buf + bits, buf),
    ]
    for name, rd, wr in rows:
        log(f"  {name}: reads {rd / 1e9:.3f} GB, writes {wr / 1e9:.3f} GB,"
            f" bound {(rd + wr) / HBM_BYTES_PER_S * 1e3:.3f} ms")
    for name, (rw, ops) in (
            ("11 flash_attention_fwd (smollm-360m, B 8, 15/5 heads, S 128, "
             "D 64, fp32)", attention_bound()),
            ("12 ssd_scan_fwd (mamba2-780m, B 8, 48 heads, S 128, P 64, "
             "N 128, fp32)", ssd_bound())):
        b, by = bound_ms(rw, ops)
        log(f"  {name}: {rw / 1e6:.3f} MB, {ops / 1e9:.4f} GFLOP, bound "
            f"{b * 1e3:.3f} us ({by}) per layer call")


# ---------------------------------------------------------------------------
# phase 6: the main path
# ---------------------------------------------------------------------------
# Launch counts each main-path run must show: the vmap cohort reduces
# through one aggregate_pass per round, the scan cohort streams one
# accumulate_pass per client per round, and each round ends in one
# update_pass (one dtype group).  Under meta_mode='through_aggregation'
# the hypergradient adds one backward launch per forward launch: the scan
# cohort's backward re-runs each client and calls accumulate_pass_bwd on
# it.  The post-mode runs launch no backward kernel.
ROUNDS = 3                       # post-mode runs
TA_ROUNDS = 2                    # through-aggregation runs
KERNEL_NAMES = ("aggregate_pass", "accumulate_pass", "update_pass",
                "accumulate_pass_bwd", "aggregate_pass_bwd",
                "update_pass_bwd")


def _launches(**kw):
    return {name: kw.get(name, 0) for name in KERNEL_NAMES}


def _vmap_counts(r, bwd):
    return _launches(aggregate_pass=r, update_pass=r,
                     aggregate_pass_bwd=r if bwd else 0,
                     update_pass_bwd=r if bwd else 0)


def _scan_counts(r, bwd):
    return _launches(accumulate_pass=r * COHORT, update_pass=r,
                     accumulate_pass_bwd=r * COHORT if bwd else 0,
                     update_pass_bwd=r if bwd else 0)


EXPECTED_LAUNCHES = {
    "post:vmap/sgd": _vmap_counts(ROUNDS, False),
    "post:scan/sgd": _scan_counts(ROUNDS, False),
    "post:scan/adam": _scan_counts(ROUNDS, False),
    "through_aggregation:vmap/sgd": _vmap_counts(TA_ROUNDS, True),
    "through_aggregation:scan/sgd": _scan_counts(TA_ROUNDS, True),
    "through_aggregation:scan/adam": _scan_counts(TA_ROUNDS, True),
}


def main_path(K, dev):
    """Each of the six runs is its own main path: the launch counts are
    zeroed just before its ``run_training`` call and read just after."""
    import torch
    from repro_torch.core import flat as F
    from repro_torch.launch.train import run_training

    round1 = {}
    counts = {}
    runs = {}
    for tag, want in EXPECTED_LAUNCHES.items():
        mode, path = tag.split(":")
        strategy, opt = path.split("/")
        rounds = ROUNDS if mode == "post" else TA_ROUNDS
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        marks = [time.perf_counter()]

        def on_records(recs, trainer, tag=tag, mode=mode, opt=opt,
                       marks=marks):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            if recs[0]["round"] != 0 or opt != "sgd":
                return
            if mode == "post":
                params = trainer.state["params"]
                spec = F.make_flat_spec(params)
                round1[tag] = (spec, [b.clone() for b in
                                      F.flatten_tree(spec, params)])
            else:
                round1[tag] = {k: v.clone()
                               for k, v in trainer.state["ctrl"].items()}

        K.reset_launch_counts()
        state, hist = run_training(
            "smollm-360m", rounds=rounds, cohort=COHORT, client_batch=8,
            seq=128, algorithm="uga", meta=True, fused=True,
            strategy=strategy, server_opt=opt, meta_mode=mode, seed=0,
            log_every=1, device=dev, on_records=on_records)
        counts[tag] = K.launch_counts()
        log(f"kernels: {tag} {json.dumps(counts[tag])}")
        assert counts[tag] == want, (tag, counts[tag], want)
        n_params = sum(p.numel() for p in state["params"].values())
        assert n_params == 361_821_120, n_params
        for rec in hist:
            for k, v in rec.items():
                assert math.isfinite(v), (tag, rec)
            if mode != "post":
                assert rec["ctrl_w_gnorm"] > 0, (tag, rec)
        secs = [b - a for a, b in zip(marks, marks[1:])]
        peak = torch.cuda.max_memory_allocated() / 2**30
        runs[tag] = dict(round_wall_s=secs, peak_gib=peak)
        log(f"  {tag}: params {n_params:,}  round wall s "
            f"{[round(s, 4) for s in secs]} (round 0 includes init and "
            f"data)  max_memory_allocated {peak:.2f} GiB")
        del state
        torch.cuda.empty_cache()

    spec, a = round1["post:vmap/sgd"]
    _, b = round1["post:scan/sgd"]
    pa, pb = F.unflatten_tree(spec, a), F.unflatten_tree(spec, b)
    worst = max(rel_err(pa[k], pb[k]) for k in pa)
    log(f"  post: vmap vs scan params after round 1: rel {worst:.3e} "
        f"(tol 1e-5)")
    assert worst <= 1e-5, worst
    ca = round1["through_aggregation:vmap/sgd"]
    cb = round1["through_aggregation:scan/sgd"]
    for k in ("w_logits", "log_lr"):
        e = rel_err(cb[k], ca[k])
        log(f"  through_aggregation: vmap vs scan ctrl.{k} after round 1: "
            f"rel {e:.3e} (tol 1e-5); vmap {ca[k].tolist()}")
        assert e <= 1e-5, (k, e)
    return counts


def profile_round(dev):
    """Two steady vmap/sgd rounds at full width, the second under
    ``torch.profiler``: device busy time by kernel, the share of the
    fused-update kernels, the device's idle share of the profiled round,
    an estimate of it for the unprofiled round, and the host's operator
    calls by self CPU time."""
    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import FedConfig, get_arch
    from repro_torch.core.trainer import FederatedTrainer
    from repro_torch.launch.train import build_synthetic_fed_data
    from repro_torch.models.model import build_model

    cfg = get_arch("smollm-360m")
    fed = FedConfig(algorithm="uga", meta=True, cohort=COHORT,
                    client_lr=0.01, server_lr=0.01, meta_lr=0.01,
                    lr_decay=0.992, fused_update=True)
    trainer = FederatedTrainer(build_model(cfg, loss_chunk=256), fed,
                               device=dev)
    data = build_synthetic_fed_data(cfg, num_clients=32, examples=2048,
                                    seq=128, iid=False)
    kw = dict(cohort=COHORT, batch=8, meta_batch=16)
    trainer.run(data, rounds=1, **kw)                  # warm-up round
    torch.cuda.synchronize()
    t = time.perf_counter()
    trainer.run(data, rounds=2, **kw)                  # one unprofiled round
    torch.cuda.synchronize()
    plain_wall_us = (time.perf_counter() - t) * 1e6
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        trainer.run(data, rounds=3, **kw)              # one profiled round
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    by_name = collections.Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] += e.time_range.elapsed_us()
    busy_us = sum(by_name.values())
    ours = sum(v for k, v in by_name.items()
               if any(n in k for n in ("aggregate_kernel", "accumulate_kernel",
                                       "update_kernel", "reduce_partials")))
    log(f"  profiled round wall {wall_us / 1e3:.2f} ms; device busy "
        f"{busy_us / 1e3:.2f} ms (idle share of the profiled round "
        f"{100 * (1 - busy_us / wall_us):.1f}%); fused-update kernels "
        f"{ours / 1e3:.3f} ms ({100 * ours / max(busy_us, 1):.2f}% of busy)")
    # The profiler slows the host, not the device: the busy time over the
    # wall of the unprofiled round just before is an estimate of the idle
    # share without the profiler (two rounds, one process).
    log(f"  unprofiled round wall {plain_wall_us / 1e3:.2f} ms; estimated "
        f"idle share without the profiler "
        f"{100 * (1 - busy_us / plain_wall_us):.1f}%")
    for name, us in by_name.most_common(10):
        log(f"    {us / 1e3:9.3f} ms  {100 * us / busy_us:5.1f}%  {name[:90]}")
    assert busy_us > 0, "the profiler saw no device time"
    # The host side: time inside operators (dispatch and launch) against
    # the round's wall time; the rest is Python and torch.func between ops.
    avgs = sorted(prof.key_averages(), key=lambda a: a.self_cpu_time_total,
                  reverse=True)
    op_us = sum(a.self_cpu_time_total for a in avgs)
    n_aten = sum(a.count for a in avgs if a.key.startswith("aten::"))
    log(f"  host: {n_aten} aten operator calls; self CPU time in operators "
        f"{op_us / 1e3:.2f} ms ({100 * op_us / wall_us:.1f}% of wall); top:")
    for a in avgs[:8]:
        log(f"    {a.self_cpu_time_total / 1e3:9.3f} ms  {a.count:7d} calls  "
            f"{a.key[:70]}")


# ---------------------------------------------------------------------------
# phase 7: the card against the plain versions on a small input
# ---------------------------------------------------------------------------
def small_reference(dev):
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch.train import run_training
    from repro_torch.models.model import build_model

    params = build_model(get_arch("smollm-360m-smoke")).init(
        torch.Generator().manual_seed(3))
    for strategy, opt in (("vmap", "sgd"), ("scan", "adam")):
        out = {}
        for d in (dev, torch.device("cpu")):
            out[d.type] = run_training(
                "smollm-360m-smoke", rounds=3, cohort=2, client_batch=4,
                seq=32, num_clients=8, examples=64, fused=True,
                strategy=strategy, server_opt=opt, log_every=0, device=d,
                params=params)
        (sg, hg), (sc, hc) = out["cuda"], out["cpu"]
        for rg, rc in zip(hg, hc):
            for k in ("client_loss", "grad_norm", "meta_loss"):
                assert abs(rg[k] - rc[k]) <= 1e-4 * abs(rc[k]), (rg, rc)
        msg = "history <= 1e-4"
        if opt == "sgd":
            worst = max(rel_err(sg["params"][k].cpu(), sc["params"][k])
                        for k in sc["params"])
            assert worst <= 1e-5, worst
            msg += f", params rel {worst:.3e} (tol 1e-5)"
        log(f"  smoke {strategy}/{opt}, card vs CPU plain: {msg}")


def small_reference_through(dev):
    """Phase 7 under meta_mode='through_aggregation': vmap/sgd and a warm
    scan/adam (t = 5; a cold adam hypergradient is fp32 noise anywhere) at
    smoke size, the card against the CPU.  History (the hypergradient
    metrics among it) and ctrl <= 1e-4, params <= 1e-5."""
    import torch
    from repro_torch.configs import FedConfig, get_arch
    from repro_torch.core import flat as F
    from repro_torch.core.trainer import FederatedTrainer
    from repro_torch.launch.train import build_synthetic_fed_data
    from repro_torch.models.model import build_model

    cfg = get_arch("smollm-360m-smoke")
    model = build_model(cfg, loss_chunk=256)
    params = model.init(torch.Generator().manual_seed(3))
    rows = F.make_flat_spec(params).groups[0].rows
    gen = torch.Generator().manual_seed(4)
    m = 0.01 * torch.randn((rows, 128), generator=gen)
    v = 1e-3 * torch.rand((rows, 128), generator=gen) + 1e-4
    for strategy, opt in (("vmap", "sgd"), ("scan", "adam")):
        fed = FedConfig(algorithm="uga", meta=True, cohort=2, local_steps=2,
                        client_lr=0.01, server_lr=0.01, meta_lr=0.01,
                        server_opt=opt, cohort_strategy=strategy,
                        lr_decay=0.992, fused_update=True,
                        meta_mode="through_aggregation", ctrl_lr=0.01)
        out = {}
        for d in (dev, torch.device("cpu")):
            tr = FederatedTrainer(model, fed, device=d, params=params)
            if opt == "adam":
                tr.state["opt"] = {"m": (m.to(d),), "v": (v.to(d),),
                                   "t": torch.tensor(5, dtype=torch.int32,
                                                     device=d)}
            data = build_synthetic_fed_data(cfg, num_clients=8, examples=64,
                                            seq=32, iid=False)
            hist = tr.run(data, rounds=3, cohort=2, batch=4, meta_batch=8)
            out[d.type] = tr.state, hist
        (sg, hg), (sc, hc) = out["cuda"], out["cpu"]
        for rg, rc in zip(hg, hc):
            for k in rc:
                assert abs(rg[k] - rc[k]) <= 1e-4 * abs(rc[k]), (k, rg, rc)
        ce = max(rel_err(sg["ctrl"][k].cpu(), sc["ctrl"][k])
                 for k in ("w_logits", "log_lr"))
        pe = max(rel_err(sg["params"][k].cpu(), sc["params"][k])
                 for k in sc["params"])
        assert ce <= 1e-4 and pe <= 1e-5, (ce, pe)
        log(f"  smoke through_aggregation {strategy}/{opt}, card vs CPU "
            f"plain: history <= 1e-4, ctrl rel {ce:.3e} (tol 1e-4), params "
            f"rel {pe:.3e} (tol 1e-5)")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.device import strict_fp32
    from repro_torch.kernels.fused_update import kernel as K
    from repro_torch.kernels.fused_update import ops as O
    from repro_torch.kernels.fused_update import ref as R

    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    strict_fp32()
    card = card_line()
    log(f"[1] card: {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")

    tb = time.perf_counter()
    K.build(force=True)
    log(f"[2] built {os.path.relpath(K.SOURCE, HERE)} in "
        f"{time.perf_counter() - tb:.1f} s; nvcc -Xptxas -v:")
    log(K.build_log.strip())

    log("[3,4] kernels against their plain versions (ssq, dw, dscal bitwise "
        "across launches):")
    shapes = [8, 24, 264, 4104, FULL_ROWS]
    errs = check_kernels(K, R, O, dev, shapes)
    errs.update(check_bwd_kernels(K, R, O, dev, shapes))

    log("[5] kernel times at full width (CUDA events, 10 launches, warm):")
    times = time_kernels(K, R, dev)
    times.update(time_bwd_kernels(K, R, dev))
    log("[5b] bounds of the twelve Pallas kernels:")
    print_all_bounds()

    log(f"[6] main path: smollm-360m, UGA + FedMeta, fused; {ROUNDS} rounds "
        f"each in meta_mode='post', {TA_ROUNDS} in 'through_aggregation':")
    counts = main_path(K, dev)

    log("[6b] two vmap/sgd rounds at full width, the second under "
        "torch.profiler:")
    profile_round(dev)

    log("[7] small input, card against the CPU plain versions:")
    small_reference(dev)
    small_reference_through(dev)

    kernels = []
    for name in KERNEL_NAMES:
        t = times[name]
        by_path = {tag: c[name] for tag, c in counts.items()}
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name],
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    log(f"[8] done in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
