#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):

  1. the card's name and power limit (nvidia-smi);
  2. build the fused-update and the codec kernels from ``src/repro_torch``,
     one nvcc for each source, both started together (``-Xptxas -v``
     printed);
  2b. the port's static analyzer, ``python -m repro_torch.analysis.fedlint
     src/repro_torch``, clean (exit 0);
  3. hold each of the six fused-update kernels (three forward passes, three
     backward passes) against its plain PyTorch version, at the full-width
     shapes of smollm-360m (rows = 2,826,728), at the paper models' (rows
     10,848, 13,208 and 31,648; ``aggregate_pass`` at cohort 10 too) and
     at ragged small shapes,
     for every optimizer and with a nonzero ssq cotangent, to <= 1e-6
     relative (max |a-b| over max |b|); and each of the four codec kernels
     bitwise, at the same shapes, with and without the residual, with the
     pad mask equal to and below the buffer, in place, on inputs with
     exact half-way products and signed zeros;
  4. check that the sums (the aggregate kernel's ||G||^2, the backward
     kernels' dw and dscal) are bitwise equal across two launches;
  5. time each kernel (CUDA events, warm, buffers far larger than the 50 MB
     L2) beside its byte bound, its plain version and one library call
     where a single PyTorch call computes the same function, each kernel
     in turns with its library call (``paired_ms``; ``accumulate_pass`` in
     place, the main path's form, and out of place); 5b: the bounds
     of all twelve Pallas kernels and the library time of flash attention
     at S 128 (scaled_dot_product_attention); 5c: the device time of
     one client's whole uplink for each lossy codec; 5p: rows 1-3 at the
     paper models' flat shapes, in turns with their library calls over
     input sets rotated past the L2, with the host's time to issue a
     call;
  6. the main path: ``repro_torch.launch.train.run_training`` on
     smollm-360m at full width (361,821,120 parameters), UGA + FedMeta,
     fused engine: vmap/sgd, scan/sgd and scan/adam with
     ``meta_mode='post'``, the same three with
     ``meta_mode='through_aggregation'``, then six runs with a lossy
     uplink codec (int8, sign1bit, topk; with and without error
     feedback); 1 round each, 2 for post vmap/sgd (its steady round) and
     for the runs with error feedback (the residual carry).  The launch
     counts of all ten kernels are zeroed just before each run and read
     just after, and must be exactly those of its path; every metric
     must be finite; coded runs report the exact ``comm_bytes`` and, with
     error feedback, a nonzero residual; vmap and scan must agree after
     round 1 to <= 1e-5 (params under post, ctrl under
     through_aggregation; int8 params under the flip-aware criterion of
     ``flip_aware``).  (The profiled vmap/sgd round is
     ``tools/profile_round.py``.)
  6o. the tracked run: phase 6's post vmap/sgd run again through
     ``run_training`` with ``tracker="jsonl,csv"``, a run directory, the
     round sanitizer and a ``torch.profiler`` window over round 1 with
     its trace summary: params and history bitwise phase 6's, launches
     equal; ``metrics.jsonl``'s records equal to the history, each
     round's sample_stack / dispatch / device_sync spans, the profiler
     and run events, the summary's keys, ``busy_frac`` in (0, 1), the
     aggregate and update kernels among its device ops, dispatch and
     device_sync among its phases, the csv header equal to
     ``round_metric_keys``, ``python -m repro_torch.obs report`` exit 0;
     the spans, the round walls, the trace's size, export and summary
     seconds, the top five device ops, and the probe's and the trackers'
     own cost printed.  Phase 6g holds its legacy vmap/sgd run to phase
     6's fused run too;
  6l. the live roofline and the dry run: phase 6's post vmap/sgd run
     again with ``roofline=True`` and the jsonl tracker, params and
     history bitwise phase 6's, launches equal, one ``roofline`` event
     with ``ROOFLINE_EVENT_KEYS``, its trace's launches one round's,
     ``python -m repro_torch.roofline.report`` exit 0; the predicted
     terms, predicted against measured rounds/s, ``analysis_s`` and the
     predicted memory against ``max_memory_allocated`` printed.  Traces
     without a run of post scan/adam, through_aggregation vmap/sgd and
     scan/adam, int8 + ef scan/adam and sign1bit + ef vmap/sgd (each in a
     process of its own, ``chip_smoke.py --trace-only TAG``, started
     before phase 6 and tracing beside it), each held to
     one round's launches, no allocation and no real launch; the dry run
     (``chip_smoke.py --dry-only``, started with them)
     (``repro_torch.launch.dryrun.run_one``) of smollm-360m on its four
     shapes and mamba2-780m on prefill_32k, flash charged 32 launches and
     the SSD scan 48, each record printed;
  6c. the chunked streaming cohort and the sharded executor at full
     width: smollm-360m, sgd, the paper's cohort of 10 in chunks of 4 (12
     slots, 2 of them weight-0 pads): post 2 rounds, through_aggregation
     1, int8 + error feedback 2 (the residual carry checked: every
     client's residual nonzero after each round, moved by round 1), and
     ``executor='sharded'`` on a world of one (NCCL) for 1 round, bitwise
     the chunked post run's round 0; launches held exactly (one
     accumulate pass, or one quantize and one dequant-FMA pass, per slot;
     one accumulate backward per slot under through_aggregation), round
     walls and peaks printed;
  6x, 6y. the model axis (tensor-parallel client compute) at full width,
     depth cut (``MODEL_AXIS_RUNS``): 6x smollm-360m at 8 of 32 layers,
     the paper's cohort of 10 (q/k/v gathered to whole heads, attention
     whole on both ranks); 6y the layer kinds at cohort 4:
     deepseek-v2-lite-16b at 1 layer (MLA on each rank's heads, 32 of
     the 64 experts a rank), mamba2-780m at 4 layers (the mixer on each
     rank's 24 heads), whisper-large-v3 at 2 decoder and 2 encoder layers
     over 1500 frames; 2 rounds in chunks of 2.  Each run's world of one
     in this process (``executor='sharded'``, NCCL), then all runs in
     turn on a (1, 2) mesh, two processes of one torchrun job on the one
     card (gloo, the mesh's shared-card rule), ``mesh_model=2``; after
     each round params within 1e-5 and metrics within 1e-4 of the world
     of one, the ranks' params bitwise equal (a 64-bit hash of the
     bits); each rank's launches held exactly (one accumulate pass a
     slot, one update pass a round on its half of the rows); deepseek's
     routing in one forward bitwise the world of one's; round walls,
     peaks and the time in the model-axis collectives printed.  The job
     is started before phase 7 and joined after it (phase 3 also holds
     rows 1-3 at each run's rank rows);
  6m. training through Mamba2 layers at full width: ``run_training`` on
     mamba2-780m (779,841,792 parameters), the same shape: vmap/sgd 2
     rounds and scan/sgd 1 (scan/adam does not fit the card:
     ``MAMBA_RUNS``),
     each held to exactly its cohort's
     fused-update launches and no SSD-scan launch (training runs the
     differentiable ``models/ssm.py::ssd_chunked``), finite metrics, vmap
     and scan within 1e-5 after round 1, the flat rows, the steady round
     wall and the peak printed;
  6f. the synchronous fault model at full width: smollm-360m vmap/sgd, 2
     rounds (a client failed in round 0 is retried in round 1),
     participation 0.75, the 'flaky' profile, a deadline of 3 and
     retry with backoff 1: each round's launches (one aggregate and one
     update pass, none when every client failed) and its participation
     and fault metrics held to what the round's draws give;
  6a. the buffered-async runtime at full width on smollm-360m: two
     synchronous scan/sgd runs of 2 rounds (does the card repeat a round
     bitwise?) and the fault-free async tick at K = capacity = cohort on
     the scan base against them (bitwise, or within the two runs' gap);
     the defaults (K 4, capacity 8, invsqrt) on vmap/sgd under
     participation 0.75 and 'flaky' with garble, 4 ticks, each tick's
     metrics and launches (one accumulate pass per flushed delta, one
     update pass per flush, no aggregate pass) held to ``simulate_tick``
     of its draws, its wall and the peak printed; int8 with error
     feedback on scan, 2 ticks (one quantize launch per client, no
     dequant-FMA launch);
  6k. checkpoints at full width: the post vmap/sgd and vmap/adam states
     after one round saved and restored through the trainer, bitwise,
     with the seconds and bytes; the full-width async state (an 11.58 GB
     pool leaf, past msgpack's bin32) refused before anything is written;
  6p. the paper's own models at their published widths: the CIFAR CNN,
     the FEMNIST CNN and the Shakespeare GRU, FedMeta w/ UGA through
     ``experiments/common.py::train_method``, cohort 10, 4 rounds each on
     the vmap cohort (the GRU 3; the CIFAR CNN also 2 on scan, held to
     vmap after round 0), the FEMNIST CNN also through all six methods, 2
     rounds
     each: each run's launches held to exactly its cohort's, finite
     evaluations, the flat rows, round walls, peaks and eval accuracy;
  7. a reference check on a small input: the same trainer at smoke size on
     the card against the plain versions on the CPU, in both meta modes
     and with int8 and sign1bit error feedback; (7c) the chunked cohort
     at chunks 1, 3 and 5 against one another, chunk 1 bitwise scan,
     chunk 5 against vmap, the sharded executor on a world of one
     bitwise chunk 3, chunk 3 against the CPU; mamba2-780m-smoke and
     jamba-1.5-large-398b-smoke in both meta modes (routing asserted
     equal first); under int8 error feedback a round whose clients all
     crashed (no launch, state bitwise unchanged) and one with a client
     crashed (its residual slot byte-identical); the async tick (vmap and
     scan, 'flaky' with garble) card against CPU, its sign1bit launches,
     an async save and resume on the card against a run that never
     stopped, (7r) ``roofline=True`` under participation 0.5, under the
     'flaky' fault profile and on the buffered-async engine, one event
     each and the first call's trace charging exactly the launches that
     call made, (7p) the paper CNN with dropout under the trainer's
     host draws and the GRU at smoke size, 3 rounds through
     ``train_method``, and (7o) the launcher's ``--sanitize`` on an async
     run whose payloads are all garbled by U(-inf, inf) raising
     ``SanitizeError`` (the same run unsanitized ends with non-finite
     parameters), a clean sanitized K = 2 run bitwise the unsanitized one
     on the card and within 1e-5 of the CPU's, and a profiled smoke
     round's trace categories;
  8. one JSON line of per-kernel numbers, then the card line, then
     ``{"ok": true, "device": {...}}`` as the last line.

The serving path (``repro_torch.launch.serve``) adds, beside these:

  3b. flash attention and the SSD scan against their plain versions on the
      card (flash at 192 shapes: S 1 to 1025, causal on and off, window 0
      and 256, group 1 and 3, each (Dk, Dv) form; non-causal at Sq !=
      Skv, queries against an encoder's keys (``CROSS_PAIRS``: (1, 1500),
      (63, 1500), (416, 1500), (1024, 1601)) and S 1500 square, group 1
      and 8, each form; the SSD scan at S 128 to 1025, chunk 256 and 64,
      y and h_final, at the init's decay range and at slow decays, and
      against the sequential recurrence at S <= 256; then at eight edge
      shapes, N 10 to 128, chunk 32 to 256, G 1, 2 and 4, and on strided
      views), then each at the prefill's shapes
      (the SSD scan in both decay regimes, so the state carried across
      chunks is held at full width); the SSD scan at head dim 128 on one
      jamba mamba layer (``SSD_JAMBA_LAYER``), each 64-column half bitwise
      the head-dim-64 call, and at head dim 64 the bits of the kernel
      before its head dim was tiled (``SSD_P64_DIGESTS``); flash at all
      four of its (Dk, Dv) forms, (96, 96) and (192, 128) beside (64,
      64) and (128, 128), and at every served prefill's call shape (``flash_calls``: the
      decoder-only models' causal S 1024, whisper-large-v3's encoder,
      decoder self- and cross-attention, llama-3.2-vision-90b's
      cross-attention);
  5d. their times at the prefill's shapes beside bound, plain and library
      (the SSD scan at head dim 128 too, on the jamba layer; flash
      attention on the prefill's (B, S, H, D) tensors, in turns
      with scaled_dot_product_attention on the same views); both bounds
      as the kernels compute, 3xTF32 on the tensor cores, and beside them
      fp32's; the device kernels one SSD call launches and their times
      (torch.profiler); flash at every served prefill's call shape in
      turns with scaled_dot_product_attention (``is_causal`` as the
      call), its bounds widened to Dk != Dv and to the Sq Skv pairs of a
      non-causal call; phase 5b keeps S 128's bounds and library time;
  6s. the serving main path: ``serve.main`` at full width on smollm-360m
      and mamba2-780m, batch 8, prompt 1024, 32 tokens, seed 0, greedy;
      the launch counts zeroed just before each run and read just after
      (flash 32 or SSD 48, none of rows 1-10); prefill wall, decode tok/s,
      peak memory (mamba2-780m's within 0.1 GiB of its 4.36 GiB);
  6t. at full width, the decode of token 1024 after prefill(1024) against
      the last logits of prefill(1025) (both kernels' ragged tails), with
      the launch counts of the prefill (one per layer) and of the decode
      step (none), and the warm prefill's wall, operations, rate and the
      kernel's share of it;
  6u. ``serve.main`` at full width on deepseek-v2-lite-16b (MoE + MLA,
      60.4 GiB of weights), minicpm-2b, phi3-mini-3.8b, phi3-medium-14b
      (batch 8, prompt 1024, 32 tokens) and whisper-large-v3 (32 encoder
      and 32 decoder layers, batch 8, 1500 encoder frames, prompt 416, 32
      tokens), each freed before the next: counts as in 6s (flash once a
      layer, the encoder's included: 64 for whisper), the warm prefill on
      a second init, its rate and flash's share, finite logits, peak
      memory; for deepseek the decode after prefill(256) against
      prefill(257), batch 2, on a dropless copy of the config
      (capacity_factor 11 >= E / K);
  7s. at smoke size, prefill logits, cache and 4 teacher-forced decode
      steps on the card against the CPU plain versions: smollm, mamba2,
      phi3-mini, llama4-scout (MoE, routing asserted equal first),
      deepseek's smoke config at head_dim 128, rope_head_dim 64 (MLA's
      prefill through flash at (192, 128), the absorbed decode), jamba's
      (the hybrid: the SSD scan and flash in one stack, routing asserted
      equal first), whisper's (encoder, cross-attention, sinusoidal
      positions) and llama-3.2-vision's at head_dim 64.

Exits 2 without a result when no CUDA device is present.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
import types

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))
# Phase 6c's int8 + error-feedback run holds a vmapped chunk of four
# full-width clients (55 GiB) beside a 13.5 GiB residual stack: with the
# default fixed-size segments its second round found 10 GiB reserved but
# unusable and ran out of memory.  Growable segments map what is asked.
# Set before torch first touches the card; a caller's setting stands.
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

TOL = 1e-6
FULL_ROWS = 2_826_728            # smollm-360m flat layout (rows, 128)
COHORT = 4
FULL_N_VALID = 361_821_120      # its true element count (the pad is 64)
SOURCES = {"fused_update": "src/repro_torch/kernels/fused_update/csrc/"
                           "fused_update.cu",
           "comm": "src/repro_torch/kernels/comm/csrc/comm.cu",
           "flash_attention": "src/repro_torch/kernels/flash_attention/csrc/"
                              "flash_attention.cu",
           "ssd_scan": "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu"}
REPLACES = {
    "aggregate_pass": "src/repro/kernels/fused_update/kernel.py:111",
    "accumulate_pass": "src/repro/kernels/fused_update/kernel.py:146",
    "update_pass": "src/repro/kernels/fused_update/kernel.py:241",
    "accumulate_pass_bwd": "src/repro/kernels/fused_update/kernel.py:180",
    "aggregate_pass_bwd": "src/repro/kernels/fused_update/kernel.py:293",
    "update_pass_bwd": "src/repro/kernels/fused_update/kernel.py:406",
    "quantize_i8_pass": "src/repro/kernels/comm/kernel.py:62",
    "dequant_i8_fma_pass": "src/repro/kernels/comm/kernel.py:94",
    "sign_pack_pass": "src/repro/kernels/comm/kernel.py:147",
    "sign_unpack_fma_pass": "src/repro/kernels/comm/kernel.py:192",
    "flash_attention_fwd": "src/repro/kernels/flash_attention/kernel.py:82",
    "ssd_scan_fwd": "src/repro/kernels/ssd_scan/kernel.py:65",
}
FLIP_FRACTION = 1e-3             # the flip-aware criterion (flip_aware)
FLIP_CAP = 1e-3
OPTS = ("sgd", "sgdm", "adam", "yogi")


def log(*a):
    print(*a, flush=True)


def rel_err(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def max_abs_err(a, b) -> float:
    return float((a - b).abs().max())


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Device time of one call, the mean over ``iters`` calls.  The start
    event is queued behind the warm-up calls, not after a synchronize: the
    card is busy when the host issues the first timed call, so a wrapper's
    host-side checks are not counted as device time where the host keeps
    ahead of the card."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float, tf32_flops: float = 0.0) -> tuple:
    """The larger of bytes over the memory rate and operations over their
    peak rates: ``flops`` at fp32's, ``tf32_flops`` at the TF32 tensor
    cores' (both kinds done, so their times add); the H100 SXM constants
    of ``repro_torch/roofline/analysis.py``."""
    from repro_torch.roofline.analysis import bound_s
    t, by = bound_s(nbytes, flops, tf32_flops)
    return t * 1e3, by


def kernel_bound(kc) -> tuple:
    """``bound_ms`` of a kernel's declared cost (``kernels/*/kernel.py``'s
    ``*_cost``: a ``KernelCost``)."""
    return bound_ms(kc.bytes_read + kc.bytes_written, kc.flops, kc.tc_flops)


def paired_ms(fn_a, fn_b, iters: int = 10) -> tuple:
    """Two functions timed in turns (a, b, b, a), each the mean of its two
    timings, after both have run a few times: a comparison within one call
    that neither a drift of the card's clocks nor a slow first pass over
    freshly allocated buffers favours."""
    cuda_ms(fn_a, 20, 0), cuda_ms(fn_b, 20, 0)
    a1, b1 = cuda_ms(fn_a, iters), cuda_ms(fn_b, iters)
    b2, a2 = cuda_ms(fn_b, iters), cuda_ms(fn_a, iters)
    return (a1 + a2) / 2, (b1 + b2) / 2


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "--id=0"],
                         check=True, capture_output=True, text=True)
    return out.stdout.strip()


def flip_aware(port, ref, *, ref_scale, cap, what) -> int:
    """The flip-aware criterion of the coded paths.  The codecs are
    discontinuous: a one-ulp difference in a client gradient moves an int8
    code by one step, or flips a sign, where it sits on a rounding
    boundary.  Elements off by more than 1e-5 * ``ref_scale`` are counted;
    at most FLIP_FRACTION of the elements may be, each off by at most
    ``cap``; every other element is held to 1e-5.  Returns the count."""
    diff = (port.double() - ref.double()).abs().reshape(-1)
    off = diff > 1e-5 * ref_scale
    n_off = int(off.sum())
    assert n_off <= FLIP_FRACTION * diff.numel(), (what, n_off)
    if n_off:
        worst = float(diff[off].max())
        assert worst <= cap, (what, worst, cap)
    return n_off


def params_flip_aware(port, ref, what) -> int:
    """Parameters: each leaf against its largest entry; a flip moves a
    parameter by the server step's response to one codec step, about 1e-4
    of the leaf's largest entry, and FLIP_CAP allows several."""
    n = 0
    for k in ref:
        scale = float(ref[k].abs().max())
        n += flip_aware(port[k], ref[k], ref_scale=scale,
                        cap=FLIP_CAP * scale, what=f"{what} {k}")
    return n


def residual_flip_aware(port, ref, codec, rounds, what) -> int:
    """Error-feedback residuals: e - decode(encode(e)) is a cancellation,
    held against the size of e (int8: |r| <= scale / 2 = amax(e) / 254); a
    flip moves it by one codec step (int8: scale; sign1bit: 2 mu), at most
    once a round."""
    r_max = float(ref.abs().max())
    return flip_aware(port, ref,
                      ref_scale=r_max * (254 if codec == "int8" else 1),
                      cap=rounds * 2 * r_max * (1 + 1e-5), what=what)


# ---------------------------------------------------------------------------
# phases 3-5: kernels against their plain versions, then timed
# ---------------------------------------------------------------------------
def check_kernels(K, R, O, dev, rows_list):
    import torch
    errs = {"aggregate_pass": 0.0, "accumulate_pass": 0.0, "update_pass": 0.0}
    gen = torch.Generator(device=dev).manual_seed(0)
    for rows in rows_list:
        paper = {PAPER_COHORT} if rows in PAPER_ROWS.values() else set()
        for cohort in sorted({1, COHORT} | paper):
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
    b, by = kernel_bound(K.aggregate_cost(COHORT, rows))
    ms, lib = paired_ms(lambda: K.aggregate_pass(g, w),
                        lambda: torch.tensordot(w, g, dims=1))
    res["aggregate_pass"] = dict(
        ms=ms, plain_ms=cuda_ms(lambda: R.aggregate_ref(g, w)),
        library_ms=lib,
        library="torch.tensordot(w, g, dims=1) (G only, no ssq)",
        bound_ms=b, bound_by=by, bytes=(COHORT + 1) * n * f4)
    del g
    torch.cuda.empty_cache()

    # accumulate_pass in place (out=acc, the scan executor's form: its
    # "ms") and out of place, each beside the library call of the same form
    acc, g, out = torch.randn((3, rows, 128), generator=gen, device=dev)
    wk = torch.tensor([0.25], device=dev)
    b, by = kernel_bound(K.accumulate_cost(rows))
    ms_in, lib_in = paired_ms(lambda: K.accumulate_pass(acc, g, wk, out=acc),
                              lambda: acc.add_(g, alpha=0.25))
    ms_out, lib_out = paired_ms(
        lambda: K.accumulate_pass(acc, g, wk, out=out),
        lambda: torch.add(acc, g, alpha=0.25, out=out))
    res["accumulate_pass"] = dict(
        ms=ms_in, plain_ms=cuda_ms(lambda: R.accumulate_ref(acc, g, wk[0])),
        library_ms=lib_in, library="acc.add_(g, alpha=w), in place",
        bound_ms=b, bound_by=by, bytes=3 * n * f4)
    log(f"  accumulate_pass in place (out=acc): {ms_in:.4f} ms, "
        f"{100 * b / ms_in:.1f}% of bound, acc.add_(g, alpha=w) "
        f"{lib_in:.4f} ms; out of place: {ms_out:.4f} ms, "
        f"{100 * b / ms_out:.1f}% of bound, torch.add(acc, g, alpha=w, "
        f"out=out) {lib_out:.4f} ms (turns kernel, library, library, kernel;"
        f" bound {b:.4f} ms)")
    del acc, g, out
    torch.cuda.empty_cache()

    G, p, m = torch.randn((3, rows, 128), generator=gen, device=dev) * 0.1
    v = torch.rand((rows, 128), generator=gen, device=dev) * 0.01 + 1e-3
    scal = torch.tensor([1.0, 0.01, 1.0 / (1 - 0.9), 1.0 / (1 - 0.99)],
                        device=dev)
    b, by = kernel_bound(K.update_cost("sgd", rows))
    ms, lib = paired_ms(
        lambda: K.update_pass(G, p, None, None, scal, opt="sgd"),
        lambda: torch.add(p, G, alpha=-0.01))
    sgd = dict(
        ms=ms, plain_ms=cuda_ms(lambda: R.update_ref(G, p, None, None, scal,
                                                     opt="sgd")),
        library_ms=lib,
        library="torch.add(p, G, alpha=-lr)", bound_ms=b, bound_by=by,
        bytes=3 * n * f4)
    b, by = kernel_bound(K.update_cost("adam", rows))
    step = torch.tensor(1.0, device=dev)
    pl, ml, vl = p.clone(), m.clone(), v.clone()
    kern = lambda: K.update_pass(G, p, m, v, scal, opt="adam")
    if hasattr(torch, "_fused_adam_"):
        ms, lib = paired_ms(kern, lambda: torch._fused_adam_(
            [pl], [G], [ml], [vl], [], [step], lr=0.01, beta1=0.9,
            beta2=0.99, weight_decay=0.0, eps=1e-8, amsgrad=False,
            maximize=False))
    else:
        ms, lib = cuda_ms(kern), None
    adam = dict(
        ms=ms, plain_ms=cuda_ms(lambda: R.update_ref(G, p, m, v, scal,
                                                     opt="adam")),
        library_ms=lib,
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


def time_paper_kernels(K, R, dev):
    """Rows 1-3 at the paper models' flat shapes (``PAPER_ROWS``),
    ``aggregate_pass`` at cohort 10: each in turns with its library call
    (``paired_ms``, 100 launches), over input sets rotated so that the
    sets together exceed 200 MB and no launch finds its inputs in the
    50 MB L2, as a round's first touch of the flat buffers does not.  At
    these sizes a call's device work is shorter than the host's time to
    issue it, so the events measure the host's rate: beside them the
    host's issue time and the device kernels' own time (torch.profiler,
    20 calls).  Returns {kernel: {rows: numbers}}."""
    import itertools
    import torch
    gen = torch.Generator(device=dev).manual_seed(4)
    res = {"aggregate_pass": {}, "accumulate_pass": {},
           "update_pass[sgd]": {}}
    f4 = 4.0

    def sets_of(make, nbytes):
        it = itertools.cycle([make() for _ in
                              range(max(2, math.ceil(2e8 / nbytes)))])
        return lambda: next(it)

    def issue_us(fn, iters=100):
        """The host's time to issue one call (no synchronize inside the
        loop): where it exceeds the device time, the events above measure
        the host's rate."""
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(iters):
            fn()
        dt = time.perf_counter() - t
        torch.cuda.synchronize()
        return dt / iters * 1e6

    def host_and_device(fn, lib):
        """The host's issue time a call and the device time a call (the
        device kernels' own durations, torch.profiler), kernel and
        library."""
        return dict(issue_us=issue_us(fn), library_issue_us=issue_us(lib),
                    device_ms=sum(ms for _, ms in device_kernels(fn, 20)),
                    library_device_ms=sum(ms for _, ms in
                                          device_kernels(lib, 20)))

    for name, rows in PAPER_ROWS.items():
        n = rows * 128
        C = PAPER_COHORT
        w = torch.full((C,), 1.0 / C, device=dev)
        nb = (C + 1) * n * f4
        nxt = sets_of(lambda: torch.randn((C, rows, 128), generator=gen,
                                             device=dev), nb)
        ms, lib = paired_ms(lambda: K.aggregate_pass(nxt(), w),
                            lambda: torch.tensordot(w, nxt(), dims=1), 100)
        b, by = kernel_bound(K.aggregate_cost(C, rows))
        res["aggregate_pass"][rows] = dict(
            ms=ms, plain_ms=cuda_ms(lambda: R.aggregate_ref(nxt(), w), 100),
            library_ms=lib, bound_ms=b, bound_by=by, bytes=nb,
            **host_and_device(lambda: K.aggregate_pass(nxt(), w),
                              lambda: torch.tensordot(w, nxt(), dims=1)))
        nb = 3 * n * f4
        nxt = sets_of(lambda: torch.randn((2, rows, 128), generator=gen,
                                             device=dev), nb)
        wk = torch.tensor([0.1], device=dev)

        def acc_k():
            acc, g = nxt()
            return K.accumulate_pass(acc, g, wk, out=acc)

        def acc_l():
            acc, g = nxt()
            return acc.add_(g, alpha=0.1)

        ms, lib = paired_ms(acc_k, acc_l, 100)
        b, by = kernel_bound(K.accumulate_cost(rows))
        res["accumulate_pass"][rows] = dict(
            ms=ms, plain_ms=cuda_ms(lambda: R.accumulate_ref(*nxt(), wk[0]),
                                    100),
            library_ms=lib, bound_ms=b, bound_by=by, bytes=nb,
            **host_and_device(acc_k, acc_l))
        scal = torch.tensor([1.0, 0.01, 1.0, 1.0], device=dev)

        def upd_k():
            G, p = nxt()
            return K.update_pass(G, p, None, None, scal, opt="sgd")

        def upd_l():
            G, p = nxt()
            return torch.add(p, G, alpha=-0.01)

        ms, lib = paired_ms(upd_k, upd_l, 100)
        b, by = kernel_bound(K.update_cost("sgd", rows))
        res["update_pass[sgd]"][rows] = dict(
            ms=ms, plain_ms=cuda_ms(lambda: R.update_ref(
                *nxt(), None, None, scal, opt="sgd"), 100),
            library_ms=lib, bound_ms=b, bound_by=by, bytes=nb,
            **host_and_device(upd_k, upd_l))
        torch.cuda.empty_cache()
    for kname, by_rows in res.items():
        for rows, r in by_rows.items():
            log(f"  {kname} rows={rows:,}"
                f"{' cohort=10' if kname == 'aggregate_pass' else ''}: "
                f"{r['ms'] * 1e3:.2f} us, bound {r['bound_ms'] * 1e3:.2f} "
                f"us ({r['bound_by']}, {r['bytes'] / 1e6:.1f} MB, "
                f"{100 * r['bound_ms'] / r['ms']:.1f}% of bound), plain "
                f"{r['plain_ms'] * 1e3:.2f} us, library "
                f"{r['library_ms'] * 1e3:.2f} us; host issue a call: kernel "
                f"{r['issue_us']:.2f} us, library "
                f"{r['library_issue_us']:.2f} us; device time a call "
                f"(profiler): kernel {r['device_ms'] * 1e3:.2f} us "
                f"({100 * r['bound_ms'] / r['device_ms']:.1f}% of bound), "
                f"library {r['library_device_ms'] * 1e3:.2f} us")
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
    b, by = kernel_bound(K.accumulate_bwd_cost(rows))
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
    b, by = kernel_bound(K.aggregate_bwd_cost(COHORT, rows))
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
    b, by = kernel_bound(K.update_bwd_cost("adam", rows))
    adam = (G, m, v, scal, dp, dm, dv)
    res["update_pass_bwd"] = dict(
        ms=cuda_ms(lambda: K.update_pass_bwd(*adam, opt="adam")),
        plain_ms=cuda_ms(lambda: R.update_bwd_ref(*adam, opt="adam")),
        library_ms=None, library=none, bound_ms=b, bound_by=by,
        bytes=9 * n * f4)
    sgd = (G, None, None, scal, dp, None, None)
    b, by = kernel_bound(K.update_bwd_cost("sgd", rows))
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


def _codec_input(rows, gen, dev):
    """Normal values, amax = 127 / 16 (so the int8 scale 1/16 makes the
    products g * 16 of the first entries exact half-way points), +0.0 and
    -0.0."""
    import torch
    g = torch.randn((rows, 128), generator=gen, device=dev).clamp_(-7.5, 7.5)
    g[0, :8] = torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 0.0, -0.0],
                            device=dev) / 16
    g[0, 8] = 127.0 / 16
    return g


def check_codec_kernels(CK, CR, dev, rows_list):
    """Phase 3 for the four codec kernels: every output bitwise equal to the
    plain version's (the kernels round each operation as it does), int8
    scales exact and inexact, the pad mask equal to and below the buffer
    (at full width the model's own 361,821,120), with and without the
    residual, out of place and in place."""
    import torch
    errs = dict.fromkeys(CODEC_NAMES, 0.0)
    gen = torch.Generator(device=dev).manual_seed(5)

    def same(name, what, a, b):
        assert a.dtype == b.dtype and a.shape == b.shape, (name, what)
        if not torch.equal(a, b):
            raise AssertionError(
                f"{name} {what}: not bitwise equal to the plain version "
                f"(max |a-b| {max_abs_err(a.double(), b.double()):.3e})")
        errs[name] = max(errs[name], max_abs_err(a.double(), b.double()))

    for rows in rows_list:
        n = rows * 128
        cuts = (n, FULL_N_VALID if rows == FULL_ROWS else n - 77)
        g = _codec_input(rows, gen, dev)
        s = float(g.abs().max()) * 1.37 / 127        # an inexact scale
        for sc in ((16.0, 1 / 16), (1 / s, s)):
            scal = torch.tensor(sc, device=dev)
            for err in (False, True):
                out = CK.quantize_i8_pass(g, scal, with_error=err)
                ref = CR.quantize_i8_ref(g, scal, with_error=err)
                for what, a, b in (zip(("q", "residual"), out, ref) if err
                                   else [("q", out, ref)]):
                    same("quantize_i8_pass", what, a, b)
                del out, ref
        flat = CK.quantize_i8_pass(
            g, torch.tensor((16.0, 1 / 16), device=dev))[0, :8].tolist()
        q = CK.quantize_i8_pass(g, scal)
        acc = torch.randn((rows, 128), generator=gen, device=dev)
        sw = scal[1:] * 0.3
        ref = CR.dequant_i8_fma_ref(acc, q, sw[0])
        same("dequant_i8_fma_pass", "out", CK.dequant_i8_fma_pass(acc, q, sw),
             ref)
        same("dequant_i8_fma_pass", "in place",
             CK.dequant_i8_fma_pass(acc, q, sw, out=acc), ref)
        del q, ref
        mu = torch.tensor([0.7977], device=dev)
        for n_valid in cuts:
            for err in (False, True):
                out = CK.sign_pack_pass(g, mu, n_valid, with_error=err)
                ref = CR.sign_pack_ref(g, mu[0], n_valid, with_error=err)
                for what, a, b in (zip(("bits", "residual"), out, ref) if err
                                   else [("bits", out, ref)]):
                    same("sign_pack_pass", f"{what} n_valid={n_valid}", a, b)
                del out, ref
            bits = CK.sign_pack_pass(g, mu, n_valid)
            assert int(bits[0, 6]) & 1 and int(bits[0, 7]) & 1, "+-0.0"
            acc = torch.randn((rows, 128), generator=gen, device=dev)
            muw = mu * 0.3
            ref = CR.sign_unpack_fma_ref(acc, bits, muw[0], n_valid)
            same("sign_unpack_fma_pass", f"out n_valid={n_valid}",
                 CK.sign_unpack_fma_pass(acc, bits, muw, n_valid), ref)
            same("sign_unpack_fma_pass", f"in place n_valid={n_valid}",
                 CK.sign_unpack_fma_pass(acc, bits, muw, n_valid, out=acc),
                 ref)
            del bits, ref
        del g, acc
        torch.cuda.empty_cache()
        assert flat == [0, 2, 2, 0, -2, -2, 0, 0], flat   # half to even
        log(f"  codec kernels rows={rows} (n_valid {cuts}): quantize, "
            f"dequant-FMA, pack, unpack-FMA bitwise equal to plain, in "
            f"place too; int8 codes of the half-way inputs {flat}")
    torch.cuda.synchronize()
    return errs


def time_codec_kernels(CK, CR, dev):
    """Phase 5 for the codec kernels at full width: the quantize and the
    pack with the residual (the error-feedback path) and without."""
    import torch
    rows, n = FULL_ROWS, FULL_ROWS * 128
    buf, i8, bits = n * 4.0, n * 1.0, n / 8
    gen = torch.Generator(device=dev).manual_seed(6)
    none = "none: no single PyTorch call computes it"
    res = {}
    g = torch.randn((rows, 128), generator=gen, device=dev) * 0.01
    g.reshape(-1)[FULL_N_VALID:] = 0.0
    s = g.abs().max() / 127
    scal = torch.stack([1.0 / s, s])
    for tag, err, nbytes in (("quantize_i8_pass", True, 2 * buf + i8),
                             ("quantize_i8_pass[no residual]", False,
                              buf + i8)):
        b, by = kernel_bound(CK.quantize_i8_cost(rows, err))
        res[tag] = dict(
            ms=cuda_ms(lambda: CK.quantize_i8_pass(g, scal, with_error=err)),
            plain_ms=cuda_ms(lambda: CR.quantize_i8_ref(
                g, scal, with_error=err)),
            library_ms=None, library=none + " (torch.quantize_per_tensor "
            "divides by the scale and clips to [-128, 127])",
            bound_ms=b, bound_by=by, bytes=nbytes)
    q = CK.quantize_i8_pass(g, scal)
    acc, out = torch.randn((2, rows, 128), generator=gen, device=dev)
    sw = scal[1:] * 0.25
    swf = float(sw)
    b, by = kernel_bound(CK.dequant_i8_fma_cost(rows))
    ms, lib = paired_ms(lambda: CK.dequant_i8_fma_pass(acc, q, sw, out=out),
                        lambda: out.add_(q, alpha=swf))
    res["dequant_i8_fma_pass"] = dict(
        ms=ms, plain_ms=cuda_ms(lambda: CR.dequant_i8_fma_ref(acc, q, sw[0])),
        library_ms=lib,
        library="out.add_(q, alpha=scale*w) (q promoted to fp32, in place)",
        bound_ms=b, bound_by=by, bytes=2 * buf + i8)
    del q
    mu = g.abs().sum().reshape(1) / FULL_N_VALID
    for tag, err, nbytes in (("sign_pack_pass", True, 2 * buf + bits),
                             ("sign_pack_pass[no residual]", False,
                              buf + bits)):
        b, by = kernel_bound(CK.sign_pack_cost(rows, err))
        res[tag] = dict(
            ms=cuda_ms(lambda: CK.sign_pack_pass(g, mu, FULL_N_VALID,
                                                 with_error=err)),
            plain_ms=cuda_ms(lambda: CR.sign_pack_ref(
                g, mu[0], FULL_N_VALID, with_error=err)),
            library_ms=None, library=none, bound_ms=b, bound_by=by,
            bytes=nbytes)
    packed = CK.sign_pack_pass(g, mu, FULL_N_VALID)
    muw = mu * 0.25
    b, by = kernel_bound(CK.sign_unpack_fma_cost(rows))
    res["sign_unpack_fma_pass"] = dict(
        ms=cuda_ms(lambda: CK.sign_unpack_fma_pass(acc, packed, muw,
                                                   FULL_N_VALID, out=out)),
        plain_ms=cuda_ms(lambda: CR.sign_unpack_fma_ref(
            acc, packed, muw[0], FULL_N_VALID)),
        library_ms=None, library=none, bound_ms=b, bound_by=by,
        bytes=2 * buf + bits)
    del g, acc, out, packed
    torch.cuda.empty_cache()
    for name, r in res.items():
        lib = ("" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms ")
        log(f"  {name}: {r['ms']:.4f} ms  bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}, {r['bytes'] / 1e9:.3f} GB, "
            f"{100 * r['bound_ms'] / r['ms']:.1f}% of bound)  plain "
            f"{r['plain_ms']:.4f} ms  library {lib}[{r['library']}]")
    return res


def time_codec_stage(dev):
    """Phase 5c: the device time of one client's whole uplink at full width
    (``repro_torch.comm.transport.client_coded_accumulate``: the scale or
    magnitude reduction, the encode, the decode into the accumulator and,
    with error feedback, ``g + res`` and the residual gate), for each lossy
    codec with and without error feedback.  A coded round runs it once per
    client.  Accumulator and residual are updated in place from launch to
    launch, as the cohort does."""
    import torch
    from repro_torch.comm import client_coded_accumulate, resolve_codec
    from repro_torch.configs import FedConfig
    from repro_torch.core.flat import FlatSpec, GroupSpec

    group = GroupSpec(dtype=torch.float32, leaves=(), size=FULL_N_VALID,
                      rows=FULL_ROWS)
    spec = FlatSpec(names=(), groups=(group,))
    gen = torch.Generator(device=dev).manual_seed(8)
    g = torch.randn((FULL_ROWS, 128), generator=gen, device=dev) * 0.01
    g.reshape(-1)[FULL_N_VALID:] = 0.0
    acc = torch.zeros_like(g)
    res = torch.zeros_like(g)
    w = torch.tensor(0.25, device=dev)
    out = {}
    for codec in ("int8", "sign1bit", "topk"):
        c = resolve_codec(FedConfig(fused_update=True, codec=codec))
        for ef in (False, True):
            ms = cuda_ms(lambda: client_coded_accumulate(
                c, spec, [acc], [g], w, [res] if ef else None), iters=5)
            out[f"{codec}{'+ef' if ef else ''}"] = ms
            log(f"  codec stage {codec}{' + error feedback' if ef else ''}:"
                f" {ms:.4f} ms per client, {COHORT * ms:.3f} ms per round "
                f"of cohort {COHORT}")
    del g, acc, res
    torch.cuda.empty_cache()
    return out


def time_attention_library(dev):
    """Row 11's library time at S 128, as earlier runs printed it: one
    scaled_dot_product_attention call at smollm-360m's shapes (B 8, 15
    query and 5 key/value heads, S 128, D 64, causal, fp32).  The key/value heads are repeated to 15 before the
    timed call, so the call computes the grouped attention; the port never
    calls it."""
    import torch
    import torch.nn.functional as F
    B, H, Hkv, S, D = 8, 15, 5, 128, 64
    gen = torch.Generator(device=dev).manual_seed(7)
    q = torch.randn((B, H, S, D), generator=gen, device=dev)
    k, v = (torch.randn((B, Hkv, S, D), generator=gen, device=dev)
            .repeat_interleave(H // Hkv, dim=1) for _ in range(2))
    ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v,
                                                        is_causal=True),
                 iters=200, warmup=20)
    b, by = bound_ms(*attention_bound_tc())
    log(f"  11 flash_attention_fwd library: scaled_dot_product_attention "
        f"{ms * 1e3:.3f} us per call (bound {b * 1e3:.3f} us, {by}; "
        f"{100 * b / ms:.1f}% of bound)")
    return ms


def attention_bound(B=8, H=15, Hkv=5, S=128, D=64, Dv=None, nbytes=4,
                    Skv=None, causal=True):
    """One GQA flash-attention call (one layer) at smollm-360m's heads and
    the main path's client batch and sequence by default, S queries
    against Skv keys (S unless given), in fp32: the kernel's declared cost
    (``kernels/flash_attention/kernel.py::attention_cost``: q, k, v read
    once, o written once; per (query, key) pair 2D for q.k, 2Dv for p.v
    and 4 for scale, max, exp and sum) with its products counted once, as
    fp32 attention computes them.  Returns (bytes, operations)."""
    rw, ops, tc = attention_bound_tc(B=B, H=H, Hkv=Hkv, S=S, D=D, Dv=Dv,
                                     nbytes=nbytes, Skv=Skv, causal=causal)
    return rw, ops + tc // 3


def attention_bound_tc(B=8, H=15, Hkv=5, S=128, D=64, Dv=None, nbytes=4,
                       Skv=None, causal=True) -> tuple:
    """The same call as the kernel computes it, its declared cost: both
    products as three TF32 tensor-core products each (3xTF32), the softmax
    in fp32.  Returns (bytes, fp32 operations, TF32 operations) for
    ``bound_ms``."""
    from repro_torch.kernels.flash_attention.kernel import attention_cost
    kc = attention_cost(B, H, Hkv, S, S if Skv is None else Skv, D,
                        D if Dv is None else Dv, causal=causal, nbytes=nbytes)
    return (kc.bytes_read + kc.bytes_written, int(kc.flops),
            int(kc.tc_flops))


def ssd_bound(B=8, H=48, S=128, P=64, N=128, chunk=256, G=None, nbytes=4):
    """One Mamba2 SSD chunked-scan call (one layer) at mamba2-780m's widths
    (d_inner 3072 = 48 heads of 64, d_state 128, chunk 256) and the main
    path's client batch and sequence, in fp32: the kernel's declared cost
    (``kernels/ssd_scan/kernel.py::ssd_cost``) with its products counted
    once.  With ``G`` groups given (mamba2-780m has one), the count the
    function needs, C.B^T once per group; without, every term per head,
    as PRs 14-15 counted.  Returns (bytes, operations)."""
    rw, ops, tc = ssd_bound_tc(B=B, H=H, S=S, P=P, N=N, chunk=chunk, G=G,
                               nbytes=nbytes)
    return rw, ops + tc // 3


def ssd_bound_tc(B=8, H=48, S=128, P=64, N=128, chunk=256, G=None,
                 nbytes=4) -> tuple:
    """The same call as the kernel computes it, its declared cost: the
    matrix products as three TF32 tensor-core products each (3xTF32), the
    decays and masks in fp32.  Returns (bytes, fp32 operations, TF32
    operations) for ``bound_ms``."""
    from repro_torch.kernels.ssd_scan.kernel import ssd_cost
    kc = ssd_cost(B, H, S, P, N, chunk, G=G, nbytes=nbytes)
    return (kc.bytes_read + kc.bytes_written, int(kc.flops),
            int(kc.tc_flops))


def print_all_bounds():
    """Bounds of the twelve Pallas kernels.  The fused-update
    and codec kernels at full width (fp32 flat buffers of FULL_ROWS rows,
    cohort 4, adam for the optimizer passes, error feedback on for the
    codecs): each input read once, each output written once, over the
    card's memory rate.  Flash attention and the SSD scan at one layer of
    the models that run them, at S 128 and at the serving prefill's 1024:
    the larger of bytes over the memory rate and operations over the fp32
    rate (``ssd_bound`` counts B, C and C.B^T per head, as the Pallas
    kernel takes them, and, with its groups given, once per group, as the
    port's kernel takes them)."""
    from repro_torch.kernels.comm import kernel as CK
    from repro_torch.kernels.fused_update import kernel as K
    R = FULL_ROWS
    rows = [
        ("1 aggregate_pass", K.aggregate_cost(COHORT, R)),
        ("2 accumulate_pass", K.accumulate_cost(R)),
        ("3 update_pass[adam]", K.update_cost("adam", R)),
        ("3 update_pass[sgd]", K.update_cost("sgd", R)),
        ("4 accumulate_pass_bwd", K.accumulate_bwd_cost(R)),
        ("5 aggregate_pass_bwd", K.aggregate_bwd_cost(COHORT, R)),
        ("6 update_pass_bwd[adam]", K.update_bwd_cost("adam", R)),
        ("6 update_pass_bwd[sgd]", K.update_bwd_cost("sgd", R)),
        ("7 quantize_i8_pass (+residual)", CK.quantize_i8_cost(R, True)),
        ("8 dequant_i8_fma_pass", CK.dequant_i8_fma_cost(R)),
        ("9 sign_pack_pass (+residual)", CK.sign_pack_cost(R, True)),
        ("10 sign_unpack_fma_pass", CK.sign_unpack_fma_cost(R)),
    ]
    for name, kc in rows:
        log(f"  {name}: reads {kc.bytes_read / 1e9:.3f} GB, writes "
            f"{kc.bytes_written / 1e9:.3f} GB, bound "
            f"{kernel_bound(kc)[0]:.3f} ms")
    for name, (rw, ops) in (
            ("11 flash_attention_fwd (smollm-360m, B 8, 15/5 heads, S 128, "
             "D 64, fp32)", attention_bound()),
            ("11 flash_attention_fwd (the serving prefill: S 1024)",
             attention_bound(S=1024)),
            ("12 ssd_scan_fwd (mamba2-780m, B 8, 48 heads, S 128, P 64, "
             "N 128, fp32; C.B^T per head)", ssd_bound()),
            ("12 ssd_scan_fwd (the serving prefill: S 1024, chunk 256; "
             "C.B^T per head)", ssd_bound(S=1024)),
            ("12 ssd_scan_fwd (the serving prefill, C.B^T once for its one "
             "group)", ssd_bound(S=1024, G=1))):
        b, by = bound_ms(rw, ops)
        log(f"  {name}: {rw / 1e6:.3f} MB, {ops / 1e9:.4f} GFLOP, bound "
            f"{b * 1e3:.3f} us ({by}) per layer call at fp32's rate")
    for S in (128, 1024):
        b, by = bound_ms(*attention_bound_tc(S=S))
        log(f"  11 flash_attention_fwd at S {S} as the kernel computes it "
            f"(3xTF32 products on the tensor cores, fp32 softmax): bound "
            f"{b * 1e3:.3f} us ({by})")
    for S in (128, 1024):
        b, by = bound_ms(*ssd_bound_tc(S=S, G=1))
        log(f"  12 ssd_scan_fwd at S {S} as the kernel computes it (3xTF32 "
            f"products on the tensor cores, C.B^T once for the one group, "
            f"fp32 decays and masks): bound {b * 1e3:.3f} us ({by})")


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
# Rounds a run: the post vmap/sgd run keeps 2 (its steady round is the
# host's yardstick across calls), a run with error feedback 2 (the
# residual carry); every other run 1, enough for its launches and for
# vmap against scan after round 1.
ROUNDS = {"post:vmap/sgd": 2}
ROUNDS_DEFAULT = 1
CODED_ROUNDS_EF = 2
FUSED_NAMES = ("aggregate_pass", "accumulate_pass", "update_pass",
               "accumulate_pass_bwd", "aggregate_pass_bwd",
               "update_pass_bwd")
CODEC_NAMES = ("quantize_i8_pass", "dequant_i8_fma_pass", "sign_pack_pass",
               "sign_unpack_fma_pass")
SERVE_NAMES = ("flash_attention_fwd", "ssd_scan_fwd")
KERNEL_NAMES = FUSED_NAMES + CODEC_NAMES + SERVE_NAMES
FAMILY = {**dict.fromkeys(FUSED_NAMES, "fused_update"),
          **dict.fromkeys(CODEC_NAMES, "comm"),
          "flash_attention_fwd": "flash_attention", "ssd_scan_fwd": "ssd_scan"}


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


def _coded_counts(r, codec):
    """A lossy codec replaces pass 1 on both cohorts: per client one encode
    and one decode-FMA launch (one dtype group), none for topk (plain
    PyTorch, as in the JAX package); the update pass stays."""
    enc, dec = {"int8": ("quantize_i8_pass", "dequant_i8_fma_pass"),
                "sign1bit": ("sign_pack_pass", "sign_unpack_fma_pass"),
                "topk": (None, None)}[codec]
    kw = {"update_pass": r}
    if enc:
        kw.update({enc: r * COHORT, dec: r * COHORT})
    return _launches(**kw)


def rounds_of(tag) -> int:
    if tag in CODED_RUNS and CODED_RUNS[tag][1]:
        return CODED_ROUNDS_EF
    return ROUNDS.get(tag, ROUNDS_DEFAULT)


# tag -> (codec, error feedback, strategy, server optimizer)
CODED_RUNS = {
    "int8:vmap/sgd": ("int8", False, "vmap", "sgd"),
    "int8:scan/sgd": ("int8", False, "scan", "sgd"),
    "int8+ef:scan/adam": ("int8", True, "scan", "adam"),
    "sign1bit+ef:vmap/sgd": ("sign1bit", True, "vmap", "sgd"),
    "sign1bit:scan/sgd": ("sign1bit", False, "scan", "sgd"),
    "topk+ef:vmap/sgd": ("topk", True, "vmap", "sgd"),
}
EXPECTED_LAUNCHES = {
    tag: counts(rounds_of(tag), mode != "post")
    for tag, counts, mode in (
        ("post:vmap/sgd", _vmap_counts, "post"),
        ("post:scan/sgd", _scan_counts, "post"),
        ("post:scan/adam", _scan_counts, "post"),
        ("through_aggregation:vmap/sgd", _vmap_counts, "ta"),
        ("through_aggregation:scan/sgd", _scan_counts, "ta"),
        ("through_aggregation:scan/adam", _scan_counts, "ta"))}
for _tag, (_codec, *_) in CODED_RUNS.items():
    EXPECTED_LAUNCHES[_tag] = _coded_counts(rounds_of(_tag), _codec)


def payload_bytes(codec, n, ratio=0.01) -> int:
    """One client's uplink bytes for one fp32 group of n elements, from the
    codec's definition: int8 codes and a scale; packed bits and mu;
    (value, 4-byte index) pairs for topk."""
    return {"int8": n + 4, "sign1bit": -(-n // 8) + 4,
            "topk": 8 * max(1, min(n, int(round(n * ratio))))}[codec]


class Counts:
    """The launch counts of the kernel modules, zeroed and read together."""

    def __init__(self, *modules):
        self.modules = modules

    def reset(self):
        for m in self.modules:
            m.reset_launch_counts()

    def read(self) -> dict:
        out = {}
        for m in self.modules:
            out.update(m.launch_counts())
        return {name: out[name] for name in KERNEL_NAMES}


def main_path(counts_of, dev):
    """Each of the six runs is its own main path: the launch counts are
    zeroed just before its ``run_training`` call and read just after.
    Returns the counts and the post vmap/sgd run's final parameters (on
    the host) and history, which phases 6o and 6g hold their runs to."""
    import torch
    from repro_torch.core import flat as F
    from repro_torch.launch.train import run_training

    round1 = {}
    counts = {}
    runs = {}
    for tag, want in EXPECTED_LAUNCHES.items():
        if tag in CODED_RUNS:
            continue
        mode, path = tag.split(":")
        strategy, opt = path.split("/")
        rounds = rounds_of(tag)
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

        counts_of.reset()
        state, hist = run_training(
            "smollm-360m", rounds=rounds, cohort=COHORT, client_batch=8,
            seq=128, algorithm="uga", meta=True, fused=True,
            strategy=strategy, server_opt=opt, meta_mode=mode, seed=0,
            log_every=1, device=dev, on_records=on_records)
        counts[tag] = counts_of.read()
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
        if tag == "post:vmap/sgd":
            ref = dict(params={k: v.cpu() for k, v in
                               state["params"].items()},
                       hist=hist, counts=counts[tag], walls=secs)
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
    return counts, ref


def post_vmap_reference(counts_of, dev):
    """Phase 6's post vmap/sgd run alone, as ``main_path`` keeps it, for
    the tools that run phases 6o or 6g without phase 6."""
    import torch
    from repro_torch.launch.train import run_training
    marks = [time.perf_counter()]

    def on_records(recs, trainer):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    counts_of.reset()
    state, hist = run_training(
        "smollm-360m", rounds=rounds_of("post:vmap/sgd"), cohort=COHORT,
        client_batch=8, seq=128, algorithm="uga", meta=True, fused=True,
        strategy="vmap", server_opt="sgd", meta_mode="post", seed=0,
        log_every=1, device=dev, on_records=on_records)
    counts = counts_of.read()
    assert counts == EXPECTED_LAUNCHES["post:vmap/sgd"], counts
    ref = dict(params={k: v.cpu() for k, v in state["params"].items()},
               hist=hist, counts=counts,
               walls=[b - a for a, b in zip(marks, marks[1:])])
    del state
    torch.cuda.empty_cache()
    return ref


# ---------------------------------------------------------------------------
# phase 6o: the tracked, profiled, sanitized run at full width
# ---------------------------------------------------------------------------
# Phase 6's post vmap/sgd run again through run_training, with the jsonl
# and csv trackers, the round sanitizer and a torch.profiler window over
# round 1 summarized into a profile_summary event.  None of these may
# change a bit: params and history are held bitwise to phase 6's run in
# this process, its launches exactly.  The trace summary's table is
# asked for every op, so the fused-update kernels are found in it.
TRACKED_TOP_K = 100_000
# the device names of the two kernels the tracked run launches (rows 1, 3)
TRACKED_KERNELS = ("aggregate_kernel", "update_kernel")


def tracked_path(counts_of, dev, ref):
    """Phase 6o: returns its launch counts."""
    import shutil
    import tempfile

    import torch
    from repro_torch.core.flat import make_flat_spec
    from repro_torch.core.sanitize import check_flat_groups, probe_log
    from repro_torch.launch.train import run_training
    from repro_torch.obs import (PROFILE_SUMMARY_EVENT_KEYS,
                                 find_trace_file, resolve_tracker,
                                 round_metric_keys)

    tag = "6o:post:vmap/sgd tracked"
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    run_dir = tempfile.mkdtemp(prefix="obs_smoke_",
                               dir=os.path.join(HERE, "build"))
    marks = [time.perf_counter()]

    def on_records(recs, trainer):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    torch.cuda.synchronize()
    counts_of.reset()
    state, hist = run_training(
        "smollm-360m", rounds=len(ref["hist"]), cohort=COHORT,
        client_batch=8, seq=128, algorithm="uga", meta=True, fused=True,
        seed=0, log_every=1, device=dev, tracker="jsonl,csv",
        run_dir=run_dir, sanitize=True, profile=1, profile_start=1,
        trace_summary=True, trace_top_k=TRACKED_TOP_K,
        on_records=on_records)
    counts = counts_of.read()
    log(f"kernels: {tag} {json.dumps(counts)}")
    assert counts == ref["counts"], (counts, ref["counts"])
    diff = [k for k, v in ref["params"].items()
            if not _bitwise(state["params"][k].cpu(), v)]
    log(f"  6o: against phase 6's post vmap/sgd run: {len(ref['params'])} "
        f"parameter leaves, {len(diff)} differ; records equal: "
        f"{hist == ref['hist']} (bitwise required)")
    assert not diff and hist == ref["hist"], diff[:5]

    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        lines = [json.loads(ln) for ln in f]
    recs = [{k: v for k, v in ln.items() if k != "kind"} for ln in lines
            if ln["kind"] == "metrics"]
    assert recs == hist, (recs, hist)
    events = [ln for ln in lines if ln["kind"] == "event"]
    names = [e["event"] for e in events]
    assert names[0] == "run_start" and names[-1] == "run_finish", names
    for e in ("profile_start", "profile_stop", "profile_summary"):
        assert names.count(e) == 1, (e, names)
    spans = {}
    for e in events:
        if e["event"] == "phase":
            spans.setdefault(e["round"], {})[e["phase"]] = e
    for r in range(len(hist)):
        assert {"sample_stack", "dispatch", "device_sync"} <= set(spans[r])
    (summ,) = [e for e in events if e["event"] == "profile_summary"]
    payload = {k: v for k, v in summ.items()
               if k not in ("kind", "event", "t")}
    assert set(payload) == set(PROFILE_SUMMARY_EVENT_KEYS), sorted(payload)
    assert 0 < payload["busy_frac"] < 1, payload["busy_frac"]
    ops = [o["op"] for o in payload["top_ops"]]
    for kern in TRACKED_KERNELS:
        assert any(kern in o for o in ops), (kern, ops[:20])
    for p in ("dispatch", "device_sync"):
        assert p in payload["phase_self_us"], payload["phase_self_us"]
    with open(os.path.join(run_dir, "metrics.csv")) as f:
        header = f.readline().strip().split(",")
    want = round_metric_keys(_full_fed(fused_update=True))
    assert set(header) == set(want), (header, sorted(want))
    rep = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs", "report", run_dir],
        capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": os.path.join(HERE, "src")})
    assert rep.returncode == 0, rep.stderr

    # what each round's spans read, and what the window cost
    t_of = {e["event"] if e["event"] != "phase" else
            (e["phase"], e["round"]): e["t"] for e in events}
    trace = find_trace_file(run_dir)
    walls = [b - a for a, b in zip(marks, marks[1:])]
    for r in range(len(hist)):
        sp = spans[r]
        log(f"  6o round {r}: sample_stack {sp['sample_stack']['dur_s']:.4f}"
            f" s, dispatch {sp['dispatch']['dur_s']:.4f} s, device_sync "
            f"{sp['device_sync']['dur_s']:.4f} s; round wall "
            f"{walls[r]:.4f} s{' (profiled)' if r == 1 else ''}")
    log(f"  6o trace {os.path.relpath(trace, run_dir)}: "
        f"{os.path.getsize(trace) / 2**20:.1f} MiB, exported in "
        f"{t_of['profile_stop'] - t_of[('device_sync', 1)]:.2f} s, "
        f"summarized in {t_of['profile_summary'] - t_of['profile_stop']:.2f}"
        f" s; {payload['n_op_events']} device ops of {payload['n_ops']} "
        f"kinds, busy {payload['busy_us'] / 1e3:.2f} ms of a "
        f"{payload['wall_us'] / 1e3:.2f} ms device window: busy_frac "
        f"{payload['busy_frac']:.4f}")
    log(f"  6o device self time by phase (ms): " + ", ".join(
        f"{k} {v / 1e3:.2f}" for k, v in payload["phase_self_us"].items()))
    for o in payload["top_ops"][:5]:
        log(f"    {o['self_us'] / 1e3:9.3f} ms  x{o['count']:<5d} "
            f"{o['op'][:90]}")
    for kern in TRACKED_KERNELS:
        mine = [o for o in payload["top_ops"] if kern in o["op"]]
        log(f"    {kern}: {sum(o['self_us'] for o in mine) / 1e3:.3f} ms "
            f"x{sum(o['count'] for o in mine)}")

    # the probe alone, and the file trackers' cost a record
    params = state["params"]
    spec = make_flat_spec(params)
    groups = [[params[lf.name] for lf in g.leaves] for g in spec.groups]
    t = time.perf_counter()
    for _ in range(5):
        check_flat_groups(spec, groups, "6o timing")    # read back each
    probe_ms = (time.perf_counter() - t) / 5 * 1e3
    with probe_log():                                   # read once, after
        dev_ms = cuda_ms(
            lambda: check_flat_groups(spec, groups, "6o timing"), 5, 1)
    trk = resolve_tracker("jsonl,csv", run_dir=os.path.join(run_dir, "t"))
    t = time.perf_counter()
    for i in range(200):
        trk.log_metrics(i, {**hist[0], "round": i})
    trk.finish()
    rec_ms = (time.perf_counter() - t) / 200 * 1e3
    log(f"  6o sanitizer probe over the 1.447 GB of parameters: "
        f"{dev_ms:.3f} ms of device time (CUDA events, no read), "
        f"{probe_ms:.3f} ms host wall with its read; jsonl + csv trackers "
        f"{rec_ms:.4f} ms a record")
    del state, params, groups
    shutil.rmtree(run_dir)
    torch.cuda.empty_cache()
    return {tag: counts}


# ---------------------------------------------------------------------------
# phase 6l: the live roofline and the dry run
# ---------------------------------------------------------------------------
# Phase 6's post vmap/sgd run again through run_training with
# roofline=True and the jsonl tracker: params and history bitwise phase
# 6's, launches equal, one roofline event, and the trace's own kernel
# counts those of one round.  Then, without running them, traces of the
# round of five more of phase 6's configurations, each in a process of
# its own, in parallel (a trace is host work), held to the launches of
# one round of their path: with the live run every fused-update and codec
# kernel is charged.  The dry run in a process of its own too:
# smollm-360m on the four shapes and mamba2-780m's prefill, flash charged
# 32 launches and the SSD scan 48.  All six start before phase 6.
ROOFLINE_TRACED = ("post:scan/adam", "through_aggregation:vmap/sgd",
                   "through_aggregation:scan/adam", "int8+ef:scan/adam",
                   "sign1bit+ef:vmap/sgd")
ROOFLINE_DRY = {
    ("smollm-360m", "train_4k"): {"aggregate_pass": 1, "update_pass": 1},
    ("smollm-360m", "prefill_32k"): {"flash_attention_fwd": 32},
    ("smollm-360m", "decode_32k"): {},
    ("smollm-360m", "long_500k"): {},
    ("mamba2-780m", "prefill_32k"): {"ssd_scan_fwd": 48},
}


def one_round_counts(tag) -> dict:
    """The launches of one round of phase 6's path ``tag``."""
    if tag in CODED_RUNS:
        return _coded_counts(1, CODED_RUNS[tag][0])
    mode, path = tag.split(":")
    counts = _vmap_counts if path.startswith("vmap") else _scan_counts
    return counts(1, mode != "post")


def _phase6_fed(tag):
    """The FedConfig run_training builds for phase 6's run ``tag``."""
    if tag in CODED_RUNS:
        codec, ef, strategy, opt = CODED_RUNS[tag]
        return _full_fed(fused_update=True, cohort_strategy=strategy,
                         server_opt=opt, codec=codec, error_feedback=ef)
    mode, path = tag.split(":")
    strategy, opt = path.split("/")
    return _full_fed(fused_update=True, cohort_strategy=strategy,
                     server_opt=opt, meta_mode=mode)


def trace_only(tag, dev) -> dict:
    """One round of phase 6's run ``tag`` traced on fake stand-ins of the
    trainer's state and round 0's staged inputs, never run: the trace must
    leave the card's allocation and the kernels' real launch counts where
    they were."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core.trainer import FederatedTrainer
    from repro_torch.kernels.comm import kernel as CK
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.fused_update import kernel as K
    from repro_torch.kernels.ssd_scan import kernel as SK
    from repro_torch.launch.train import build_synthetic_fed_data
    from repro_torch.models.model import build_model
    from repro_torch.roofline.live import round_cost_summary

    cfg = get_arch("smollm-360m")
    tr = FederatedTrainer(build_model(cfg, dtype=torch.float32,
                                      loss_chunk=256), _phase6_fed(tag),
                          seed=0, device=dev)
    data = build_synthetic_fed_data(cfg, num_clients=32, examples=2048,
                                    seq=128, iid=False, seed=0)
    sample = data.sample_round(0, cohort=COHORT, batch=8, share=False)
    staged = tr._stage([sample], [data.sample_meta(0, 16)], [None])
    torch.cuda.synchronize()
    alloc = torch.cuda.memory_allocated()
    counts_of = Counts(K, CK, FK, SK)
    real = counts_of.read()
    s = round_cost_summary(tr._cache(1), (tr.state, *staged), device=dev)
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == alloc, "the trace allocated"
    assert counts_of.read() == real, "the trace launched"
    return {"tag": tag, "launches": s["launches"], "trace_s": s["trace_s"],
            "flops": s["flops"], "bytes": s["bytes"], "n_ops": s["n_ops"],
            "memory": s["memory"]}


DRY = "dryrun"


def dry_only() -> dict:
    """Phase 6l's dry-run worker: the records of ``ROOFLINE_DRY``."""
    from repro_torch.launch.dryrun import run_one
    t = time.perf_counter()
    recs = {f"{a} x {s}": run_one(a, s, verbose=False)
            for a, s in ROOFLINE_DRY}
    return {"records": recs, "seconds": time.perf_counter() - t}


def start_roofline_traces() -> dict:
    """Phase 6l's traces without a run and its dry run, each in a process
    of its own at a lower priority and on one thread, started before
    phase 6 so that they trace beside phases 6 and 6o and this process's
    live run (each trace holds its trainer's state on the card, 27 GB for
    the five, beside phase 6's peaks of at most 34 GiB)."""
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    cmd = [sys.executable, os.path.join(HERE, "chip_smoke.py")]
    procs = {t: subprocess.Popen(
        cmd + ["--trace-only", t], stdout=subprocess.PIPE, text=True,
        env=env, preexec_fn=lambda: os.nice(10)) for t in ROOFLINE_TRACED}
    procs[DRY] = subprocess.Popen(cmd + ["--dry-only"],
                                  stdout=subprocess.PIPE, text=True, env=env,
                                  preexec_fn=lambda: os.nice(10))
    return procs


def stop(procs: dict) -> None:
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.wait()


def roofline_path(counts_of, dev, ref, procs):
    """Phase 6l, with the trace processes ``start_roofline_traces``
    started: returns its launch counts."""
    import shutil
    import tempfile

    import torch
    from repro_torch.launch.train import run_training
    from repro_torch.obs import ROOFLINE_EVENT_KEYS

    tag = "6l:post:vmap/sgd roofline"
    try:
        os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
        run_dir = tempfile.mkdtemp(prefix="roofline_smoke_",
                                   dir=os.path.join(HERE, "build"))
        summaries = {}

        def on_records(recs, trainer):
            summaries.update(trainer.roofline_summaries)

        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        counts_of.reset()
        state, hist = run_training(
            "smollm-360m", rounds=len(ref["hist"]), cohort=COHORT,
            client_batch=8, seq=128, algorithm="uga", meta=True, fused=True,
            seed=0, log_every=1, device=dev, tracker="jsonl", run_dir=run_dir,
            roofline=True, on_records=on_records)
        counts = counts_of.read()
        peak = torch.cuda.max_memory_allocated() - base
        log(f"kernels: {tag} {json.dumps(counts)}")
        assert counts == ref["counts"], (counts, ref["counts"])
        diff = [k for k, v in ref["params"].items()
                if not _bitwise(state["params"][k].cpu(), v)]
        log(f"  6l: against phase 6's post vmap/sgd run: {len(ref['params'])} "
            f"parameter leaves, {len(diff)} differ; records equal: "
            f"{hist == ref['hist']} (bitwise required)")
        assert not diff and hist == ref["hist"], diff[:5]
        del state
        with open(os.path.join(run_dir, "metrics.jsonl")) as f:
            events = [json.loads(ln) for ln in f]
        rl = [e for e in events if e.get("event") == "roofline"]
        assert len(rl) == 1, len(rl)
        ev = {k: v for k, v in rl[0].items()
              if k not in ("kind", "event", "t")}
        assert set(ev) == set(ROOFLINE_EVENT_KEYS), sorted(ev)
        traced = _launches(**summaries[1]["launches"])
        log(f"  6l trace of the K = 1 round: launches "
            f"{summaries[1]['launches']}, {summaries[1]['n_ops']} counted "
            f"aten ops (one round of the path: "
            f"{traced == one_round_counts('post:vmap/sgd')}, required)")
        assert traced == one_round_counts("post:vmap/sgd"), traced
        rep = subprocess.run(
            [sys.executable, "-m", "repro_torch.roofline.report", run_dir],
            capture_output=True, text=True,
            env={**os.environ, "PYTHONPATH": os.path.join(HERE, "src")})
        assert rep.returncode == 0, (rep.returncode, rep.stdout, rep.stderr)
        log("  " + rep.stdout.strip().replace("\n", "\n  "))
        mem = ev["memory"]
        pred = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
        ratio = ev["measured_rounds_per_s"] / ev["predicted_rounds_per_s"]
        log(f"  6l predicted per round: compute "
            f"{ev['compute_s_per_round']:.4f} s, memory "
            f"{ev['memory_s_per_round']:.4f} s, collective "
            f"{ev['collective_s_per_round']:.4f} s ({ev['bottleneck']}); "
            f"{ev['flops_per_round']:.4e} FLOP, {ev['bytes_per_round']:.4e} "
            f"bytes; rounds/s predicted {ev['predicted_rounds_per_s']:.4f}, "
            f"measured {ev['measured_rounds_per_s']:.4f} (ratio measured / "
            f"predicted {ratio:.4f}); analysis_s {ev['analysis_s']:.2f}")
        log(f"  6l memory: arguments "
            f"{mem['argument_size_in_bytes'] / 2**30:.3f} + temp "
            f"{mem['temp_size_in_bytes'] / 2**30:.3f} = "
            f"{pred / 2**30:.3f} GiB predicted; max_memory_allocated "
            f"{peak / 2**30:.3f} GiB over the run; predicted / measured "
            f"{pred / peak:.4f}")
        shutil.rmtree(run_dir)
        torch.cuda.empty_cache()

        out, _ = procs[DRY].communicate(timeout=600)
        assert procs[DRY].returncode == 0, procs[DRY].returncode
        dry = json.loads(out.strip().splitlines()[-1])
        for (arch, shape), want in ROOFLINE_DRY.items():
            rec = dry["records"][f"{arch} x {shape}"]
            log(f"  6l dryrun {arch} x {shape}: {json.dumps(rec)}")
            assert rec["launches"] == want, (arch, shape, rec["launches"])
            assert rec["roofline"]["bottleneck"] in (
                "compute", "memory", "collective"), rec["roofline"]
        log(f"  6l dryrun: {len(ROOFLINE_DRY)} pairs in "
            f"{dry['seconds']:.1f} s (a process of its own)")
        for t, p in procs.items():
            if t == DRY:
                continue
            out, _ = p.communicate(timeout=600)
            assert p.returncode == 0, (t, p.returncode)
            got = json.loads(out.strip().splitlines()[-1])
            have = _launches(**got["launches"])
            log(f"  6l trace without a run, {t}: launches "
                f"{got['launches']} (one round of the path: "
                f"{have == one_round_counts(t)}, required); "
                f"{got['flops']:.4e} FLOP, {got['bytes']:.4e} bytes, "
                f"{got['n_ops']} aten ops, temp "
                f"{got['memory']['temp_size_in_bytes'] / 2**30:.3f} GiB; "
                f"traced in {got['trace_s']:.1f} s")
            assert have == one_round_counts(t), (t, have)
    finally:
        stop(procs)
    return {tag: counts}


def coded_path(counts_of, dev):
    """Phase 6 with the compressed uplink: six runs of ``run_training`` at
    full width, 2 rounds each, each its own main path (counts zeroed just
    before, read just after).  Each checks finite metrics, the exact
    ``comm_bytes`` (one client's payload times the cohort, in fp32) and,
    under error feedback, a nonzero residual after round 1; int8 vmap and
    scan agree after round 1 under the flip-aware criterion."""
    import numpy as np
    import torch
    from repro_torch.core import flat as F
    from repro_torch.launch.train import run_training

    counts, runs, round1 = {}, {}, {}
    for tag, (codec, ef, strategy, opt) in CODED_RUNS.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        marks = [time.perf_counter()]

        def on_records(recs, trainer, tag=tag, ef=ef, marks=marks):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            if recs[0]["round"] != 0:
                return
            if ef:
                (res,) = trainer.state["comm"]["residual"]
                assert res.shape == (COHORT, FULL_ROWS, 128), res.shape
                nz = [float(res[k].abs().max()) for k in range(COHORT)]
                assert all(v > 0 for v in nz), (tag, nz)
                log(f"  {tag}: residual max |r| per client after round 1: "
                    f"{[f'{v:.4e}' for v in nz]}")
            if tag.startswith("int8:"):
                params = trainer.state["params"]
                round1[tag] = {k: v.clone() for k, v in params.items()}

        counts_of.reset()
        state, hist = run_training(
            "smollm-360m", rounds=rounds_of(tag), cohort=COHORT,
            client_batch=8, seq=128, algorithm="uga", meta=True, fused=True,
            strategy=strategy, server_opt=opt, codec=codec,
            error_feedback=ef, seed=0, log_every=1, device=dev,
            on_records=on_records)
        counts[tag] = counts_of.read()
        log(f"kernels: {tag} {json.dumps(counts[tag])}")
        want = EXPECTED_LAUNCHES[tag]
        assert counts[tag] == want, (tag, counts[tag], want)
        n_params = sum(p.numel() for p in state["params"].values())
        assert n_params == FULL_N_VALID, n_params
        assert F.make_flat_spec(state["params"]).groups[0].size == n_params
        comm_bytes = float(np.float32(payload_bytes(codec, FULL_N_VALID))
                           * np.float32(COHORT))
        for rec in hist:
            for k, v in rec.items():
                assert math.isfinite(v), (tag, rec)
            assert rec["comm_bytes"] == comm_bytes, (tag, rec, comm_bytes)
        assert ("comm" in state) == ef, tag
        secs = [b - a for a, b in zip(marks, marks[1:])]
        peak = torch.cuda.max_memory_allocated() / 2**30
        runs[tag] = dict(round_wall_s=secs, peak_gib=peak)
        log(f"  {tag}: comm_bytes {comm_bytes:.0f} per round (exact)  round "
            f"wall s {[round(s, 4) for s in secs]} (round 0 includes init "
            f"and data)  max_memory_allocated {peak:.2f} GiB")
        del state
        torch.cuda.empty_cache()

    a, b = round1["int8:vmap/sgd"], round1["int8:scan/sgd"]
    n = params_flip_aware(b, a, "int8 vmap vs scan")
    worst = max(max_abs_err(a[k], b[k]) for k in a)
    log(f"  int8: vmap vs scan params after round 1: {n} elements off by "
        f"more than 1e-5 of their leaf's largest entry (at most "
        f"{FLIP_FRACTION:g} of the elements, each within {FLIP_CAP:g} of "
        f"it); max |a-b| {worst:.3e}")
    return counts


# Phase 6m: training through Mamba2 layers at full width.  mamba2-780m
# trains through models/ssm.py::ssd_chunked (plain PyTorch, differentiable
# in both modes), so the SSD-scan kernel launches no time; the server step
# runs the fused-update kernels as on smollm-360m.  vmap/sgd 2 rounds and
# scan/sgd 1 (held to each other after round 1).  scan/adam does not fit:
# both sgd runs peak at 69.99 GiB, outside the aggregation (the same on
# both cohorts), and adam's two slots (6.24 GB) ran the card out of
# memory at 75.81 GiB allocated, 2.62 GiB more reserved, of 79.18.
MAMBA_RUNS = {"mamba2:vmap/sgd": 2, "mamba2:scan/sgd": 1}
MAMBA_N_PARAMS = 779_841_792
# vmap against scan after round 1: the two cohorts sum G in other orders
# (1e-7 apart), and the FedMeta step's gradient at parameters that close
# is ill-conditioned in a stack with mamba layers (tests/
# test_torch_ssm_train.py); dt_bias starts at zero, so its relative error
# is its update's.  Measured 1.95e-5; smollm-360m's runs hold 1e-5.
MAMBA_VMAP_SCAN_TOL = 1e-4


def mamba_path(counts_of, dev):
    """Each run its own main path (counts zeroed just before, read just
    after): exactly the fused-update launches of its cohort and none of
    the SSD scan, finite metrics, the flat rows, the steady round wall and
    the peak."""
    import numpy as np
    import torch
    from repro_torch.core import flat as F
    from repro_torch.launch.train import run_training

    counts, round1, walls = {}, {}, {}
    for tag, rounds in MAMBA_RUNS.items():
        strategy, opt = tag.split(":")[1].split("/")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        marks, copy_s = [time.perf_counter()], [0.0]

        def on_records(recs, trainer, tag=tag, opt=opt, marks=marks,
                       copy_s=copy_s):
            torch.cuda.synchronize()
            marks.append(time.perf_counter() - copy_s[0])
            if recs[0]["round"] != 0 or opt != "sgd":
                return
            t = time.perf_counter()     # a host copy: kept out of the peak
            round1[tag] = {k: v.cpu() for k, v in
                           trainer.state["params"].items()}
            copy_s[0] += time.perf_counter() - t

        counts_of.reset()
        state, hist = run_training(
            "mamba2-780m", rounds=rounds, cohort=COHORT, client_batch=8,
            seq=128, algorithm="uga", meta=True, fused=True,
            strategy=strategy, server_opt=opt, seed=0, log_every=1,
            device=dev, on_records=on_records)
        counts[tag] = counts_of.read()
        want = (_vmap_counts if strategy == "vmap" else _scan_counts)(
            rounds, False)
        log(f"kernels: {tag} {json.dumps(counts[tag])}")
        assert counts[tag] == want, (tag, counts[tag], want)
        assert counts[tag]["ssd_scan_fwd"] == 0
        n = sum(p.numel() for p in state["params"].values())
        rows = F.make_flat_spec(state["params"]).groups[0].rows
        assert n == MAMBA_N_PARAMS, n
        for rec in hist:
            assert all(math.isfinite(v) for v in rec.values()), (tag, rec)
        secs = [b - a for a, b in zip(marks, marks[1:])]
        peak = torch.cuda.max_memory_allocated() / 2**30
        walls[tag] = dict(round_wall_s=secs, peak_gib=peak)
        steady = (f"steady {np.mean(secs[1:]):.4f} s" if len(secs) > 1
                  else "no steady round")
        log(f"  {tag}: params {n:,}, flat rows {rows:,} x 128 "
            f"({rows * 512 / 1e9:.3f} GB fp32); round wall s "
            f"{[round(x, 4) for x in secs]} (round 0 includes init and "
            f"data; {steady}); max_memory_allocated {peak:.2f} GiB")
        del state
        torch.cuda.empty_cache()
        if tag == "mamba2:scan/sgd":
            a, b = round1.pop("mamba2:vmap/sgd"), round1.pop(tag)
            errs = {k: rel_err(b[k], a[k]) for k in a}
            leaf = max(errs, key=errs.get)
            log(f"  mamba2 post: vmap vs scan params after round 1: rel "
                f"{errs[leaf]:.3e} ({leaf}; tol {MAMBA_VMAP_SCAN_TOL:g}); "
                f"every other leaf within "
                f"{max(v for k, v in errs.items() if k != leaf):.3e}")
            assert errs[leaf] <= MAMBA_VMAP_SCAN_TOL, errs[leaf]
    return counts


# Phase 6f: the synchronous fault model on smollm-360m at full width,
# vmap/sgd: participation 0.75, the 'flaky' fault profile (crash 0.05,
# drop 0.08, delay 0.15 up to 3 rounds; its garble zeroed on a sync
# round), a deadline of 3 round-units and retry with a backoff of 1.
# Two rounds: a client that fails in round 0 is retried in round 1.
FAULT_ROUNDS = 2
FAULT_KW = dict(participation=0.75, fault_profile="flaky",
                round_deadline=3.0, retry_backoff=1)


def expected_fault_metrics(fed, draws) -> tuple:
    """(stepped, the participation and fault metrics) a round under
    ``draws`` must report, from the draws alone."""
    import numpy as np
    from repro_torch.core.round import sync_faults
    from repro_torch.sim.faults import client_failed_mask, timed_out
    fc = sync_faults(fed)
    keep = draws.participation > 0
    fs = draws.faults
    arrive = keep & ~client_failed_mask(fs, fc)
    want = {"participants": float(keep.sum()),
            "arrivals": float(arrive.sum()),
            "fault_crashed": float(fs.crashed.sum()),
            "fault_dropped": float(fs.dropped.sum()),
            "fault_timeout": float(timed_out(fs, fc).sum())}
    return bool(np.any(arrive)), want


def fault_path(counts_of, dev):
    """One run (counts zeroed just before it, read just after), and the
    launches of each round read off the running counts: one aggregate
    and one update pass a round with an arrival, none in a round whose
    clients all failed; the metrics equal what the round's draws give."""
    import torch
    from repro_torch.launch.train import run_training

    per_round, seen = [], [counts_of.read()]

    def on_records(recs, trainer):
        torch.cuda.synchronize()
        now = counts_of.read()
        delta = {k: now[k] - seen[-1][k] for k in now}
        seen.append(now)
        rec = recs[0]
        stepped, want = expected_fault_metrics(
            trainer.fed, trainer.draw_round(rec["round"], COHORT))
        got = {k: rec[k] for k in want}
        assert got == want, (rec["round"], got, want)
        n = 1 if stepped else 0
        assert delta == _launches(aggregate_pass=n, update_pass=n), (
            rec["round"], delta)
        if not stepped:
            assert rec["client_loss"] == rec["grad_norm"] == \
                rec["meta_loss"] == 0.0, rec
        per_round.append((rec["round"], stepped, got, rec["retried"],
                          delta["aggregate_pass"], delta["update_pass"]))

    counts_of.reset()
    seen[0] = counts_of.read()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    state, hist = run_training(
        "smollm-360m", rounds=FAULT_ROUNDS, cohort=COHORT, client_batch=8,
        seq=128, algorithm="uga", meta=True, fused=True, strategy="vmap",
        server_opt="sgd", seed=0, log_every=1, device=dev,
        on_records=on_records, **FAULT_KW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    tag = "faults:vmap/sgd"
    counts = {tag: counts_of.read()}
    log(f"kernels: {tag} {json.dumps(counts[tag])}")
    n = sum(s for _, s, *_ in per_round)
    assert counts[tag] == _launches(aggregate_pass=n, update_pass=n)
    for rec in hist:
        assert all(math.isfinite(v) for v in rec.values()), rec
    for r, stepped, got, retried, na, nu in per_round:
        log(f"  round {r}: {'stepped' if stepped else 'all failed'}; "
            f"{json.dumps(got)}; retried {retried:g}; launches aggregate "
            f"{na}, update {nu} (as the draws give)")
    log(f"  {FAULT_ROUNDS} rounds in {wall:.2f} s (round 0 includes init "
        f"and data); max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del state
    torch.cuda.empty_cache()
    return counts


# Phase 6a: the buffered-async runtime on smollm-360m at full width.  The
# pool's bookkeeping is re-derived on the host from each tick's draws
# (``simulate_tick``: occupied slots as a list in logical order), and each
# tick's launches follow from it: one accumulate_pass per flushed delta,
# one update_pass per flush, no aggregate_pass (the vmap base's stack is
# pooled, not reduced).  The defaults: K = cohort = 4, capacity 8,
# invsqrt.  The pool is 8 x 1.447 GB = 10.78 GiB on top of the
# synchronous vmap round's 21.04 GiB peak; copying the pool on insert, as
# JAX's concatenate-and-gather does, would add about 16 GiB more.
ASYNC_KW = dict(engine="buffered_async", participation=0.75,
                fault_profile="flaky")
ASYNC_TICKS = 4
ASYNC_CLEAN_TICKS = 2            # fault-free K = capacity = cohort, scan
ASYNC_CODED_TICKS = 2            # int8 with error feedback, scan
ASYNC_PEAK_GIB = 21.04 + 10.78 + 2.0


def simulate_tick(pool, ver, tick, arrive, delay, K, cap):
    """The pool's bookkeeping for one tick, from its draws alone: ``pool``
    lists the occupied slots' [version, deliver] in logical order.
    Returns (pool, server version, the metrics the tick must report)."""
    import numpy as np
    cand = pool + [[ver, tick + int(d)] for ok, d in zip(arrive, delay)
                   if ok]
    cand = sorted(cand, key=lambda e: -e[0])          # stable: old first
    kept, overflow = cand[:cap], max(len(cand) - cap, 0)
    arrivals = sum(1 for _, d in kept if d == tick)
    stale = []
    steps = 0
    for _ in range(max(cap // K, 1)):
        ready = [i for i, (_, d) in enumerate(kept) if d <= tick]
        if len(ready) < K:
            break
        pick = set(sorted(ready, key=lambda i: (kept[i][1], i))[:K])
        stale += [ver - kept[i][0] for i in pick]
        kept = [e for i, e in enumerate(kept) if i not in pick]
        ver += 1
        steps += 1
    hist = [0.0] * 8
    for x in stale:
        hist[min(x, 7)] += 1.0
    mean = float(np.float32(sum(stale)) / np.float32(max(len(stale), 1)))
    return kept, ver, {"arrivals": float(arrivals),
                       "server_steps": float(steps),
                       "buffer_fill": float(len(kept)),
                       "overflow_dropped": float(overflow),
                       "staleness_hist": hist,
                       "staleness_max": float(max(stale, default=0)),
                       "staleness_mean": mean}


def _flat_params(state):
    from repro_torch.core import flat as F
    spec = F.make_flat_spec(state["params"])
    return F.flatten_tree(spec, state["params"])[0].clone()


def async_path(counts_of, dev):
    """Phase 6a: (i) two synchronous scan/sgd runs of 2 rounds from the
    same init, to see whether the card repeats a round bitwise, and the
    fault-free async tick (K = capacity = cohort, scan/sgd, 2 ticks)
    against them: bitwise if the two sync runs are, else within their
    gap; (ii) the defaults under participation 0.75 and 'flaky' (garble
    live), vmap/sgd, 4 ticks, each tick's metrics and launches held to
    ``simulate_tick`` of its draws, its wall time and the peak printed;
    (iii) int8 with error feedback on scan, 2 ticks: one quantize launch
    (with the residual) per client, no dequant-FMA launch.  Each run is
    its own main path: counts zeroed just before, read just after."""
    import numpy as np
    import torch
    from repro_torch.core.round import draw_round
    from repro_torch.launch.train import run_training

    base = dict(cohort=COHORT, client_batch=8, seq=128, algorithm="uga",
                meta=True, fused=True, seed=0, log_every=0, device=dev)
    counts, flats, hists = {}, {}, {}
    for tag, kw, n in (
            ("sync:scan/sgd#1", dict(strategy="scan"), ASYNC_CLEAN_TICKS),
            ("sync:scan/sgd#2", dict(strategy="scan"), ASYNC_CLEAN_TICKS),
            ("async-clean:scan/sgd", dict(
                strategy="scan", engine="buffered_async",
                async_buffer=COHORT, async_capacity=COHORT),
             ASYNC_CLEAN_TICKS)):
        counts_of.reset()
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, hist = run_training("smollm-360m", rounds=n, **base, **kw)
        torch.cuda.synchronize()
        counts[tag] = counts_of.read()
        flats[tag], hists[tag] = _flat_params(state), hist
        log(f"kernels: {tag} {json.dumps(counts[tag])}")
        assert counts[tag] == _scan_counts(n, False), counts[tag]
        log(f"  {tag}: {n} rounds in {time.perf_counter() - t:.2f} s")
        del state
        torch.cuda.empty_cache()
    a, b = flats["sync:scan/sgd#1"], flats["sync:scan/sgd#2"]
    c = flats["async-clean:scan/sgd"]
    keys = ("client_loss", "grad_norm", "meta_loss")
    sync_same = torch.equal(a, b) and all(
        x[k] == y[k] for x, y in zip(hists["sync:scan/sgd#1"],
                                     hists["sync:scan/sgd#2"]) for k in keys)
    gap = rel_err(b, a)
    e_async = min(rel_err(c, a), rel_err(c, b))
    same = "bitwise equal" if sync_same else f"params rel {gap:.3e} apart"
    log(f"  two sync scan/sgd runs, {ASYNC_CLEAN_TICKS} rounds: {same}; the "
        f"fault-free async ticks against them: params rel {e_async:.3e}, "
        f"bitwise {torch.equal(c, a) or torch.equal(c, b)}")
    for rec in hists["async-clean:scan/sgd"]:
        assert rec["server_steps"] == 1 and rec["arrivals"] == COHORT, rec
    if sync_same:
        assert torch.equal(c, a), e_async
        for x, y in zip(hists["async-clean:scan/sgd"],
                        hists["sync:scan/sgd#1"]):
            assert all(x[k] == y[k] for k in keys), (x, y)
    else:
        # the card does not repeat a round bitwise: hold the async ticks
        # to the gap between two identical sync runs
        assert e_async <= max(2 * gap, 1e-6) and e_async <= 1e-5, (
            e_async, gap)
    del a, b, c, flats

    # (ii) the defaults under faults, held tick by tick to the draws
    sim = {"pool": [], "ver": 0}
    per_tick, seen, marks = [], [counts_of.read()], []

    def on_records(recs, trainer):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        now = counts_of.read()
        delta = {k: now[k] - seen[-1][k] for k in now}
        seen.append(now)
        rec = recs[0]
        r = rec["round"]
        d = draw_round(trainer.fed, trainer.seed, r, COHORT)
        fs = d.faults
        arrive = (d.participation > 0) & (fs.alive > 0)
        sim["pool"], sim["ver"], want = simulate_tick(
            sim["pool"], sim["ver"], r, arrive, fs.delay, COHORT,
            2 * COHORT)
        want.update(participants=float(d.participation.sum()),
                    fault_crashed=float(fs.crashed.sum()),
                    fault_dropped=float(fs.dropped.sum()),
                    fault_delayed=float(fs.delayed.sum()))
        got = {k: rec[k] for k in want}
        assert got == want, (r, got, want)
        n = int(want["server_steps"])
        assert delta == _launches(accumulate_pass=COHORT * n,
                                  update_pass=n), (r, delta)
        if n == 0:
            assert rec["grad_norm"] == rec["meta_loss"] == 0.0, rec
        assert trainer.state["async"]["server_version"] == sim["ver"]
        per_tick.append((r, got, delta["accumulate_pass"],
                         delta["update_pass"], float(fs.garbled.sum())))

    tag = "async:vmap/sgd"
    counts_of.reset()
    seen[0] = counts_of.read()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    marks.append(time.perf_counter())
    state, hist = run_training("smollm-360m", rounds=ASYNC_TICKS, **base,
                               strategy="vmap", on_records=on_records,
                               **ASYNC_KW)
    counts[tag] = counts_of.read()
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"kernels: {tag} {json.dumps(counts[tag])}")
    steps = sum(int(g["server_steps"]) for _, g, *_ in per_tick)
    assert counts[tag] == _launches(accumulate_pass=COHORT * steps,
                                    update_pass=steps), counts[tag]
    for rec in hist:
        assert all(math.isfinite(x) for v in rec.values()
                   for x in (v if isinstance(v, list) else [v])), rec
    walls = [y - x for x, y in zip(marks, marks[1:])]
    for (r, got, na, nu, garbled), w in zip(per_tick, walls):
        log(f"  tick {r}: {json.dumps(got)}; garbled {garbled:g}; launches "
            f"accumulate {na}, update {nu} (as the draws give); wall "
            f"{w:.4f} s")
    log(f"  {ASYNC_TICKS} ticks (K {COHORT}, capacity {2 * COHORT}, "
        f"invsqrt; tick 0 includes init and data); max_memory_allocated "
        f"{peak:.2f} GiB (pool {2 * COHORT * FULL_ROWS * 512 / 2**30:.2f} "
        f"GiB; bound {ASYNC_PEAK_GIB:.2f})")
    assert steps > 0
    assert peak <= ASYNC_PEAK_GIB, peak
    del state
    torch.cuda.empty_cache()

    # (iii) int8 with error feedback on the scan base
    tag = "async-int8+ef:scan/sgd"
    counts_of.reset()
    state, hist = run_training(
        "smollm-360m", rounds=ASYNC_CODED_TICKS, **base, strategy="scan",
        engine="buffered_async", codec="int8", error_feedback=True)
    counts[tag] = counts_of.read()
    log(f"kernels: {tag} {json.dumps(counts[tag])}")
    n = ASYNC_CODED_TICKS
    assert counts[tag] == _launches(quantize_i8_pass=COHORT * n,
                                    accumulate_pass=COHORT * n,
                                    update_pass=n), counts[tag]
    comm_bytes = float(np.float32(payload_bytes("int8", FULL_N_VALID))
                       * np.float32(COHORT))          # in fp32, as JAX's
    for rec in hist:
        assert rec["comm_bytes"] == comm_bytes, rec
        assert rec["server_steps"] == 1, rec
    res = state["comm"]["residual"][0]
    assert bool(torch.isfinite(res).all()) and float(res.abs().max()) > 0
    log(f"  {tag}: {n} ticks, comm_bytes {hist[-1]['comm_bytes']:.0f} a "
        f"tick, residual max |r| {float(res.abs().max()):.3e}")
    del state, res
    torch.cuda.empty_cache()
    return counts


def ckpt_path_check(dev):
    """Phase 6k: the full-width server state through a blob and back,
    bitwise: post vmap/sgd after one round, and adam after one round (m, v
    and t); the seconds and bytes of each save and restore; the blobs are
    removed.  The async pool (8 slots of 1.447 GB in one leaf) exceeds a
    msgpack bin and must be refused before anything is written."""
    import shutil

    import torch
    from repro_torch.configs import FedConfig, get_arch
    from repro_torch.core.trainer import FederatedTrainer
    from repro_torch.launch.train import build_synthetic_fed_data
    from repro_torch.models.model import build_model

    out_dir = os.path.join(HERE, "build", "ckpt_smoke")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    cfg = get_arch("smollm-360m")
    model = build_model(cfg, loss_chunk=256)
    data = build_synthetic_fed_data(cfg, num_clients=32, examples=2048,
                                    seq=128, iid=False)
    try:
        for opt in ("sgd", "adam"):
            fed = FedConfig(algorithm="uga", meta=True, cohort=COHORT,
                            client_lr=0.01, server_lr=0.01, meta_lr=0.01,
                            lr_decay=0.992, fused_update=True,
                            server_opt=opt)
            tr = FederatedTrainer(model, fed, device=dev, seed=0)
            tr.run(data, rounds=1, cohort=COHORT, batch=8, meta_batch=16)
            path = os.path.join(out_dir, f"{opt}.msgpack")
            torch.cuda.synchronize()
            t = time.perf_counter()
            tr.save(path, extra={"arch": cfg.name})
            t_save = time.perf_counter() - t
            fresh = FederatedTrainer(model, fed, device=dev, seed=1)
            torch.cuda.synchronize()
            t = time.perf_counter()
            extra = fresh.restore(path)
            torch.cuda.synchronize()
            t_restore = time.perf_counter() - t
            la = _leaves_of(tr.checkpoint_tree())
            lb = _leaves_of(fresh.checkpoint_tree())
            assert [p for p, _ in la] == [p for p, _ in lb]
            for (p, x), (_, y) in zip(la, lb):
                assert _bitwise(x, y), p
                assert not isinstance(y, torch.Tensor) or y.device == x.device
            assert extra == {"arch": cfg.name} and fresh.history == tr.history
            size = os.path.getsize(path)
            log(f"  post vmap/{opt} after 1 round: {len(la)} leaves "
                f"({', '.join(sorted({p.split('/')[0] for p, _ in la}))}), "
                f"blob {size:,} bytes; save {t_save:.2f} s "
                f"({size / t_save / 1e9:.2f} GB/s), restore {t_restore:.2f} "
                f"s ({size / t_restore / 1e9:.2f} GB/s); bitwise equal")
            os.remove(path)
            del tr, fresh, la, lb
            torch.cuda.empty_cache()
        fed = FedConfig(algorithm="uga", meta=True, cohort=COHORT,
                        fused_update=True, engine="buffered_async")
        tr = FederatedTrainer(model, fed, device=dev, seed=0)
        path = os.path.join(out_dir, "async.msgpack")
        try:
            tr.save(path)
            raise AssertionError("a full-width async pool was saved")
        except ValueError as e:
            assert "async/pool/0" in str(e) and not os.listdir(out_dir), e
            log(f"  full-width async state refused before writing: {e}")
        del tr
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 6p: the paper's own models at their published widths
# ---------------------------------------------------------------------------
# The CIFAR CNN, the FEMNIST CNN and the Shakespeare GRU (configs/
# paper_models.py), FedMeta w/ UGA through experiments/common.py::
# train_method on the synthetic stand-ins at the paper's input sizes:
# CIFAR 32x32x3, 10 classes, 100 IID clients, E 2 local steps of B 64;
# FEMNIST 28x28x1, 62 classes, 100 writers with Dir(0.2) label skew, E 5
# of B 64; Shakespeare vocab 90, 80 characters, 100 roles, 4 steps of B
# 10 (``repro_torch.experiments.paper``: 20,000 images or 10,000
# sequences).  Cohort 10, D_meta 1% of the data; the learning rates of
# the JAX package's benchmarks.  The CNNs' dropout masks are the trainer's host
# draws.  Each run's launches are held to exactly its cohort's.
PAPER_COHORT = 10
# rounds of FedMeta w/ UGA on the vmap cohort, evaluated at the first and
# the last; the GRU's round is a Python loop over 80 positions a pass
# (14-24 s on the card), so it runs two, both evaluated
PAPER_ROUNDS = {"paper-cifar-cnn": 4, "paper-femnist-cnn": 4,
                "paper-shakespeare-gru": 2}
PAPER_ROWS = {"paper-cifar-cnn": 10_848, "paper-femnist-cnn": 13_208,
              "paper-shakespeare-gru": 31_648}
PAPER_N_PARAMS = {"paper-cifar-cnn": 1_387_786,
                  "paper-femnist-cnn": 1_690_046,
                  "paper-shakespeare-gru": 4_050_522}
PAPER_EVAL = 1000                # held-out examples evaluated
# vmap and scan differ in the order they sum G (1e-7 apart), as on
# smollm-360m
PAPER_VMAP_SCAN_TOL = 1e-5


PAPER_EXAMPLES = {"paper-cifar-cnn": 20_000, "paper-femnist-cnn": 20_000,
                  "paper-shakespeare-gru": 10_000}


def paper_run(counts_of, dev, tag, model, data, eval_idx, method, rounds,
              kw, strategy="vmap"):
    """One ``train_method`` run, its own main path (counts zeroed just
    before, read just after, held to its cohort's launches).  Returns
    (counts, round walls, peak GiB, history, round-0 params, final
    params)."""
    import torch
    from repro_torch.experiments.common import train_method

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    marks, copy_s, keep = [time.perf_counter()], [0.0], {}

    def on_records(recs, trainer):
        torch.cuda.synchronize()
        marks.append(time.perf_counter() - copy_s[0])
        t = time.perf_counter()
        snap = {k: v.detach().cpu() for k, v in
                trainer.state["params"].items()}
        keep.setdefault("round0", snap)
        keep["final"] = snap
        copy_s[0] += time.perf_counter() - t

    counts_of.reset()
    hist = train_method(model, data, method, rounds=rounds,
                        cohort=PAPER_COHORT, eval_idx=eval_idx,
                        eval_every=rounds, seed=0, device=dev,
                        cohort_strategy=strategy, on_records=on_records,
                        rounds_per_call=1, **kw)
    counts = counts_of.read()
    want = (_launches(aggregate_pass=rounds, update_pass=rounds)
            if strategy == "vmap" else
            _launches(accumulate_pass=rounds * PAPER_COHORT,
                      update_pass=rounds))
    log(f"kernels: {tag} {json.dumps(counts)}")
    assert counts == want, (tag, counts, want)
    for h in hist:
        assert all(math.isfinite(v) for v in h.values()), (tag, h)
    secs = [b - a for a, b in zip(marks, marks[1:])]
    peak = torch.cuda.max_memory_allocated() / 2**30
    return counts, secs, peak, hist, keep["round0"], keep["final"]


def paper_path(counts_of, dev):
    """Phase 6p: each paper model at full width, FedMeta w/ UGA on the
    vmap cohort, ``PAPER_ROUNDS`` rounds; the CIFAR CNN also on scan (2
    rounds, held to vmap after round 0); the FEMNIST CNN also through all
    six methods, 2 rounds each."""
    import numpy as np
    import torch
    from repro_torch.core import flat as F
    from repro_torch.experiments.common import METHODS, evaluate
    from repro_torch.experiments.paper import paper_setup

    counts = {}
    for name in PAPER_ROWS:
        t = time.perf_counter()
        model, data, eval_idx, kw = paper_setup(
            name, n=PAPER_EXAMPLES[name], n_eval=PAPER_EVAL)
        setup_s = time.perf_counter() - t
        tag = f"paper:{name}:vmap"
        c, secs, peak, hist, r0, final = paper_run(
            counts_of, dev, tag, model, data, eval_idx, "fedmeta_uga",
            PAPER_ROUNDS[name], kw)
        counts[tag] = c
        spec = F.make_flat_spec(final)
        n = spec.groups[0].size
        assert n == PAPER_N_PARAMS[name] and \
            spec.groups[0].rows == PAPER_ROWS[name], (name, n)
        params = {k: v.to(dev) for k, v in final.items()}
        torch.cuda.synchronize()
        t = time.perf_counter()
        ev = evaluate(model, params, data, eval_idx)
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t
        del params
        evs = [(h["round"], round(h["acc"], 4), round(h["loss"], 4))
               for h in hist]
        log(f"  {tag}: params {n:,}, flat rows {spec.groups[0].rows:,} x "
            f"128; data made in {setup_s:.2f} s; round wall s "
            f"{[round(x, 4) for x in secs]} (round 0 includes init; rounds "
            f"0 and {PAPER_ROUNDS[name] - 1} include an evaluation of "
            f"{PAPER_EVAL} examples, {eval_s:.4f} s alone); steady "
            + (f"{np.mean(secs[1:-1]):.4f} s" if len(secs) > 2 else
               "none (every round evaluated)") + "; max_memory_allocated "
            f"{peak:.3f} GiB; (round, eval acc, eval loss) {evs}; the "
            f"evaluation of the final params again: {ev}")
        if name == "paper-cifar-cnn":
            stag = f"paper:{name}:scan"
            c, secs, peak, _, s0, _ = paper_run(
                counts_of, dev, stag, model, data, eval_idx, "fedmeta_uga",
                2, kw, strategy="scan")
            counts[stag] = c
            e = max(rel_err(s0[k], r0[k]) for k in r0)
            log(f"  {stag}: round wall s {[round(x, 4) for x in secs]}; "
                f"max_memory_allocated {peak:.3f} GiB; params after round 0 "
                f"against vmap's: rel {e:.3e} (tol {PAPER_VMAP_SCAN_TOL:g})")
            assert e <= PAPER_VMAP_SCAN_TOL, e
        if name == "paper-femnist-cnn":
            for method in METHODS:
                mtag = f"paper:{name}:{method}"
                t = time.perf_counter()
                c, secs, peak, hist, _, _ = paper_run(
                    counts_of, dev, mtag, model, data, eval_idx, method, 2,
                    kw)
                counts[mtag] = c
                log(f"  {mtag}: 2 rounds in {time.perf_counter() - t:.3f} "
                    f"s, round wall s {[round(x, 4) for x in secs]}; "
                    f"max_memory_allocated {peak:.3f} GiB; eval acc "
                    f"{[round(h['acc'], 4) for h in hist]}")
        del model, data
        torch.cuda.empty_cache()
    return counts


def small_reference_paper(dev):
    """Phase 7p: the CIFAR CNN (dropout 0.2 under the trainer's host
    draws, which are the same bits on both devices) and the Shakespeare
    GRU at smoke size, FedMeta w/ UGA, 3 rounds through train_method, the
    card against the CPU plain versions from the same parameters: the
    evaluations (loss <= 1e-4, the same count of right predictions) and
    the parameters (<= 1e-5)."""
    import numpy as np
    import torch
    from repro_torch.configs import paper_models as pm
    from repro_torch.data.partition import partition_by_writer, partition_iid
    from repro_torch.data.pipeline import FederatedData
    from repro_torch.data.synthetic import synthetic_chars, synthetic_images
    from repro_torch.experiments.common import train_method
    from repro_torch.models.model import build_paper_cnn, build_paper_gru

    rng = np.random.default_rng(1)
    img = synthetic_images(rng, n=200, image_size=32, channels=3,
                           num_classes=10, num_writers=10)
    chars = synthetic_chars(rng, n=200, seq_len=21, num_roles=10)
    meta = rng.choice(200, 16, replace=False)
    cases = (
        (build_paper_cnn(pm.CIFAR_CNN_SMOKE),
         FederatedData(arrays={"x": img.x, "y": img.y},
                       client_indices=partition_iid(rng, 200, 10),
                       meta_indices=meta, shared_indices=meta),
         dict(local_steps=2, batch=8, lr=0.05, uga_server_lr=0.1)),
        (build_paper_gru(pm.SHAKESPEARE_GRU_SMOKE),
         FederatedData(arrays={"tokens": chars.tokens},
                       client_indices=partition_by_writer(chars.role,
                                                          range(10)),
                       meta_indices=meta, shared_indices=meta),
         dict(local_steps=4, batch=8, lr=0.5, uga_server_lr=1.0,
              clip_norm=0.5)))
    for model, data, kw in cases:
        params = model.init(torch.Generator().manual_seed(3))
        out = {}
        for d in (dev, torch.device("cpu")):
            final = {}
            hist = train_method(
                model, data, "fedmeta_uga", rounds=3, cohort=3,
                eval_idx=np.arange(0, 200, 2), eval_every=1, device=d,
                params=params, meta_batch=8, rounds_per_call=1,
                on_records=lambda recs, tr: final.update(tr.state["params"]),
                **kw)
            out[d.type] = (hist, final)
        (hg, pg), (hc, pc) = out["cuda"], out["cpu"]
        for a, b in zip(hg, hc):
            assert abs(a["acc"] - b["acc"]) <= 1e-6, (a, b)
            for k in ("loss", "client_loss"):
                assert abs(a[k] - b[k]) <= 1e-4 * abs(b[k]), (a, b)
        worst = max(rel_err(pg[k].cpu(), pc[k]) for k in pc)
        log(f"  {model.name}, card vs CPU plain, 3 rounds: evaluations "
            f"within 1e-4 (accuracy within 1e-6: the same count), params "
            f"rel {worst:.3e} (tol 1e-5)")
        assert worst <= 1e-5, worst


# ---------------------------------------------------------------------------
# phase 6c: the chunked streaming cohort and the two-tier sharded executor
# ---------------------------------------------------------------------------
# smollm-360m at full width, UGA + FedMeta, sgd, client batch 8, seq 128,
# the paper's cohort of 10 (arXiv:1910.08234 §4) streamed in chunks of 4:
# three chunks, the last padded with two weight-0 replicas of its first
# client, so 12 slots a round.  Every slot launches one accumulate_pass
# (a pad slot adds 0 * g), and under through_aggregation its backward one
# accumulate_pass_bwd; under int8 + error feedback every slot launches one
# quantize_i8_pass (with residual; a pad slot codes against a zero
# residual that stays zero) and one dequant_i8_fma_pass, and no
# accumulate_pass.  The sharded run is a world of one (NCCL) from the
# same state and inputs as the chunked post run's round 0, held to it
# bitwise.
CHUNK_COHORT, CHUNK = 10, 4
CHUNK_SLOTS = -(-CHUNK_COHORT // CHUNK) * CHUNK          # 12
# tag -> (rounds, meta mode, codec, error feedback, executor)
CHUNKED_RUNS = {
    "chunked:post": (2, "post", "none", False, None),
    "chunked:through_aggregation": (1, "through_aggregation", "none", False,
                                    None),
    "chunked:int8+ef": (2, "post", "int8", True, None),
    "sharded:post": (1, "post", "none", False, "sharded"),
}


def _chunked_counts(rounds, mode, codec):
    if codec == "int8":
        return _launches(quantize_i8_pass=rounds * CHUNK_SLOTS,
                         dequant_i8_fma_pass=rounds * CHUNK_SLOTS,
                         update_pass=rounds)
    bwd = mode == "through_aggregation"
    return _launches(accumulate_pass=rounds * CHUNK_SLOTS,
                     update_pass=rounds,
                     accumulate_pass_bwd=rounds * CHUNK_SLOTS if bwd else 0,
                     update_pass_bwd=rounds if bwd else 0)


def chunked_path(counts_of, dev, runs=None):
    """Each of the four runs (``runs``: those tags only) is its own main
    path: ``run_training`` with ``cohort_chunk`` (and
    ``executor='sharded'``), the launch counts zeroed just before it and
    read just after, held exactly; finite metrics; the round walls and
    the peak printed.  Returns the counts."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.core import flat as F
    from repro_torch.launch.train import run_training

    counts, round0, res0 = {}, {}, {}
    log(f"  allocated before the phase: "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    for tag, (rounds, mode, codec, ef, executor) in CHUNKED_RUNS.items():
        if runs is not None and tag not in runs:
            continue
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        marks = [time.perf_counter()]

        def on_records(recs, trainer, tag=tag, ef=ef, marks=marks):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            r = recs[0]["round"]
            if r == 0 and tag.endswith(":post"):
                params = trainer.state["params"]
                round0[tag] = ([b.clone() for b in F.flatten_tree(
                    F.make_flat_spec(params), params)], dict(recs[0]))
            if ef:
                (res,) = trainer.state["comm"]["residual"]
                assert res.shape == (CHUNK_COHORT, FULL_ROWS, 128), res.shape
                nz = [float(res[k].abs().max()) for k in range(CHUNK_COHORT)]
                assert all(math.isfinite(v) and v > 0 for v in nz), (tag, nz)
                # every 997th row of each client's residual (14.5 MB; a
                # whole copy, 13.5 GiB, would not fit beside the round)
                sample = res[:, ::997].clone()
                if r == 0:
                    res0[tag] = sample
                else:
                    moved = [not torch.equal(sample[k], res0[tag][k])
                             for k in range(CHUNK_COHORT)]
                    assert all(moved), (tag, moved)
                log(f"  {tag}: residual max |r| per client after round {r}: "
                    f"{[f'{v:.3e}' for v in nz]}")

        counts_of.reset()
        state, hist = run_training(
            "smollm-360m", rounds=rounds, cohort=CHUNK_COHORT,
            client_batch=8, seq=128, algorithm="uga", meta=True, fused=True,
            cohort_chunk=CHUNK, executor=executor, server_opt="sgd",
            meta_mode=mode, codec=codec, error_feedback=ef, seed=0,
            log_every=1, device=dev, on_records=on_records)
        counts[tag] = counts_of.read()
        log(f"kernels: {tag} {json.dumps(counts[tag])}")
        want = _chunked_counts(rounds, mode, codec)
        assert counts[tag] == want, (tag, counts[tag], want)
        n_params = sum(p.numel() for p in state["params"].values())
        assert n_params == FULL_N_VALID, n_params
        for rec in hist:
            for k, v in rec.items():
                assert math.isfinite(v), (tag, rec)
            if codec == "int8":
                want_b = float(np.float32(payload_bytes(codec, FULL_N_VALID))
                               * np.float32(CHUNK_COHORT))
                assert rec["comm_bytes"] == want_b, (tag, rec, want_b)
            if mode != "post":
                assert rec["ctrl_w_gnorm"] > 0, (tag, rec)
        if mode != "post":
            assert state["ctrl"]["w_logits"].shape == (CHUNK_COHORT,)
        secs = [b - a for a, b in zip(marks, marks[1:])]
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"  {tag}: round wall s {[round(x, 4) for x in secs]} (round 0 "
            f"includes init and data)  max_memory_allocated {peak:.2f} GiB "
            f"(reserved {torch.cuda.max_memory_reserved() / 2**30:.2f})")
        del state
        res0.pop(tag, None)
        torch.cuda.empty_cache()
        if executor == "sharded":
            dist.destroy_process_group()

    if "sharded:post" in round0:
        (a, ra), (b, rb) = round0["chunked:post"], round0["sharded:post"]
        same = all(torch.equal(x, y) for x, y in zip(a, b)) and ra == rb
        log(f"  sharded (world of 1, NCCL) vs chunked after round 0: params "
            f"and metrics bitwise {same}")
        assert same, (ra, rb)
    return counts


# ---------------------------------------------------------------------------
# phases 6x and 6y: the model axis — tensor-parallel client compute, two
# ranks on the one card
# ---------------------------------------------------------------------------
# Each run of MODEL_AXIS_RUNS at full width, only its depth cut (the
# layers listed there), UGA + FedMeta post, client batch 8, seq 128, sgd,
# 2 rounds, the cohort streamed in chunks of 2.  First a world of one in
# this process (run_training with executor='sharded', mesh_model=1: NCCL,
# one process), whose flat parameters after each round go to build/ and
# whose records are kept; then, once this process has released the card,
# the same runs on a (1, 2) mesh: two processes of one torchrun job
# (python -m torch.distributed.run --nproc-per-node 2 chip_smoke.py
# --model-axis-rank DIR), both on cuda:0 over gloo by the mesh's
# shared-card rule, every run in turn (the spawn paid once), each rank's
# client compute on its parameter shards.  After each round: params
# within 1e-5 and metrics within 1e-4 of the world of one (rank 0 against
# the saved flat buffer), the two ranks' params bitwise equal (a 64-bit
# hash of the flat buffer's bits, odd weights by position, all-gathered:
# two buffers that differ in one element always hash apart), each rank's
# launches exactly (one accumulate_pass a slot over all rows, one
# update_pass a round on its half of the rows).  A MoE run's routing
# (every layer's expert indices and capacity keeps) in one forward of a
# seeded init on a fixed batch is held bitwise to the world of one's.
# Printed: the round walls, each rank's peak, each rank's time in the
# model-axis collectives by kind.
#   6x: smollm-360m (15 / 5 heads do not split in 2: q/k/v gathered,
#       attention whole on both ranks; the MLP and the vocab split) at the
#       paper's cohort of 10.  Cut to 8 of 32 layers so that 6y fits
#       the call (at 32 layers 6x alone took 169.8 s);
#   6y: the layer kinds, cohort 4: deepseek-v2-lite-16b, 1 of 27 layers
#       (MLA on each rank's 8 of 16 heads, 32 of the 64 experts a rank,
#       the shared experts split); mamba2-780m, 4 of 48 layers (the mixer
#       on each rank's 24 of 48 heads); whisper-large-v3, 2 decoder
#       layers (self, then cross) and 2 of 32 encoder layers over 1500
#       frames (10 of 20 heads a rank, the GELU MLP split).
# Client (and so server and meta) lr 0.01, the launcher's default, but
# mamba2-780m's 0.001 at 4 layers.  A mamba2-780m run's own trajectory
# is too sensitive deeper or faster to be held to 1e-5 / 1e-4 by any
# implementation: perturbing only its init by 1e-7 moves its world of one
# (tools/sensitivity_check.py) by params 1.2e-5 and 2.5e-3 after rounds
# 0 and 1 at 8 layers and lr 0.01, grad_norm 9.3e-4 at 8 layers and lr
# 0.001, params 2.3e-5 at 16 layers and lr 0.001; at 4 layers and lr
# 0.001 by params 1.3e-7 and grad_norm 1.1e-5, as the other runs (params
# 2.4e-7).
# The job runs beside phase 7: started before it, joined after it.
MODEL_AXIS = 2
MODEL_AXIS_ROUNDS = 2
MODEL_AXIS_TIMEOUT = 700
# tag -> (arch, layers, cohort, chunk, client lr)
MODEL_AXIS_RUNS = {
    "6x:smollm-360m": ("smollm-360m", 8, CHUNK_COHORT, 2, 0.01),
    "6y:deepseek-v2-lite-16b": ("deepseek-v2-lite-16b", 1, 4, 2, 0.01),
    "6y:mamba2-780m": ("mamba2-780m", 4, 4, 2, 0.001),
    "6y:whisper-large-v3": ("whisper-large-v3", 2, 4, 2, 0.01),
}
MODEL_AXIS_DIR = os.path.join(HERE, "build", "model_axis")
HASH_CHUNK = 1 << 26             # elements a step of flat_hash / flat_err


def axis_rows(arch, layers) -> tuple:
    """(the flat rows of ``arch`` cut to ``layers``, a rank's share)."""
    from repro_torch.configs import get_arch, with_depth
    from repro_torch.core.flat import make_flat_spec
    from repro_torch.models.transformer import Transformer
    cfg = with_depth(get_arch(arch), layers)
    spec = make_flat_spec(dict(Transformer(cfg).named_parameters()))
    rows = spec.groups[0].rows
    return rows, rows // MODEL_AXIS


def axis_run(spec, dev, mesh_model, on_records):
    """One run of MODEL_AXIS_RUNS through ``run_training``."""
    from repro_torch.launch.train import run_training
    arch, layers, cohort, chunk, lr = spec
    return run_training(
        arch, layers=layers, rounds=MODEL_AXIS_ROUNDS, cohort=cohort,
        client_batch=8, seq=128, algorithm="uga", meta=True, fused=True,
        client_lr=lr,
        cohort_chunk=chunk, executor="sharded", mesh_model=mesh_model,
        server_opt="sgd", meta_mode="post", seed=0, log_every=1,
        device=dev, on_records=on_records)


def route_probe(arch, layers, dev, mesh=None) -> list:
    """Every MoE layer's (expert indices, keeps), on the host, in one
    forward of a seeded init (seed 0) on fixed tokens (8 x 129); over
    ``mesh``'s model axis where given.  None for a config without MoE."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch, with_depth
    from repro_torch.models import moe as MOE
    from repro_torch.models.model import build_model
    from repro_torch.sharding.tensor_parallel import model_axis
    cfg = with_depth(get_arch(arch), layers)
    if cfg.moe is None:
        return None
    model = build_model(cfg, dtype=torch.float32, loss_chunk=256)
    params = model.init(torch.Generator(dev).manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (8, 129))).to(dev)
    recs, orig = [], MOE._route

    def route(xg, p, c):
        out = orig(xg, p, c)
        recs.append((out[1].cpu(), out[3].cpu()))
        return out
    MOE._route = route
    try:
        with torch.no_grad():
            if mesh is None:
                model.loss(params, {"tokens": tokens})
            else:
                axis = model_axis(mesh, params)
                model.loss(axis.shard(params), {"tokens": tokens}, tp=axis)
    finally:
        MOE._route = orig
    del params
    return recs


def flat_hash(flat):
    """A 64-bit hash of a flat buffer's bits: sum of bits x (2i + 1) and
    sum of bits, in int64 (wrapping)."""
    import torch
    bits = flat.reshape(-1).view(torch.int32)
    out = torch.zeros(2, dtype=torch.int64, device=flat.device)
    for i in range(0, bits.numel(), HASH_CHUNK):
        b = bits[i:i + HASH_CHUNK].long()
        w = torch.arange(i, i + b.numel(), device=flat.device) * 2 + 1
        out += torch.stack([(b * w).sum(), b.sum()])
    return out


def flat_err(flat, ref) -> float:
    """max |flat - ref| over max |ref|; ``ref`` a host array (a memmap)."""
    import numpy as np
    import torch
    a = flat.reshape(-1)
    diff = top = 0.0
    for i in range(0, a.numel(), HASH_CHUNK):
        b = torch.from_numpy(np.ascontiguousarray(
            ref.reshape(-1)[i:i + HASH_CHUNK])).to(a.device)
        diff = max(diff, float((a[i:i + b.numel()] - b).abs().max()))
        top = max(top, float(b.abs().max()))
    return diff / max(top, 1e-30)


def _slug(tag) -> str:
    return tag.replace(":", "_")


def model_axis_refs(counts_of, dev, runs=MODEL_AXIS_RUNS) -> dict:
    """Each run's world of one in this process, each its own main path
    (the counts zeroed just before it, read just after, held exactly):
    the flat parameters after each round to ``MODEL_AXIS_DIR/<tag>_r<n>.npy``,
    the records and the MoE routing to ``<tag>.pt``, the runs to
    ``runs.json``.  Returns the counts."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.core import flat as F
    os.makedirs(MODEL_AXIS_DIR, exist_ok=True)
    counts = {}
    for tag, spec in runs.items():
        arch, layers, cohort, chunk, lr = spec
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        routes = route_probe(arch, layers, dev)
        torch.cuda.empty_cache()
        records, marks = [], [time.perf_counter()]

        def on_records(recs, trainer, tag=tag, records=records,
                       marks=marks):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            params = trainer.state["params"]
            (flat,) = F.flatten_tree(F.make_flat_spec(params), params)
            np.save(os.path.join(MODEL_AXIS_DIR, f"{_slug(tag)}_r"
                                 f"{recs[0]['round']}.npy"),
                    flat.cpu().numpy())
            records.append(dict(recs[0]))
            del flat

        counts_of.reset()
        state, hist = axis_run(spec, dev, 1, on_records)
        counts[f"model_axis_ref:{tag}"] = c = counts_of.read()
        slots = -(-cohort // chunk) * chunk
        want = _launches(accumulate_pass=MODEL_AXIS_ROUNDS * slots,
                         update_pass=MODEL_AXIS_ROUNDS)
        log(f"kernels: model_axis_ref:{tag} {json.dumps(c)}")
        assert c == want, (tag, c, want)
        rows = axis_rows(arch, layers)[0]
        n = sum(p.numel() for p in state["params"].values())
        for rec in hist:
            assert all(math.isfinite(v) for v in rec.values()), (tag, rec)
        log(f"  {tag} world of one: {arch} at {layers} layers, {n:,} "
            f"parameters ({rows:,} flat rows), cohort {cohort} in chunks "
            f"of {chunk}, lr {lr}: round wall s "
            f"{[round(b - a, 4) for a, b in zip(marks, marks[1:])]} "
            f"(round 0 includes init and data; each includes the host copy "
            f"of the flat parameters)  max_memory_allocated "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; routing "
            f"probe: {'none' if routes is None else len(routes)} MoE layers")
        torch.save({"records": records, "routes": routes},
                   os.path.join(MODEL_AXIS_DIR, f"{_slug(tag)}.pt"))
        del state
        dist.destroy_process_group()
        torch.cuda.empty_cache()
    with open(os.path.join(MODEL_AXIS_DIR, "runs.json"), "w") as f:
        json.dump(runs, f)
    return counts


def model_axis_rank(ref_dir: str) -> int:
    """The body of one rank of phases 6x and 6y (``--model-axis-rank
    DIR``, under torchrun): every run of ``DIR/runs.json`` in turn, one
    ``{"model_axis_rank": ...}`` line each; exits 1 if a check fails."""
    import gc

    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.core import flat as F
    from repro_torch.device import strict_fp32
    from repro_torch.kernels.comm import kernel as CK
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.fused_update import kernel as K
    from repro_torch.kernels.fused_update import ops as O
    from repro_torch.kernels.ssd_scan import kernel as SK
    from repro_torch.launch.mesh import make_auto_mesh
    from repro_torch.sharding import tensor_parallel as TP

    torch.set_num_threads(2)
    strict_fp32()
    rank = int(os.environ["RANK"])
    with open(os.path.join(ref_dir, "runs.json")) as f:
        runs = json.load(f)
    # the time in the model-axis collectives, each call synchronized; the
    # flat buffers' (G's sum, the updated rows' gather) apart
    coll, flat_numel = {}, [0]

    def reset_coll():
        coll.clear()
        coll.update({k: [0, 0, 0.0] for k in (
            "all_reduce", "all_gather", "flat all_reduce",
            "flat all_gather")})

    def timed(kind, fn):
        def call(x, *a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(x, *a, **k)
            torch.cuda.synchronize()
            c = coll[("flat " if x.numel() >= flat_numel[0] else "") + kind]
            c[0], c[1] = c[0] + 1, c[1] + x.numel() * x.element_size()
            c[2] += time.perf_counter() - t
            return out
        return call
    TP.all_reduce_copy = timed("all_reduce", TP.all_reduce_copy)
    TP.all_gather_cat = timed("all_gather", TP.all_gather_cat)
    # the rows of each update_pass: the engine calls the kernel module
    # through ops.K, which becomes a view of it with a recording
    # update_pass in front (the kernel's own launch count is untouched)
    update_rows = []

    def spy_update(G, *a, **k):
        update_rows.append(int(G.shape[0]))
        return K.update_pass(G, *a, **k)
    O.K = types.SimpleNamespace(**{**vars(K), "update_pass": spy_update})
    counts_of = Counts(K, CK, FK, SK)

    for tag, spec in runs.items():
        arch, layers = spec[:2]
        slug = os.path.join(ref_dir, _slug(tag))
        ref = torch.load(slug + ".pt", weights_only=False)
        flat_numel[0] = axis_rows(arch, layers)[1] * 128
        out = {"rank": rank, "tag": tag, "errs": [], "metric_errs": [],
               "bitwise": [], "walls": []}
        reset_coll()
        if ref["routes"] is not None:
            mine = route_probe(arch, layers, "cuda",
                               make_auto_mesh(MODEL_AXIS, device="cuda"))
            out["routes_equal"] = len(mine) == len(ref["routes"]) and all(
                torch.equal(a, c) and torch.equal(b, d)
                for (a, b), (c, d) in zip(mine, ref["routes"]))
            torch.cuda.empty_cache()
        reset_coll()
        update_rows.clear()
        marks = [time.perf_counter()]

        def on_records(recs, trainer, slug=slug, ref=ref, out=out,
                       marks=marks):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            r = recs[0]["round"]
            params = trainer.state["params"]
            (flat,) = F.flatten_tree(F.make_flat_spec(params), params)
            h = flat_hash(flat)
            hs = [torch.empty_like(h) for _ in range(dist.get_world_size())]
            dist.all_gather(hs, h)
            out["bitwise"].append(all(torch.equal(x, hs[0]) for x in hs))
            if rank == 0:
                out["errs"].append(flat_err(flat, np.load(
                    f"{slug}_r{r}.npy", mmap_mode="r")))
                out["metric_errs"].append({
                    k: rel_err(torch.tensor(float(recs[0][k])),
                               torch.tensor(float(v)))
                    for k, v in ref["records"][r].items() if k != "round"})
            del flat

        torch.cuda.reset_peak_memory_stats()
        counts_of.reset()
        state, hist = axis_run(spec, "cuda", MODEL_AXIS, on_records)
        out["counts"] = counts_of.read()
        out["update_rows"] = list(update_rows)
        out["walls"] = [b - a for a, b in zip(marks, marks[1:])]
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        out["collectives"] = {k: list(v) for k, v in coll.items()}
        out["hist"] = hist
        out["device"] = str(state["params"]["embed"].device)
        print(json.dumps({"model_axis_rank": out}), flush=True)
        del state
        gc.collect()
        torch.cuda.empty_cache()
        dist.barrier()
    dist.destroy_process_group()
    return 0


def start_model_axis(runs=MODEL_AXIS_RUNS) -> dict:
    """The model axis's two ranks under torchrun, started in the
    background over ``runs``, whose references :func:`model_axis_refs`
    wrote (their output to files under build/).  Join with
    :func:`finish_model_axis`."""
    import torch
    paths = {k: os.path.join(HERE, "build", f"model_axis_{k}")
             for k in ("out.txt", "err.txt")}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"  6x/6y: this process holds "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        f"({torch.cuda.memory_reserved() / 2**30:.2f} reserved) on the card")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(MODEL_AXIS),
           os.path.join(HERE, "chip_smoke.py"), "--model-axis-rank",
           MODEL_AXIS_DIR]
    files = {k: open(paths[k], "w") for k in ("out.txt", "err.txt")}
    proc = subprocess.Popen(cmd, stdout=files["out.txt"],
                            stderr=files["err.txt"], text=True,
                            env={**os.environ, "OMP_NUM_THREADS": "2"})
    return {"proc": proc, "paths": paths, "files": files, "runs": runs,
            "t0": time.perf_counter()}


def stop_model_axis(job: dict) -> None:
    """Kill the ranks if they still run; close and remove the files and
    the references."""
    import shutil
    p = job["proc"]
    if p.poll() is None:
        p.kill()
        p.wait()
    for f in job["files"].values():
        f.close()
    for path in job["paths"].values():
        if os.path.exists(path):
            os.remove(path)
    shutil.rmtree(MODEL_AXIS_DIR, ignore_errors=True)


def finish_model_axis(job: dict) -> dict:
    """Phases 6x and 6y's checks, once the ranks end; returns their launch
    counts."""
    p, runs = job["proc"], job["runs"]
    try:
        p.wait(timeout=max(1.0, MODEL_AXIS_TIMEOUT
                           - (time.perf_counter() - job["t0"])))
        for f in job["files"].values():
            f.flush()
        with open(job["paths"]["out.txt"]) as f:
            stdout = f.read()
        with open(job["paths"]["err.txt"]) as f:
            stderr = f.read()
    finally:
        stop_model_axis(job)
    p = subprocess.CompletedProcess(p.args, p.returncode, stdout, stderr)
    secs = time.perf_counter() - job["t0"]
    lines = p.stdout.splitlines()
    for l in lines:
        if not l.startswith('{"model_axis_rank"'):
            log(f"  6x/6y| {l}")
    if p.returncode != 0:
        # each rank's traceback (torchrun prefixes its lines), then the
        # launcher's summary
        for r in range(MODEL_AXIS):
            mine = [l for l in p.stderr.splitlines()
                    if l.startswith(f"[rank{r}]:")]
            log("\n".join(mine[-40:]))
        log(p.stderr[-1500:])
        raise AssertionError(f"phases 6x/6y: torchrun exited {p.returncode}")
    outs = [json.loads(l)["model_axis_rank"] for l in lines
            if l.startswith('{"model_axis_rank"')]
    counts = {}
    for tag, (arch, layers, cohort, chunk, _) in runs.items():
        ranks = sorted((o for o in outs if o["tag"] == tag),
                       key=lambda o: o["rank"])
        assert [r["rank"] for r in ranks] == list(range(MODEL_AXIS)), \
            (tag, ranks)
        slots = -(-cohort // chunk) * chunk
        want = _launches(accumulate_pass=MODEL_AXIS_ROUNDS * slots,
                         update_pass=MODEL_AXIS_ROUNDS)
        rank_rows = axis_rows(arch, layers)[1]
        for r in ranks:
            name = f"model_axis:{tag}[rank{r['rank']}]"
            counts[name] = r["counts"]
            c = r["collectives"]
            walls = r["walls"]
            log(f"kernels: {name} {json.dumps(r['counts'])}")
            log(f"  {tag} rank {r['rank']} on {r['device']}: round wall s "
                f"{[round(x, 4) for x in walls]} (steady {walls[-1]:.4f}; "
                f"round 0 includes init and data)  max_memory_allocated "
                f"{r['peak_gib']:.2f} GiB; model-axis collectives: "
                f"all_reduce {c['all_reduce'][0]} calls "
                f"{c['all_reduce'][1] / 1e9:.3f} GB "
                f"{c['all_reduce'][2]:.3f} s, all_gather "
                f"{c['all_gather'][0]} calls {c['all_gather'][1] / 1e9:.3f}"
                f" GB {c['all_gather'][2]:.3f} s; of the flat buffers: "
                f"all_reduce {c['flat all_reduce'][0]} calls "
                f"{c['flat all_reduce'][2]:.3f} s, all_gather "
                f"{c['flat all_gather'][0]} calls "
                f"{c['flat all_gather'][2]:.3f} s; update_pass rows "
                f"{r['update_rows']}")
        for r in ranks:
            name = f"model_axis:{tag}[rank{r['rank']}]"
            assert r["counts"] == want, (name, r["counts"], want)
            assert r["update_rows"] == [rank_rows] * MODEL_AXIS_ROUNDS, \
                (name, r["update_rows"], rank_rows)
            assert r["device"] == "cuda:0", r["device"]
            assert all(r["bitwise"]) and len(r["bitwise"]) == \
                MODEL_AXIS_ROUNDS, (name, r["bitwise"])
            for rec in r["hist"]:
                assert all(math.isfinite(v) for v in rec.values()), rec
        r0 = ranks[0]
        routed = ("; MoE routing bitwise the world of one's: "
                  f"{r0['routes_equal']}" if "routes_equal" in r0 else "")
        log(f"  {tag} vs its world of one after each round: params rel "
            f"{[f'{e:.3e}' for e in r0['errs']]}, metrics rel "
            f"{[{k: f'{v:.2e}' for k, v in m.items()} for m in r0['metric_errs']]}"
            f"; ranks' params bitwise equal after each round: "
            f"{ranks[1]['bitwise']}{routed}")
        assert len(r0["errs"]) == MODEL_AXIS_ROUNDS
        assert all(e <= 1e-5 for e in r0["errs"]), (tag, r0["errs"])
        assert all(v <= 1e-4 for m in r0["metric_errs"]
                   for v in m.values()), (tag, r0["metric_errs"])
        assert r0.get("routes_equal", True), tag
    log(f"  6x/6y: torchrun wall {secs:.1f} s from start to join")
    return counts


# ---------------------------------------------------------------------------
# phase 6g: the legacy tree engine at full width
# ---------------------------------------------------------------------------
# smollm-360m at full width, UGA + FedMeta post, cohort 4, client batch 8,
# seq 128: phase 6's setup.  legacy_tree (the launcher's engine without
# --fused) aggregates and steps with tree maps.  Under the vmap cohort its
# weighted mean over the (cohort, *shape) stack launches no kernel at all;
# the scan cohort streams its clients through accumulate_pass into the flat
# buffers and views them as a tree, so one accumulate_pass per client a
# round and no update_pass.  Each legacy run is held to the fused_flat run
# of the same config in the same process at the JAX suite's
# legacy-vs-fused tolerances (tests/test_fused_update.py:180-188): params
# and optimizer slots 1e-5, metrics 1e-4.  scan/adam runs one round from a
# warm state (t = 5, random m, v > 0; ROADMAP Queue 3 item 1).  vmap/sgd
# runs through run_training as the launcher does (fused=False / True).
LEGACY_TOL, LEGACY_TOL_METRIC = 1e-5, 1e-4
LEGACY_VMAP_ROUNDS = 2


def _full_fed(**kw):
    """The FedConfig run_training builds for phase 6's runs."""
    from repro_torch.configs import FedConfig
    base = dict(algorithm="uga", meta=True, cohort=COHORT, local_steps=2,
                client_lr=0.01, server_lr=0.01, meta_lr=0.01,
                lr_decay=0.992)
    return FedConfig(**{**base, **kw})


def _full_train(dev, fed, rounds, *, k=1, warm=None, on_records=None):
    """A FederatedTrainer on full-width smollm-360m with run_training's
    data and batch sizes; ``warm(state)`` edits the state before the run.
    Returns (trainer, history, per-call walls, run wall, peak GiB above
    what was allocated when the run started: the trainer's state and
    anything the caller keeps)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core.trainer import FederatedTrainer
    from repro_torch.launch.train import build_synthetic_fed_data
    from repro_torch.models.model import build_model

    cfg = get_arch("smollm-360m")
    tr = FederatedTrainer(build_model(cfg, dtype=torch.float32,
                                      loss_chunk=256), fed,
                          rounds_per_call=k, seed=0, device=dev)
    if warm is not None:
        warm(tr.state)
    data = build_synthetic_fed_data(cfg, num_clients=32, examples=2048,
                                    seq=128, iid=False, seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    marks = [time.perf_counter()]

    def mark(recs, trainer):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        if on_records is not None:
            on_records(recs, trainer)

    hist = tr.run(data, rounds=rounds, cohort=COHORT, batch=8,
                  meta_batch=16, on_records=mark)
    walls = [b - a for a, b in zip(marks, marks[1:])]
    return (tr, hist, walls, marks[-1] - marks[0],
            (torch.cuda.max_memory_allocated() - base) / 2**30)


def _warm_adam(state, fused):
    """t = 5, m ~ 0.01 N(0, 1), v ~ 1e-3 U(0, 1) + 1e-4, drawn per leaf
    on the card from one seed (the same values for either engine)."""
    import torch
    from repro_torch.core import flat as F
    params = state["params"]
    gen = torch.Generator(device=params[next(iter(params))].device)
    gen.manual_seed(5)
    m = {k: 0.01 * torch.randn(p.shape, generator=gen, device=p.device)
         for k, p in params.items()}
    v = {k: 1e-3 * torch.rand(p.shape, generator=gen, device=p.device)
         + 1e-4 for k, p in params.items()}
    t = torch.tensor(5, dtype=torch.int32, device=state["opt"]["t"].device)
    if fused:
        spec = F.make_flat_spec(params)
        state["opt"] = {"m": tuple(F.flatten_tree(spec, m)),
                        "v": tuple(F.flatten_tree(spec, v)), "t": t}
    else:
        state["opt"] = {"m": m, "v": v, "t": t}


def _tree_opt(state, spec):
    """An optimizer state's m and v as trees (the fused one unflattened)."""
    from repro_torch.core import flat as F
    return {s: (F.unflatten_tree(spec, state["opt"][s])
                if isinstance(state["opt"][s], tuple) else state["opt"][s])
            for s in ("m", "v") if s in state["opt"]}


def _hold(tag, a_state, a_hist, b_state, b_hist, tol, tol_metric):
    """Params, optimizer slots and history of run a against run b."""
    from repro_torch.core import flat as F
    pe = max(rel_err(a_state["params"][k], b_state["params"][k])
             for k in b_state["params"])
    spec = F.make_flat_spec(b_state["params"])
    oa, ob = _tree_opt(a_state, spec), _tree_opt(b_state, spec)
    oe = max([rel_err(oa[s][k], ob[s][k]) for s in ob for k in ob[s]],
             default=0.0)
    he = max(abs(ra[k] - rb[k]) / max(abs(rb[k]), 1e-30)
             for ra, rb in zip(a_hist, b_hist) for k in rb if k != "round")
    log(f"  {tag}: params rel {pe:.3e}, optimizer slots {oe:.3e} (tol "
        f"{tol:g}), history {he:.3e} (tol {tol_metric:g})")
    assert len(a_hist) == len(b_hist)
    assert pe <= tol and oe <= tol and he <= tol_metric, (tag, pe, oe, he)


def time_server_step(params, dev):
    """The server step alone at full width, CUDA events: legacy_tree's
    engine.apply (the tree-map norm, sgd or adam over the dicts) against
    fused_flat's (the plain norm over the flat buffers, then the
    update-kernel sweep), on one random aggregate, clip off as in the
    runs."""
    import torch
    from repro_torch.core import flat as F
    from repro_torch.core.engines import resolve_engine
    from repro_torch.core.executors import FlatAggregate, TreeAggregate
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    G = {k: 1e-3 * torch.randn(p.shape, generator=gen, device=dev)
         for k, p in params.items()}
    spec = F.make_flat_spec(params)
    Gf = F.flatten_tree(spec, G)
    for opt in ("sgd", "adam"):
        leg = resolve_engine(_full_fed(server_opt=opt))
        fus = resolve_engine(_full_fed(server_opt=opt, fused_update=True))
        ls, fs = leg.init_state(params), fus.init_state(params)
        ms_l, ms_f = paired_ms(
            lambda: leg.apply(params, TreeAggregate(G), ls, lr=0.01),
            lambda: fus.apply(params, FlatAggregate(Gf, spec), fs, lr=0.01))
        log(f"  server step alone, {opt}: legacy_tree {ms_l:.4f} ms, "
            f"fused_flat {ms_f:.4f} ms ({ms_l / ms_f:.2f}x)")
    del G, Gf
    torch.cuda.empty_cache()


def legacy_path(counts_of, dev, ref):
    """Phase 6g: each run its own main path (counts zeroed just before,
    read just after); legacy against fused in the same process.  The
    legacy vmap/sgd run is held to phase 6's post vmap/sgd run (``ref``:
    the same run_training call with fused=True)."""
    import numpy as np
    import torch
    from repro_torch.launch.train import run_training

    counts = {}
    tag = "6g:legacy:vmap/sgd"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    marks = [time.perf_counter()]

    def on_records(recs, trainer):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    counts_of.reset()
    state, hist = run_training(
        "smollm-360m", rounds=LEGACY_VMAP_ROUNDS, cohort=COHORT,
        client_batch=8, seq=128, algorithm="uga", meta=True, fused=False,
        seed=0, log_every=1, device=dev, on_records=on_records)
    counts[tag] = counts_of.read()
    log(f"kernels: {tag} {json.dumps(counts[tag])}")
    assert counts[tag] == _launches(), (tag, counts[tag])
    secs = [b - a for a, b in zip(marks, marks[1:])]
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    log(f"  {tag}: round wall s {[round(s, 4) for s in secs]} (round 0 "
        f"includes init and data; steady {np.mean(secs[1:]):.4f} s; phase "
        f"6's fused run {[round(s, 4) for s in ref['walls']]}); peak "
        f"{peak:.2f} GiB above what the phase held before it")
    assert len(ref["hist"]) == LEGACY_VMAP_ROUNDS
    legacy = {"params": {k: v.cpu() for k, v in state["params"].items()},
              "opt": state["opt"]}
    del state
    torch.cuda.empty_cache()
    _hold("6g vmap/sgd, legacy vs phase 6's fused run after 2 rounds",
          legacy, hist, {"params": ref["params"], "opt": {}}, ref["hist"],
          LEGACY_TOL, LEGACY_TOL_METRIC)
    del legacy
    params = {k: v.to(dev) for k, v in ref["params"].items()}
    time_server_step(params, dev)
    del params
    torch.cuda.empty_cache()

    keep = {}
    for fused in (False, True):
        tag = f"6g:{'fused' if fused else 'legacy'}:scan/adam-warm"
        fed = _full_fed(server_opt="adam", cohort_strategy="scan",
                        fused_update=fused)
        counts_of.reset()
        tr, hist, walls, _, peak = _full_train(
            dev, fed, 1, warm=lambda st, f=fused: _warm_adam(st, f))
        counts[tag] = counts_of.read()
        want = (_scan_counts(1, False) if fused
                else _launches(accumulate_pass=COHORT))
        log(f"kernels: {tag} {json.dumps(counts[tag])}")
        assert counts[tag] == want, (tag, counts[tag], want)
        assert int(tr.state["opt"]["t"]) == 6
        for rec in hist:
            assert all(math.isfinite(v) for v in rec.values()), (tag, rec)
        log(f"  {tag}: round wall s {round(walls[0], 4)} (warm state set "
            f"before the run); peak {peak:.2f} GiB above the state")
        keep[fused] = (tr.state, hist)
        del tr
        torch.cuda.empty_cache()
    _hold("6g scan/adam (warm), legacy vs fused after 1 round",
          *keep[False], *keep[True], LEGACY_TOL, LEGACY_TOL_METRIC)
    keep.clear()
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# phase 6r: multi-round calls at full width
# ---------------------------------------------------------------------------
# smollm-360m at full width, UGA + FedMeta post, cohort 4, client batch 8,
# seq 128.  2 fused vmap/sgd rounds as one K = 2 call against 2 calls of
# K = 1, and 2 buffered_async ticks (defaults: K = cohort = 4, capacity 8,
# fault-free: one flush a tick) as one K = 2 call against 2 calls of
# K = 1, each pair in this process.  The same operations run in the same
# order, so state and records are held bitwise; the launches are K times
# a round's: per sync round one aggregate_pass and one update_pass, per
# tick one accumulate_pass per flushed delta and one update_pass.
RPC_SYNC_ROUNDS, RPC_ASYNC_TICKS = 2, 2


def rounds_per_call_path(counts_of, dev):
    """Phase 6r: each run its own main path; the two forms bitwise."""
    import torch

    counts = {}
    for name, rounds, fed, per_round in (
            ("vmap/sgd", RPC_SYNC_ROUNDS, _full_fed(fused_update=True),
             _vmap_counts(1, False)),
            ("async", RPC_ASYNC_TICKS,
             _full_fed(fused_update=True, engine="buffered_async"),
             _launches(accumulate_pass=COHORT, update_pass=1))):
        keep = {}
        for k in (1, rounds):
            tag = f"6r:{name} K={k}"
            counts_of.reset()
            tr, hist, w, total, peak = _full_train(dev, fed, rounds, k=k)
            counts[tag] = counts_of.read()
            want = {n: c * rounds for n, c in per_round.items()}
            log(f"kernels: {tag} {json.dumps(counts[tag])}")
            assert counts[tag] == want, (tag, counts[tag], want)
            for rec in hist:
                assert all(math.isfinite(v) for v in
                           (rec[x] for x in ("client_loss", "grad_norm",
                                             "meta_loss"))), (tag, rec)
            log(f"  {tag}: {len(w)} call(s), wall s "
                f"{[round(x, 4) for x in w]}, per round {total / rounds:.4f}"
                f" s (every round included); peak {peak:.2f} GiB above the "
                f"state and the kept K=1 run's")
            keep[k] = (dict(_leaves_of(tr.state)), hist)
            del tr
            torch.cuda.empty_cache()
        (la, ha), (lb, hb) = keep[1], keep[rounds]
        assert set(la) == set(lb)
        diff = [p for p in la if not _bitwise(la[p], lb[p])]
        log(f"  6r {name}: K={rounds} against K=1: {len(la)} state leaves, "
            f"{len(diff)} differ; records equal: {ha == hb} (bitwise "
            f"required)")
        assert not diff and ha == hb, (name, diff[:5])
        keep.clear()
        torch.cuda.empty_cache()
    return counts


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


def small_reference_chunked(dev):
    """Phase 7c: the chunked cohort at smoke size (smollm-360m-smoke,
    cohort 5, 2 post rounds): on the card chunk 1 bitwise the scan cohort,
    chunks 1, 3 and 5 within 1e-5 of one another (params; history 1e-4),
    chunk 5 within 1e-5 of the vmap cohort, the sharded executor on a
    world of one (NCCL) bitwise chunk 3; chunk 3 on the card against the
    CPU (params 1e-5, history 1e-4)."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_arch
    from repro_torch.launch.train import run_training
    from repro_torch.models.model import build_model

    params = build_model(get_arch("smollm-360m-smoke")).init(
        torch.Generator().manual_seed(3))
    runs = {"c1": dict(cohort_chunk=1), "c3": dict(cohort_chunk=3),
            "c5": dict(cohort_chunk=5), "scan": dict(strategy="scan"),
            "vmap": dict(), "sharded": dict(cohort_chunk=3,
                                            executor="sharded")}
    out = {}
    for tag, kw in [*runs.items(), ("cpu", dict(cohort_chunk=3))]:
        d = torch.device("cpu") if tag == "cpu" else dev
        out[tag] = run_training(
            "smollm-360m-smoke", rounds=2, cohort=5, client_batch=4, seq=32,
            num_clients=8, examples=64, fused=True, log_every=0, device=d,
            params=params, **kw)
        if kw.get("executor") == "sharded":
            dist.destroy_process_group()

    def compare(x, y):
        (sx, hx), (sy, hy) = out[x], out[y]
        pe = max(rel_err(sx["params"][k].cpu(), sy["params"][k].cpu())
                 for k in sy["params"])
        he = max(abs(rx[k] - ry[k]) / max(abs(ry[k]), 1e-30)
                 for rx, ry in zip(hx, hy) for k in ry)
        bitwise = pe == 0 and he == 0
        return pe, he, bitwise

    for x, y, bitwise in (("c1", "scan", True), ("sharded", "c3", True),
                          ("c1", "c3", False), ("c3", "c5", False),
                          ("c5", "vmap", False), ("c3", "cpu", False)):
        pe, he, same = compare(x, y)
        log(f"  smoke chunked {x} vs {y}: params rel {pe:.3e}, history rel "
            f"{he:.3e}, bitwise {same}"
            + (" (required)" if bitwise else " (tol 1e-5 / 1e-4)"))
        assert same if bitwise else (pe <= 1e-5 and he <= 1e-4), (x, y)


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


def small_reference_coded(dev):
    """Phase 7 with the compressed uplink: int8 with error feedback on a
    warm scan/adam (t = 5) and sign1bit with error feedback on vmap/sgd, at
    smoke size, the card against the CPU.  History <= 1e-4 and comm_bytes
    exactly; parameters and residuals under the flip-aware criterion."""
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
    for codec, strategy, opt in (("int8", "scan", "adam"),
                                 ("sign1bit", "vmap", "sgd")):
        fed = FedConfig(algorithm="uga", meta=True, cohort=2, local_steps=2,
                        client_lr=0.01, server_lr=0.01, meta_lr=0.01,
                        server_opt=opt, cohort_strategy=strategy,
                        lr_decay=0.992, fused_update=True, codec=codec,
                        error_feedback=True)
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
            assert rg["comm_bytes"] == rc["comm_bytes"], (rg, rc)
            for k in ("client_loss", "grad_norm", "meta_loss"):
                assert abs(rg[k] - rc[k]) <= 1e-4 * abs(rc[k]), (k, rg, rc)
        n_p = params_flip_aware({k: t.cpu() for k, t in
                                 sg["params"].items()}, sc["params"],
                                f"smoke {codec}")
        n_r = residual_flip_aware(sg["comm"]["residual"][0].cpu(),
                                  sc["comm"]["residual"][0], codec, 3,
                                  f"smoke {codec} residual")
        log(f"  smoke {codec}+ef {strategy}/{opt}, card vs CPU plain: "
            f"history <= 1e-4, comm_bytes exact; params: {n_p} elements "
            f"off by more than 1e-5, residuals: {n_r} (flip-aware)")


def small_reference_legacy_rpc(counts_of, dev):
    """Phase 7g / 7r at smoke size, the card against the CPU plain
    versions from the same parameters (params <= 1e-5, history <= 1e-4):
    legacy_tree on the vmap and scan cohorts (3 sgd rounds through
    run_training with fused=False; on the card the vmap run launches no
    kernel, the scan run one accumulate_pass per client a round); 3 fused
    rounds at K = 2 (a call of 2 and a tail of 1), on the card also
    bitwise against K = 1; the launcher with ``--plugin
    examples.plugins.fedagg_torch --algorithm fedagg``; and train_method
    at its JAX defaults (fused, K = 4) and with fused=False on the CIFAR
    CNN smoke (5 rounds: calls of 4 and 1, evaluations at rounds 3 and
    4)."""
    import tempfile

    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs import paper_models as pm
    from repro_torch.data.partition import partition_iid
    from repro_torch.data.pipeline import FederatedData
    from repro_torch.data.synthetic import synthetic_images
    from repro_torch.experiments.common import train_method
    from repro_torch.launch import train as T
    from repro_torch.models.model import build_model, build_paper_cnn

    params = build_model(get_arch("smollm-360m-smoke")).init(
        torch.Generator().manual_seed(3))
    smoke = dict(rounds=3, cohort=2, client_batch=4, seq=32, num_clients=8,
                 examples=64, log_every=0, params=params)

    def both(tag, **kw):
        """(the card's run, the CPU's run, the card's launches)."""
        out = []
        for d in (dev, torch.device("cpu")):
            counts_of.reset()
            out.append(T.run_training("smollm-360m-smoke", device=d,
                                      **smoke, **kw))
            out.append(counts_of.read())
        (sg, hg), _, (sc, hc), _ = out
        tp = {k: t.cpu() for k, t in sg["params"].items()}
        pe = max(rel_err(tp[k], sc["params"][k]) for k in sc["params"])
        he = max(abs(rg[k] - rc[k]) / max(abs(rc[k]), 1e-30)
                 for rg, rc in zip(hg, hc) for k in rc if k != "round")
        if kw.get("codec", "none") == "none":
            held = f"params rel {pe:.3e} (tol 1e-5)"
            assert pe <= 1e-5, (tag, pe)
        else:   # a codec's flips, as phase 7's coded runs hold them
            n = params_flip_aware(tp, sc["params"], f"smoke {tag}")
            held = (f"params: {n} elements off by more than 1e-5 "
                    f"(flip-aware; max rel {pe:.3e})")
        log(f"  smoke {tag}, card vs CPU plain: {held}, history {he:.3e} "
            f"(tol 1e-4)")
        assert len(hg) == len(hc) == smoke["rounds"]
        assert he <= 1e-4, (tag, he)
        return out[0], out[1]

    for strategy in ("vmap", "scan"):
        _, counts = both(f"legacy_tree {strategy}/sgd", fused=False,
                         strategy=strategy)
        want = (_launches() if strategy == "vmap" else
                _launches(accumulate_pass=smoke["rounds"] * smoke["cohort"]))
        assert counts == want, (strategy, counts, want)
    (s2, h2), _ = both("fused vmap/sgd K=2", fused=True, rounds_per_call=2)
    s1, h1 = T.run_training("smollm-360m-smoke", device=dev, fused=True,
                            **smoke)
    same = h1 == h2 and all(_bitwise(s1["params"][k], s2["params"][k])
                            for k in s1["params"])
    log(f"  smoke fused vmap/sgd on the card, K=2 against K=1: bitwise "
        f"{same} (required)")
    assert same

    with tempfile.TemporaryDirectory() as tmp:
        # the launcher on the card, its init from the card's generator
        path = os.path.join(tmp, "hist.json")
        T.main(["--plugin", "examples.plugins.fedagg_torch", "--algorithm",
                "fedagg", "--arch", "smollm-360m-smoke", "--rounds", "2",
                "--cohort", "2", "--client-batch", "4", "--seq", "32",
                "--no-meta", "--fused", "--codec", "int8",
                "--error-feedback", "--rounds-per-call", "2",
                "--log-every", "0", "--device", str(dev), "--history-out",
                path])
        with open(path) as f:
            hist = json.load(f)
    assert [r["round"] for r in hist] == [0, 1], hist
    assert all(math.isfinite(v) for r in hist for v in r.values()), hist
    # the plugin's algorithm, registered by the launcher's import, card
    # against CPU from the same parameters (the codec's flips held by the
    # history tolerance, as phase 7's coded runs hold them)
    both("fedagg (the --plugin example) int8 + ef vmap/sgd K=2",
         algorithm="fedagg", meta=False, fused=True, codec="int8",
         error_feedback=True, rounds_per_call=2)
    log("  smoke --plugin examples.plugins.fedagg_torch --algorithm fedagg "
        "(int8 + ef, K=2) through the launcher on the card: 2 finite "
        "records")

    rng = np.random.default_rng(1)
    img = synthetic_images(rng, n=200, image_size=32, channels=3,
                           num_classes=10, num_writers=10)
    meta = rng.choice(200, 16, replace=False)
    data = FederatedData(arrays={"x": img.x, "y": img.y},
                         client_indices=partition_iid(rng, 200, 10),
                         meta_indices=meta, shared_indices=meta)
    model = build_paper_cnn(pm.CIFAR_CNN_SMOKE)
    cnn_params = model.init(torch.Generator().manual_seed(3))
    for fused in (True, False):
        hg, hc = (
            train_method(
                model, data, "fedmeta_uga", rounds=5, cohort=3,
                local_steps=2, batch=8, lr=0.05, uga_server_lr=0.1,
                eval_idx=np.arange(0, 200, 2), eval_every=2, device=d,
                params=cnn_params, meta_batch=8, fused=fused)
            for d in (dev, torch.device("cpu")))
        assert [h["round"] for h in hg] == [h["round"] for h in hc] == [3, 4]
        for a, b in zip(hg, hc):
            assert abs(a["acc"] - b["acc"]) <= 1e-6, (a, b)
            for k in ("loss", "client_loss"):
                assert abs(a[k] - b[k]) <= 1e-4 * abs(b[k]), (a, b)
        log(f"  smoke CIFAR CNN train_method(fused={fused}, "
            f"rounds_per_call=4), card vs CPU: evaluations at rounds 3 and "
            f"4 within 1e-4 (accuracy within 1e-6)")


def small_reference_obs(counts_of, dev):
    """Phase 7o at smoke size on the card: (i) an async ``--sanitize``
    run through the launcher (the probes and anomaly mode) with every
    payload garbled by U(-inf, inf) raises ``SanitizeError`` naming the
    flat group, and nothing else is caught; (ii) the same config
    unsanitized completes with non-finite parameters; (iii) a clean
    sanitized K = 2 run is bitwise the unsanitized one on the card, and
    within 1e-5 (params) and 1e-4 (history) of the CPU's; (iv) a profiled
    round through the trainer on the card: the device categories of the
    trace, its summary naming the fused-update kernels."""
    import collections
    import tempfile

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core.sanitize import SanitizeError
    from repro_torch.launch import train as T
    from repro_torch.models.model import build_model
    from repro_torch.obs import find_trace_file
    from repro_torch.obs.trace_analysis import load_trace

    smoke = ["--arch", "smollm-360m-smoke", "--rounds", "2", "--cohort",
             "2", "--client-batch", "4", "--seq", "32", "--fused",
             "--log-every", "0", "--device", str(dev)]
    garble = ["--engine", "buffered_async", "--fault-garble", "1.0",
              "--fault-garble-scale", "inf"]
    try:
        T.main(smoke + garble + ["--sanitize"])
    except SanitizeError as e:
        msg = str(e)
    else:
        raise AssertionError("the garbled --sanitize run did not raise")
    assert "flat group 0" in msg and "round 0" in msg, msg
    log(f"  7o --sanitize, async, garble U(-inf, inf): SanitizeError: "
        f"{msg[:150]}...")
    state, _ = T.run_training(
        "smollm-360m-smoke", rounds=2, cohort=2, client_batch=4, seq=32,
        fused=True, log_every=0, device=dev, engine="buffered_async",
        fault_garble=1.0, fault_garble_scale=float("inf"))
    bad = sum(int((~torch.isfinite(v)).sum())
              for v in state["params"].values())
    log(f"  7o the same run unsanitized: completes, {bad} non-finite "
        f"parameters")
    assert bad > 0

    params = build_model(get_arch("smollm-360m-smoke")).init(
        torch.Generator().manual_seed(3))
    kw = dict(rounds=3, cohort=2, client_batch=4, seq=32, num_clients=8,
              examples=64, log_every=0, params=params, fused=True,
              rounds_per_call=2)
    runs = {}
    for d, san in ((dev, False), (dev, True), (torch.device("cpu"), True)):
        counts_of.reset()
        runs[d.type, san] = T.run_training("smollm-360m-smoke", device=d,
                                           sanitize=san, **kw)
    (sa, ha), (sb, hb) = runs["cuda", False], runs["cuda", True]
    same = ha == hb and all(_bitwise(sa["params"][k], sb["params"][k])
                            for k in sa["params"])
    sc, hc = runs["cpu", True]
    pe = max(rel_err(sb["params"][k].cpu(), sc["params"][k])
             for k in sc["params"])
    he = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-30)
             for a, b in zip(hb, hc) for k in b if k != "round")
    log(f"  7o clean sanitized K=2 on the card: bitwise the unsanitized run "
        f"{same} (required); against the CPU's: params rel {pe:.3e} (tol "
        f"1e-5), history {he:.3e} (tol 1e-4)")
    assert same and pe <= 1e-5 and he <= 1e-4, (same, pe, he)

    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")) as d:
        T.run_training("smollm-360m-smoke", device=dev, tracker="jsonl",
                       run_dir=d, profile=1, profile_start=1,
                       trace_summary=True, trace_top_k=TRACKED_TOP_K,
                       **{**kw, "rounds_per_call": 1})
        trace = load_trace(find_trace_file(d))
        cats = collections.Counter(
            e.get("cat") for e in trace["traceEvents"]
            if isinstance(e, dict) and e.get("ph") == "X")
        with open(os.path.join(d, "metrics.jsonl")) as f:
            (summ,) = [r for r in map(json.loads, f)
                       if r.get("event") == "profile_summary"]
    log(f"  7o profiled smoke round on the card: trace categories "
        f"{dict(sorted(cats.items(), key=str))}; busy_frac "
        f"{summ['busy_frac']:.4f}; device self time by phase (us) "
        f"{summ['phase_self_us']}")
    assert cats["kernel"] > 0 and summ["n_op_events"] <= sum(
        cats[c] for c in ("kernel", "gpu_memcpy", "gpu_memset"))
    ops = [o["op"] for o in summ["top_ops"]]
    for kern in TRACKED_KERNELS:
        assert any(kern in o for o in ops), (kern, ops[:20])


# Rounds and tolerance (history and params, max |a-b| over max |b|) of
# phase 7's SSM training check.  The client update of a stack with mamba
# layers is ill-conditioned in the embedding (tests/test_torch_ssm_train
# .py), and jamba's the more so: the port and JAX on the CPU 1.5e-4 apart
# after one client update at lr 0.05.  Card against CPU, routing equal:
# mamba2 within 1.5e-5 over 2 rounds; jamba's first round within 2.5e-4
# (ctrl_lr_grad; params 2.1e-5), its second 4.1e-4 (post params) and
# 2.4e-3 (through_aggregation's ctrl_w_gnorm, a hypergradient norm), so
# jamba runs one round.
SSM_SMALL = {"mamba2-780m-smoke": (2, 1e-4),
             "jamba-1.5-large-398b-smoke": (1, 1e-3)}


def small_reference_ssm(counts_of, dev):
    """Phase 7 for training through mamba layers: mamba2-780m-smoke and
    jamba-1.5-large-398b-smoke (routing asserted equal first) in each meta
    mode, vmap/sgd, seq 40 (a ragged last SSD chunk of the 32), the card
    against the CPU: rounds, history and parameters as ``SSM_SMALL``
    says, and no SSD-scan launch on the card."""
    import torch
    from repro_torch.configs import FedConfig, get_arch
    from repro_torch.core.trainer import FederatedTrainer
    from repro_torch.launch.train import build_synthetic_fed_data
    from repro_torch.models import moe
    from repro_torch.models.model import build_model

    for arch, (rounds, tol) in SSM_SMALL.items():
        cfg = get_arch(arch)
        model = build_model(cfg, loss_chunk=256)
        params = model.init(torch.Generator().manual_seed(3))
        for mode in ("post", "through_aggregation"):
            fed = FedConfig(algorithm="uga", meta=True, cohort=2,
                            local_steps=2, client_lr=0.01, server_lr=0.01,
                            meta_lr=0.01, lr_decay=0.992, fused_update=True,
                            meta_mode=mode)
            out, routes = {}, []
            orig = moe._route
            for d in (dev, torch.device("cpu")):
                recs = []

                def route(xg, p, c, recs=recs):
                    r = orig(xg, p, c)
                    recs.append((r[1].cpu(), r[3].cpu()))
                    return r

                moe._route = route
                counts_of.reset()
                try:
                    tr = FederatedTrainer(model, fed, device=d,
                                          params=params)
                    data = build_synthetic_fed_data(
                        cfg, num_clients=8, examples=64, seq=40, iid=False)
                    hist = tr.run(data, rounds=rounds, cohort=2, batch=4,
                                  meta_batch=8)
                finally:
                    moe._route = orig
                if d.type == "cuda":
                    c = counts_of.read()
                    assert c == _vmap_counts(rounds, mode != "post"), (
                        arch, c)
                out[d.type] = tr.state, hist
                routes.append(recs)
            for i, ((eg, kg), (ec, kc)) in enumerate(zip(*routes)):
                assert int((eg != ec).sum()) == 0 and torch.equal(kg, kc), (
                    arch, mode, i)
            assert len(routes[0]) == len(routes[1])
            (sg, hg), (sc, hc) = out["cuda"], out["cpu"]
            for rg, rc in zip(hg, hc):
                for k in rc:
                    assert abs(rg[k] - rc[k]) <= tol * abs(rc[k]), (
                        arch, mode, k, rg, rc)
            he = max(abs(rg[k] - rc[k]) / max(abs(rc[k]), 1e-30)
                     for rg, rc in zip(hg, hc) for k in rc)
            pe = max(rel_err(sg["params"][k].cpu(), sc["params"][k])
                     for k in sc["params"])
            assert pe <= tol, (arch, mode, pe)
            routed = (f"; routing equal in all {len(routes[0])} MoE calls"
                      if routes[0] else "")
            log(f"  smoke {arch} {mode} vmap/sgd, {rounds} rounds, card vs "
                f"CPU plain: history rel {he:.3e}, params rel {pe:.3e} (tol "
                f"{tol:g}); no SSD-scan launch{routed}")


def small_reference_faults(counts_of, dev):
    """Phase 7 for the fault model, int8 with error feedback on a warm
    scan/adam at smoke size: (i) a round whose clients all crashed
    launches no kernel and leaves params, opt and residuals bitwise as
    they were; (ii) a round with client 1 crashed keeps that client's
    residual slot byte-identical and moves the others, the card against
    the CPU: metrics within 1e-4, comm_bytes and the counts exactly."""
    import numpy as np
    import torch
    from repro_torch.configs import FedConfig, get_arch
    from repro_torch.core import flat as F
    from repro_torch.core.round import RoundDraws, draw_round
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
    res = 1e-3 * torch.randn((2, rows, 128), generator=gen)
    kw = dict(algorithm="uga", meta=True, cohort=2, local_steps=2,
              client_lr=0.01, server_lr=0.01, meta_lr=0.01, server_opt="adam",
              cohort_strategy="scan", lr_decay=0.992, fused_update=True,
              codec="int8", error_feedback=True)

    def trainer(fed, d):
        tr = FederatedTrainer(model, fed, device=d, params=params)
        tr.state["opt"] = {"m": (m.to(d, copy=True),),
                           "v": (v.to(d, copy=True),),
                           "t": torch.tensor(5, dtype=torch.int32,
                                             device=d)}
        tr.state["comm"] = {"residual": (res.to(d, copy=True),)}
        return tr

    def data():
        return build_synthetic_fed_data(cfg, num_clients=8, examples=64,
                                        seq=32, iid=False)

    def leaves(state):
        return [t for k in ("params", "opt", "comm") for t in
                (state[k].values() if k == "params" else
                 [x for vals in state[k].values()
                  for x in (vals if isinstance(vals, tuple) else (vals,))])]

    # (i) every client crashed
    tr = trainer(FedConfig(**kw, fault_crash=1.0), dev)
    before = [t.clone() for t in leaves(tr.state)]
    counts_of.reset()
    (rec,) = tr.run(data(), rounds=1, cohort=2, batch=4, meta_batch=8)
    torch.cuda.synchronize()
    c = counts_of.read()
    assert all(n == 0 for n in c.values()), c
    same = all(torch.equal(a.view(-1).view(torch.uint8) if a.dim() else
                           a.reshape(1).view(torch.uint8),
                           b.view(-1).view(torch.uint8) if b.dim() else
                           b.reshape(1).view(torch.uint8))
               for a, b in zip(leaves(tr.state), before))
    assert same and tr.state["round"] == 1, rec
    assert rec["client_loss"] == rec["grad_norm"] == rec["meta_loss"] == 0
    log(f"  smoke int8+ef scan/adam, every client crashed: no kernel "
        f"launched, params, opt and residuals bitwise unchanged; "
        f"{json.dumps(rec)}")

    # (ii) client 1 crashed, client 0 alive: the same draws on both devices
    fed = FedConfig(**kw, fault_crash=0.5)
    fs = draw_round(fed, 0, 0, 2).faults
    crashed = np.array([False, True])
    draws = RoundDraws(faults=fs._replace(
        crashed=crashed, dropped=np.zeros(2, bool),
        alive=(~crashed).astype(np.float32)))
    out = {}
    for d in (dev, torch.device("cpu")):
        tr = trainer(fed, d)
        tr.draw_round = lambda r, cohort: draws
        (rec,) = tr.run(data(), rounds=1, cohort=2, batch=4, meta_batch=8)
        after = tr.state["comm"]["residual"][0].cpu()
        assert after[1].numpy().tobytes() == res[1].numpy().tobytes(), d
        assert not torch.equal(after[0], res[0]), d
        out[d.type] = rec, tr.state
    (rg, sg), (rc, sc) = out["cuda"], out["cpu"]
    for k in rc:
        if k in ("comm_bytes", "arrivals", "fault_crashed", "fault_dropped"):
            assert rg[k] == rc[k], (k, rg, rc)
        else:
            assert abs(rg[k] - rc[k]) <= 1e-4 * abs(rc[k]), (k, rg, rc)
    n_p = params_flip_aware({k: t.cpu() for k, t in sg["params"].items()},
                            sc["params"], "smoke int8+ef, client 1 crashed")
    log(f"  smoke int8+ef scan/adam, client 1 crashed: its residual slot "
        f"byte-identical on the card and the CPU, slot 0 moved; card vs "
        f"CPU history <= 1e-4, counts and comm_bytes exact; params: {n_p} "
        f"elements off by more than 1e-5 (flip-aware)")


def small_reference_async(counts_of, dev):
    """Phase 7 for the buffered-async runtime at smoke size: (i) vmap/sgd
    and scan/sgd, K 1, capacity 4, participation 0.75, 'flaky' with
    garble, 4 ticks, the card against the CPU on the same draws: params
    within 1e-5, metrics within 1e-4, the counts and the pool's host
    vectors exactly; (ii) on the card, a save after 2 ticks restores
    bitwise, and the run resumed from it to 4 ticks equals one that never
    stopped: bitwise where two uninterrupted runs are, else within their
    gap."""
    import shutil

    import numpy as np
    import torch
    from repro_torch.configs import FedConfig, get_arch
    from repro_torch.core.trainer import FederatedTrainer
    from repro_torch.launch.train import build_synthetic_fed_data
    from repro_torch.models.model import build_model

    cfg = get_arch("smollm-360m-smoke")
    model = build_model(cfg, loss_chunk=256)
    params = model.init(torch.Generator().manual_seed(3))
    kw = dict(algorithm="uga", meta=True, cohort=2, local_steps=2,
              client_lr=0.05, server_lr=0.05, meta_lr=0.05, lr_decay=0.992,
              fused_update=True, engine="buffered_async", async_buffer=1,
              async_capacity=4, participation=0.75, fault_profile="flaky",
              fault_garble=0.3)

    def data():
        return build_synthetic_fed_data(cfg, num_clients=8, examples=64,
                                        seq=32, iid=False)

    def run(fed, d, rounds, tr=None):
        tr = tr or FederatedTrainer(model, fed, device=d, params=params)
        tr.run(data(), rounds=rounds, cohort=2, batch=4, meta_batch=8)
        return tr

    for strategy in ("vmap", "scan"):
        fed = FedConfig(**kw, cohort_strategy=strategy)
        counts_of.reset()
        g = run(fed, dev, 4)
        torch.cuda.synchronize()
        c = counts_of.read()
        c_ = run(fed, torch.device("cpu"), 4)
        steps = sum(int(h["server_steps"]) for h in g.history)
        assert c == _launches(accumulate_pass=steps, update_pass=steps), c
        for rg, rc in zip(g.history, c_.history):
            for k, v in rc.items():
                if isinstance(v, list) or k not in ("client_loss",
                                                    "grad_norm", "meta_loss"):
                    assert rg[k] == v, (k, rg, rc)
                else:
                    assert abs(rg[k] - v) <= 1e-4 * abs(v) + 1e-7, (k, rg,
                                                                    rc)
        worst = max(rel_err(g.state["params"][k].cpu(), c_.state["params"][k])
                    for k in c_.state["params"])
        assert worst <= 1e-5, worst
        ga, ca = g.state["async"], c_.state["async"]
        for k in ("weight", "version", "deliver"):
            assert np.array_equal(ga[k], ca[k]), k
        assert ga["server_version"] == ca["server_version"] == steps > 0
        stale = max(h["staleness_max"] for h in g.history)
        log(f"  smoke async {strategy}/sgd (K 1, capacity 4, flaky, "
            f"garble 0.3), 4 ticks: {steps} flushes, staleness up to "
            f"{stale:g}, card vs CPU params rel "
            f"{worst:.3e} (tol 1e-5), history <= 1e-4, counts and the "
            f"pool's host vectors exact; launches {json.dumps(c)}")

    # sign1bit with error feedback: each client that runs packs its delta
    # and decodes it (the unpack kernel over zeros) before the pool
    fed = FedConfig(**{**kw, "codec": "sign1bit", "error_feedback": True},
                    cohort_strategy="scan")
    counts_of.reset()
    g = run(fed, dev, 4)
    torch.cuda.synchronize()
    c = counts_of.read()
    ran = 0
    for r in range(4):
        d = g.draw_round(r, 2)
        if np.any((d.participation > 0) & (d.faults.alive > 0)):
            ran += 2
    steps = sum(int(h["server_steps"]) for h in g.history)
    assert c == _launches(sign_pack_pass=ran, sign_unpack_fma_pass=ran,
                          accumulate_pass=steps, update_pass=steps), c
    assert all(bool(torch.isfinite(p).all())
               for p in g.state["params"].values())
    log(f"  smoke async sign1bit+ef scan/sgd, 4 ticks on the card: {ran} "
        f"clients ran, {steps} flushes; launches {json.dumps(c)}")

    # (ii) save after 2 ticks, resume to 4, on the card
    fed = FedConfig(**kw, cohort_strategy="scan")
    out_dir = os.path.join(HERE, "build", "ckpt_smoke_async")
    shutil.rmtree(out_dir, ignore_errors=True)
    try:
        refs = [run(fed, dev, 4) for _ in range(2)]
        half = run(fed, dev, 2)
        a = half.state["async"]
        assert float(np.sum(a["weight"])) > 0, "no pending delta at the save"
        path = os.path.join(out_dir, "async.msgpack")
        half.save(path)
        resumed = FederatedTrainer(model, fed, device=dev, params=params)
        resumed.restore(path)
        for (p, x), (_, y) in zip(
                _leaves_of(half.checkpoint_tree()),
                _leaves_of(resumed.checkpoint_tree())):
            assert _bitwise(x, y), p
        run(fed, dev, 4, resumed)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)

    def flat(tr):
        return torch.cat([v.reshape(-1) for v in tr.state["params"].values()])

    r0, r1, rr = flat(refs[0]), flat(refs[1]), flat(resumed)
    repeat = torch.equal(r0, r1)
    gap = rel_err(r1, r0)
    e = min(rel_err(rr, r0), rel_err(rr, r1))
    assert resumed.history == refs[0].history or not repeat
    if repeat:
        assert torch.equal(rr, r0), e
    else:
        assert e <= max(2 * gap, 1e-6), (e, gap)
    log(f"  smoke async scan/sgd on the card: saved after 2 ticks with "
        f"{int(np.sum(a['weight'] > 0))} deltas pending, restored bitwise; "
        f"resumed to 4 ticks against a run that never stopped: "
        f"{'bitwise equal' if torch.equal(rr, r0) else f'rel {e:.3e}'} "
        f"(two uninterrupted runs "
        f"{'bitwise equal' if repeat else f'rel {gap:.3e} apart'})")


# Phase 7r: FederatedTrainer(roofline=True) under draws at smoke size
# (smollm-360m-smoke, cohort 4, client batch 4, seq 32, 1 round a run):
# participation 0.5, the 'flaky' fault profile with a deadline, and the
# buffered-async engine (K 1, capacity 4: each arrival is flushed) under
# participation 0.75 and 'flaky'.  Each run emits one roofline event
# with ROOFLINE_EVENT_KEYS, and the trace of its first call (before that
# call's dispatch, on the same staged inputs and draws) charges exactly
# the launches the call then makes.
ROOFLINE_DRAWS = {
    "participation 0.5": dict(participation=0.5),
    "flaky, deadline 3": dict(fault_profile="flaky", round_deadline=3.0),
    "buffered_async": dict(engine="buffered_async", cohort_strategy="scan",
                           async_buffer=1, async_capacity=4,
                           participation=0.75, fault_profile="flaky"),
}


def small_reference_roofline_draws(counts_of, dev):
    """Phase 7r (``ROOFLINE_DRAWS``)."""
    import shutil
    import tempfile

    import torch
    from repro_torch.configs import FedConfig, get_arch
    from repro_torch.core.trainer import FederatedTrainer
    from repro_torch.launch.train import build_synthetic_fed_data
    from repro_torch.models.model import build_model
    from repro_torch.obs import ROOFLINE_EVENT_KEYS

    cfg = get_arch("smollm-360m-smoke")
    model = build_model(cfg, loss_chunk=256)
    params = model.init(torch.Generator().manual_seed(3))
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    for name, extra in ROOFLINE_DRAWS.items():
        fed = FedConfig(algorithm="uga", meta=True, cohort=4, local_steps=2,
                        client_lr=0.01, server_lr=0.01, meta_lr=0.01,
                        fused_update=True, **extra)
        run_dir = tempfile.mkdtemp(prefix="roofline_draws_",
                                   dir=os.path.join(HERE, "build"))
        tr = FederatedTrainer(model, fed, device=dev, params=params,
                              tracker="jsonl", run_dir=run_dir,
                              roofline=True)
        first = {}

        def on_records(recs, trainer):
            if not first:
                torch.cuda.synchronize()
                first.update(counts_of.read())

        counts_of.reset()
        hist = tr.run(build_synthetic_fed_data(cfg, num_clients=8,
                                               examples=64, seq=32,
                                               iid=False),
                      rounds=1, cohort=4, batch=4, meta_batch=8,
                      on_records=on_records)
        tr.finish()
        with open(os.path.join(run_dir, "metrics.jsonl")) as f:
            events = [json.loads(ln) for ln in f]
        rl = [{k: v for k, v in e.items() if k not in ("kind", "event",
                                                        "t")}
              for e in events if e.get("event") == "roofline"]
        assert len(rl) == 1 and set(rl[0]) == set(ROOFLINE_EVENT_KEYS), rl
        traced = _launches(**tr.roofline_summaries[1]["launches"])
        assert traced == first, (name, traced, first)
        drawn = {k: [rec[k] for rec in hist] for k in
                 ("participants", "arrivals", "fault_crashed",
                  "server_steps") if k in hist[0]}
        log(f"  7r roofline=True under {name}: one roofline event "
            f"({rl[0]['flops_per_round']:.4e} FLOP a round, analysis_s "
            f"{rl[0]['analysis_s']:.2f}); round 0's trace charges "
            f"{tr.roofline_summaries[1]['launches']}, the launches its call "
            f"made (required); draws {drawn}")
        shutil.rmtree(run_dir)
        del tr
    torch.cuda.empty_cache()


def _leaves_of(tree):
    from repro_torch.checkpoint.ckpt import tree_leaves
    return tree_leaves(tree)


def _bitwise(x, y) -> bool:
    import numpy as np
    import torch
    if isinstance(x, torch.Tensor):
        return (x.dtype == y.dtype and x.shape == y.shape and torch.equal(
            x.reshape(-1).view(torch.uint8), y.reshape(-1).view(torch.uint8)))
    return np.asarray(x).tobytes() == np.asarray(y).tobytes()


# ---------------------------------------------------------------------------
# the serving path: flash attention and the SSD scan (phases 3b, 5d, 6s,
# 6t, 7s)
# ---------------------------------------------------------------------------
# Tolerances, max |a-b| over max |b|.  Flash attention: an online softmax
# against a global one, fp32: a few ulps.  SSD scan against the chunked
# plain version, in every decay regime: both take the cumsum of a
# sequentially in index order (``torch.cumsum`` on the card sums along S in
# order), so the decays agree and only the products' summation orders
# differ: a few ulps.  Against the sequential recurrence, which multiplies
# exp(a_t) step by step instead of taking exp of a cumsum difference: at
# the init's decay range (A from -1 to -16, dt = softplus of a unit
# normal) the cumsum reaches a few thousand within a chunk of 256, where
# one ulp is 2.4e-4, and each decay exp(acum_t - acum_s) moves by as much
# relatively; at slow decays (|a| about 0.01, |acum| < 15) the sums' own
# rounding is left.  Card against CPU at smoke size, and the full-width
# prefill against decode: the JAX suite's tolerances for those (1e-4;
# atol 2e-4 + rtol 1e-3).
FLASH_TOL = 1e-5
SSD_TOL = 1e-5
SSD_SEQ_TOL = {"init": 2e-3, "slow": 1e-5}
# one jamba-1.5-large-398b mamba layer (d_head 128, d_state 128, chunk
# 256, one group) over a 4096-token prefill: x alone is 268 MB
SSD_JAMBA_LAYER = dict(B=1, S=4096, H=128, G=1, N=128)
# sha256 (first 16 hex digits) of y and h_final of the P = 64 call at the
# prefill's shape (B 8, 48 heads, one group, S 1024, N 128, chunk 256) on
# inputs from a generator seeded 12, made by the kernel before its head
# dim was tiled (tools/ssd_check.py --parent; NVIDIA H100 80GB HBM3,
# 700.00 W), and the toolchain they were made under
SSD_P64_DIGESTS = {"init": "050512613d46ff50", "slow": "64fdd11da472d034"}
SSD_DIGEST_TOOLCHAIN = ("2.11.0+cu128", "cuda_12.9")
SSD_EDGE_SHAPES = [(1, 256, 1, 128), (63, 32, 2, 16), (200, 128, 1, 128),
                   (300, 64, 4, 16), (150, 32, 2, 16), (100, 32, 4, 12),
                   (130, 64, 1, 10), (257, 256, 4, 100)]
SERVE_TOL = 1e-4
SERVE_ARCHS = {"smollm-360m": ("flash_attention_fwd", 32),
               "mamba2-780m": ("ssd_scan_fwd", 48)}
SERVE_ARGS = ["--batch", "8", "--prompt-len", "1024", "--gen", "32",
              "--seed", "0"]
# mamba2-780m's serving peak above the memory held before the run: 4.36
# GiB before the SSD scan took its scratch (the chunk states, B H nchunks
# x P x N fp32, and C B^T's tiles: 58 MB a layer call); it may grow by at
# most 0.1 GiB
SERVE_PEAK_GIB = {"mamba2-780m": 4.36 + 0.1}
# The models the serving phase 6u runs at full width (flash in every
# prefill), each freed before the next is built; deepseek-v2-lite-16b's
# weights alone take 60.4 GiB.  The dropless check runs its decode after
# prefill(256) against prefill(257) at batch 2 with capacity_factor 11 >=
# E / K = 64 / 6, so that no token is dropped in either prefill.
# whisper-large-v3 serves 30 s of audio (1500 encoder frames,
# arXiv:2212.04356) and a prompt of 416: 416 + 32 generated = 448, its
# decoder's context; the others a prompt of 1024.
FLASH_SERVE = ("deepseek-v2-lite-16b", "minicpm-2b", "phi3-mini-3.8b",
               "phi3-medium-14b", "whisper-large-v3")
SERVE_PROMPT = {"whisper-large-v3": 416}
# The decoder-only models flash attention serves; their prefill shapes (B
# 8, S 1024, causal) come from the config registry through
# ``flash_prefill``.  ``flash_calls`` adds the encoder-decoder shapes.
FLASH_MODELS = ("smollm-360m", "deepseek-v2-lite-16b", "minicpm-2b",
                "phi3-mini-3.8b", "phi3-medium-14b")
DROPLESS_CF = 11.0
# Flash at Sq != Skv without a causal mask (queries against an encoder's
# keys), phase 3b: (Sq, Skv), and S 1500 square (whisper's encoder)
CROSS_PAIRS = ((1, 1500), (63, 1500), (416, 1500), (1024, 1601),
               (1500, 1500))


def flash_prefill(name) -> tuple:
    """The flash call of ``name``'s prefill: query and key/value heads, Dk,
    Dv, and its layers (one call each a prefill).  Under MLA every head
    has its own expanded key/value head and the keys carry the RoPE
    slice."""
    from repro_torch.configs import get_arch
    cfg = get_arch(name)
    hd = cfg.resolved_head_dim
    if cfg.mla is not None:
        return (cfg.num_heads, cfg.num_heads, hd + cfg.mla.rope_head_dim, hd,
                cfg.num_layers)
    return cfg.num_heads, cfg.num_kv_heads, hd, hd, cfg.num_layers


def flash_calls() -> dict:
    """Every flash call shape of a served prefill at batch 8, by name:
    ``dict(model, H, Hkv, Dk, Dv, Sq, Skv, causal, calls)``, ``calls`` its
    launches a prefill.  The decoder-only models at S 1024, causal, one a
    layer; whisper-large-v3's encoder self-attention (S 1500, non-causal,
    one an encoder layer), its decoder self-attention (S 416, causal) and
    its cross-attention (416 queries against 1500 encoder keys), one each
    a layer of their kind; llama-3.2-vision-90b's cross-attention (1024
    queries against its 1601 patch embeddings, GQA 64/8 of 128), one a
    cross layer (its full width does not fit the card: the shape alone)."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ATTN, CROSS
    out = {}
    for model in FLASH_MODELS:
        H, Hkv, Dk, Dv, layers = flash_prefill(model)
        out[model] = dict(model=model, H=H, Hkv=Hkv, Dk=Dk, Dv=Dv, Sq=1024,
                          Skv=1024, causal=True, calls=layers)
    for model, S in (("whisper-large-v3", SERVE_PROMPT["whisper-large-v3"]),
                     ("llama-3.2-vision-90b", 1024)):
        cfg = get_arch(model)
        e, kinds = cfg.encoder, cfg.layer_kinds()
        hd = cfg.resolved_head_dim
        heads = dict(model=model, H=cfg.num_heads, Hkv=cfg.num_kv_heads,
                     Dk=hd, Dv=hd)
        if e.enc_layers:
            ehd = e.enc_dim // e.enc_heads
            out[f"{model} encoder"] = dict(
                model=model, H=e.enc_heads, Hkv=e.enc_heads, Dk=ehd, Dv=ehd,
                Sq=e.enc_len, Skv=e.enc_len, causal=False,
                calls=e.enc_layers)
            out[f"{model} decoder self"] = dict(
                heads, Sq=S, Skv=S, causal=True, calls=kinds.count(ATTN))
        out[f"{model} cross"] = dict(heads, Sq=S, Skv=e.enc_len,
                                     causal=False, calls=kinds.count(CROSS))
    return out


def flash_shape(c) -> str:
    kind = "causal" if c["causal"] else "non-causal"
    seq = (f"S {c['Sq']}" if c["Sq"] == c["Skv"]
           else f"Sq {c['Sq']}, Skv {c['Skv']}")
    return (f"B 8, {c['H']}/{c['Hkv']} heads, {seq}, Dk {c['Dk']}, Dv "
            f"{c['Dv']}, {kind}")


def flash_inputs(gen, dev, c) -> tuple:
    """q, k, v of call shape ``c`` in the model's (B, S, H, D) layout."""
    import torch
    q = torch.randn((8, c["Sq"], c["H"], c["Dk"]), generator=gen, device=dev)
    k = torch.randn((8, c["Skv"], c["Hkv"], c["Dk"]), generator=gen,
                    device=dev)
    v = torch.randn((8, c["Skv"], c["Hkv"], c["Dv"]), generator=gen,
                    device=dev)
    return q, k, v


def ssd_inputs(gen, dev, B, S, H, G, N, regime, P=64):
    """x, dt, A, B, C of an SSD call at head dim ``P``.  "init": A =
    -linspace(1, 16) (the model's A_log init) and dt = softplus(unit
    normal) (its projection of a unit-RMS input); "slow": A = -exp(0.3
    normal), dt a hundredth of that, so the state carries across
    chunks."""
    import torch
    import torch.nn.functional as F
    x = torch.randn((B, S, H, P), generator=gen, device=dev)
    dt = F.softplus(torch.randn((B, S, H), generator=gen, device=dev))
    if regime == "init":
        A = -torch.linspace(1.0, 16.0, H, device=dev)
    else:
        A = -torch.exp(0.3 * torch.randn(H, generator=gen, device=dev))
        dt = dt * 0.01
    Bm, Cm = torch.randn((2, B, S, G, N), generator=gen, device=dev)
    return x, dt, A, Bm, Cm


def check_serve_kernels(FK, FR, SK, SR, dev):
    """Phase 3b: both prefill kernels against their plain versions."""
    import torch
    errs = dict.fromkeys(SERVE_NAMES, 0.0)
    errs["flash_attention_fwd"] = check_flash_forms(FK, FR, dev)
    gen = torch.Generator(device=dev).manual_seed(11)
    q = torch.randn((8 * 15, 1024, 64), generator=gen, device=dev)
    k, v = torch.randn((2, 8 * 5, 1024, 64), generator=gen, device=dev)
    out = FK.flash_attention_fwd(q[None], k[None], v[None], causal=True)[0]
    ref = FR.attention_ref(q, k, v, causal=True)
    e = rel_err(out, ref)
    assert e <= FLASH_TOL, e
    errs["flash_attention_fwd"] = max(errs["flash_attention_fwd"],
                                      max_abs_err(out, ref))
    log(f"  flash_attention_fwd at the prefill's shape (B 8, 15/5 heads, S "
        f"1024, D 64, causal): rel {e:.3e} (tol {FLASH_TOL:g})")
    # the main path's form: the model's (B, S, H, D) tensors as views
    from repro_torch.kernels.flash_attention import flash_attention
    unfold = lambda t: t.view(8, -1, 1024, 64).transpose(1, 2).contiguous()
    viewed = flash_attention(unfold(q), unfold(k), unfold(v), causal=True)
    assert viewed.is_contiguous() and torch.equal(
        viewed.transpose(1, 2).reshape(out.shape), out)
    log("  flash_attention_fwd on (B, S, H, D) views (the prefill's "
        "layout): bitwise the folded result, output in (B, S, H, D)")
    del q, k, v, out, ref, viewed

    for regime, seq_tol in SSD_SEQ_TOL.items():
        worst = {"y": 0.0, "h": 0.0, "seq": 0.0}
        for S in (128, 256, 1000, 1024, 1025):
            for chunk in (256, 64):
                x, dt, A, Bm, Cm = ssd_inputs(gen, dev, 2, S, 4, 2, 128,
                                              regime)
                y, h = SK.ssd_scan_fwd(x, dt, A, Bm, Cm, chunk=chunk)
                ry, rh = SR.ssd_chunked_ref(x, dt, A, Bm, Cm, chunk)
                ey, eh = rel_err(y, ry), rel_err(h, rh)
                assert ey <= SSD_TOL and eh <= SSD_TOL, (regime, S, chunk,
                                                         ey, eh)
                worst["y"], worst["h"] = max(worst["y"], ey), max(worst["h"],
                                                                  eh)
                errs["ssd_scan_fwd"] = max(errs["ssd_scan_fwd"],
                                           max_abs_err(y, ry),
                                           max_abs_err(h, rh))
                if S <= 256:
                    fold = lambda t: t.transpose(1, 2).reshape(
                        8, S, t.shape[-1])
                    a = dt * A
                    sy = SR.ssd_ref(fold(x), fold(dt[..., None]),
                                    fold(a[..., None]),
                                    fold(SR.expand_groups(Bm, 4)),
                                    fold(SR.expand_groups(Cm, 4)))
                    es = rel_err(fold(y), sy)
                    assert es <= seq_tol, (regime, S, chunk, es)
                    worst["seq"] = max(worst["seq"], es)
        log(f"  ssd_scan_fwd, {regime} decays, S 128/256/1000/1024/1025 x "
            f"chunk 256/64 (B 2, 4 heads, 2 groups, N 128): max rel y "
            f"{worst['y']:.3e}, h_final {worst['h']:.3e} (tol {SSD_TOL:g}); "
            f"against the sequential ssd_ref at S <= 256 {worst['seq']:.3e} "
            f"(tol {seq_tol:g})")
    # the shapes the kernel pads or loads apart: one chunk, two, five with
    # a ragged tail; N 16 (the smoke config's, with its chunk 32), N not a
    # multiple of 8 or of 4; G 1, 2 and 4 of 4 heads; then strided views
    # of one (B, S, C) buffer, as the mamba block hands them over
    for regime in SSD_SEQ_TOL:
        worst = 0.0
        for S, chunk, G, N in SSD_EDGE_SHAPES:
            x, dt, A, Bm, Cm = ssd_inputs(gen, dev, 2, S, 4, G, N, regime)
            y, h = SK.ssd_scan_fwd(x, dt, A, Bm, Cm, chunk=chunk)
            ry, rh = SR.ssd_chunked_ref(x, dt, A, Bm, Cm, chunk)
            e = max(rel_err(y, ry), rel_err(h, rh))
            assert e <= SSD_TOL, (regime, S, chunk, G, N, e)
            worst = max(worst, e)
            errs["ssd_scan_fwd"] = max(errs["ssd_scan_fwd"],
                                       max_abs_err(y, ry), max_abs_err(h, rh))
        buf = torch.randn((2, 100, 4 * 64 + 2 * 16), generator=gen,
                          device=dev)
        x = buf[..., :256].reshape(2, 100, 4, 64)
        Bm = buf[..., 256:272].reshape(2, 100, 1, 16)
        Cm = buf[..., 272:].reshape(2, 100, 1, 16)
        _, dt, A, _, _ = ssd_inputs(gen, dev, 2, 100, 4, 1, 16, regime)
        y, h = SK.ssd_scan_fwd(x, dt, A, Bm, Cm, chunk=32)
        ry, rh = SR.ssd_chunked_ref(x, dt, A, Bm, Cm, 32)
        e = max(rel_err(y, ry), rel_err(h, rh))
        assert e <= SSD_TOL, (regime, "strided", e)
        log(f"  ssd_scan_fwd, {regime} decays, {len(SSD_EDGE_SHAPES)} edge "
            f"shapes (S, chunk, G, N) {SSD_EDGE_SHAPES}: max rel "
            f"{worst:.3e}; strided views of one buffer (S 100, N 16, chunk "
            f"32): {e:.3e} (tol {SSD_TOL:g})")
    for regime in SSD_SEQ_TOL:
        x, dt, A, Bm, Cm = ssd_inputs(gen, dev, 8, 1024, 48, 1, 128, regime)
        y, h = SK.ssd_scan_fwd(x, dt, A, Bm, Cm, chunk=256)
        ry, rh = SR.ssd_chunked_ref(x, dt, A, Bm, Cm, 256)
        ey, eh = rel_err(y, ry), rel_err(h, rh)
        assert ey <= SSD_TOL and eh <= SSD_TOL, (regime, ey, eh)
        errs["ssd_scan_fwd"] = max(errs["ssd_scan_fwd"], max_abs_err(y, ry),
                                   max_abs_err(h, rh))
        log(f"  ssd_scan_fwd at the prefill's shape (B 8, 48 heads, S 1024, "
            f"N 128, 1 group, chunk 256, {regime} decays): rel y {ey:.3e}, "
            f"h_final {eh:.3e} (tol {SSD_TOL:g})")
        del x, dt, A, Bm, Cm, y, h, ry, rh
    errs["ssd_scan_fwd"] = max(errs["ssd_scan_fwd"], check_ssd_p128(SK, SR,
                                                                    dev))
    check_ssd_p64_bits(SK, dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return errs


def check_ssd_p128(SK, SR, dev) -> float:
    """Phase 3b at head dim 128: one jamba mamba layer
    (``SSD_JAMBA_LAYER``) in both decay regimes against the plain version,
    y and h_final at ``SSD_TOL``, and each 64-column half bitwise the P =
    64 call on its columns.  Returns the largest absolute error."""
    import torch
    j = SSD_JAMBA_LAYER
    gen = torch.Generator(device=dev).manual_seed(13)
    worst = 0.0
    for regime in SSD_SEQ_TOL:
        x, dt, A, Bm, Cm = ssd_inputs(gen, dev, j["B"], j["S"], j["H"],
                                      j["G"], j["N"], regime, P=128)
        y, h = SK.ssd_scan_fwd(x, dt, A, Bm, Cm, chunk=256)
        ry, rh = SR.ssd_chunked_ref(x, dt, A, Bm, Cm, 256)
        ey, eh = rel_err(y, ry), rel_err(h, rh)
        assert ey <= SSD_TOL and eh <= SSD_TOL, (regime, ey, eh)
        worst = max(worst, max_abs_err(y, ry), max_abs_err(h, rh))
        del ry, rh
        halves = True
        for p0 in (0, 64):
            hy, hh = SK.ssd_scan_fwd(x[..., p0:p0 + 64], dt, A, Bm, Cm,
                                     chunk=256)
            halves &= torch.equal(hy, y[..., p0:p0 + 64]) and torch.equal(
                hh, h[..., p0:p0 + 64])
        assert halves, regime
        log(f"  ssd_scan_fwd at P 128, one jamba mamba layer (B 1, 128 "
            f"heads, P 128, N 128, 1 group, S 4096, chunk 256, {regime} "
            f"decays): rel y {ey:.3e}, h_final {eh:.3e} (tol {SSD_TOL:g}); "
            f"each 64-column half bitwise the P 64 call on its columns")
        del x, dt, A, Bm, Cm, y, h
    torch.cuda.empty_cache()
    return worst


def check_ssd_p64_bits(SK, dev) -> None:
    """Phase 3b: P = 64 at the prefill's shape gives the bits of the
    kernel before its head dim was tiled (``SSD_P64_DIGESTS``), where this
    run's torch and CUDA are the ones the digests were made under (other
    versions draw other inputs or compile other code)."""
    import hashlib

    import torch
    from repro_torch.kernels._cuda import _nvcc
    nvcc = subprocess.run([_nvcc(), "--version"], capture_output=True,
                          text=True).stdout
    same = (torch.__version__ == SSD_DIGEST_TOOLCHAIN[0]
            and SSD_DIGEST_TOOLCHAIN[1] in nvcc)
    for regime, want in SSD_P64_DIGESTS.items():
        g = torch.Generator(device=dev).manual_seed(12)
        x, dt, A, Bm, Cm = ssd_inputs(g, dev, 8, 1024, 48, 1, 128, regime)
        y, h = SK.ssd_scan_fwd(x, dt, A, Bm, Cm, chunk=256)
        d = hashlib.sha256()
        for t in (y, h):
            d.update(t.contiguous().cpu().numpy().tobytes())
        got = d.hexdigest()[:16]
        log(f"  ssd_scan_fwd P 64 at the prefill's shape, {regime} decays, "
            f"seed 12: sha256 {got}, the kernel before the head-dim tiling "
            f"{want}: " + ("bitwise equal (required)" if same else
                           f"not comparable under torch {torch.__version__}"
                           f" and this nvcc (made under "
                           f"{SSD_DIGEST_TOOLCHAIN})"))
        if same:
            assert got == want, (regime, got, want)
        del x, dt, A, Bm, Cm, y, h


def check_flash_forms(FK, FR, dev) -> float:
    """Phase 3b, flash attention at each of its (Dk, Dv) forms at S 1 to
    1025, causal on and off, window 0 and 256, group 1 and 3 (B 2, 2
    key/value heads); non-causal at Sq != Skv (``CROSS_PAIRS``: queries
    against an encoder's keys, a ragged key tail) and S 1500 square, group
    1 and 8; then at every served prefill's call shape (``flash_calls``)
    on the model's (B, S, H, D) views, each against the plain version.
    Returns the largest max |a-b|."""
    import itertools

    import torch
    from repro_torch.kernels.flash_attention import flash_attention
    gen = torch.Generator(device=dev).manual_seed(13)
    worst = err = 0.0

    def check(Sq, Skv, causal, window, G, Dk, Dv):
        q = torch.randn((2 * 2 * G, Sq, Dk), generator=gen, device=dev)
        k = torch.randn((2 * 2, Skv, Dk), generator=gen, device=dev)
        v = torch.randn((2 * 2, Skv, Dv), generator=gen, device=dev)
        out = FK.flash_attention_fwd(q[None], k[None], v[None],
                                     causal=causal, window=window)[0]
        ref = FR.attention_ref(q, k, v, causal=causal, window=window)
        e = rel_err(out, ref)
        assert out.shape == ref.shape and e <= FLASH_TOL, (
            Sq, Skv, causal, window, G, Dk, Dv, e)
        return e, max_abs_err(out, ref)

    grid = list(itertools.product((1, 63, 128, 1000, 1024, 1025),
                                  (True, False), (0, 256), (1, 3), FK.FORMS))
    for S, causal, window, G, (Dk, Dv) in grid:
        e, a = check(S, S, causal, window, G, Dk, Dv)
        worst, err = max(worst, e), max(err, a)
    log(f"  flash_attention_fwd at {len(grid)} shapes (S 1, 63, 128, 1000, "
        f"1024, 1025; causal on/off; window 0/256; group 1/3; (Dk, Dv) "
        f"{FK.FORMS}; B 2, 2 kv heads): max rel {worst:.3e} (tol "
        f"{FLASH_TOL:g})")
    cross = list(itertools.product(CROSS_PAIRS, (1, 8), FK.FORMS))
    worst = 0.0
    for (Sq, Skv), G, (Dk, Dv) in cross:
        e, a = check(Sq, Skv, False, 0, G, Dk, Dv)
        worst, err = max(worst, e), max(err, a)
    log(f"  flash_attention_fwd non-causal at {len(cross)} shapes ((Sq, Skv) "
        f"{CROSS_PAIRS}; group 1/8; (Dk, Dv) {FK.FORMS}; B 2, 2 kv heads): "
        f"max rel {worst:.3e} (tol {FLASH_TOL:g})")
    for name, c in flash_calls().items():
        q, k, v = flash_inputs(gen, dev, c)
        out = flash_attention(q, k, v, causal=c["causal"])
        fold = lambda t: t.transpose(1, 2).reshape(-1, t.shape[1],
                                                   t.shape[-1])
        ref = FR.attention_ref(fold(q), fold(k), fold(v), causal=c["causal"])
        e = rel_err(fold(out), ref)
        assert out.shape == (8, c["Sq"], c["H"], c["Dv"]) and \
            e <= FLASH_TOL, (name, e)
        err = max(err, max_abs_err(fold(out), ref))
        log(f"  flash_attention_fwd at {name}'s prefill ({flash_shape(c)}; "
            f"(B, S, H, D) views): rel {e:.3e} (tol {FLASH_TOL:g})")
        del q, k, v, out, ref
        torch.cuda.empty_cache()
    return err


def time_flash_prefills(FK, FR, dev) -> dict:
    """Phase 5d, flash attention at every served prefill's call shape
    (``flash_calls``), as the prefill calls it (``ops.flash_attention`` on
    the model's (B, S, H, D) tensors), in turns with
    scaled_dot_product_attention on the same views (k, v repeated to H
    heads where H > Hkv; ``is_causal`` as the call), beside the plain
    version and both bounds (3xTF32 on the tensor cores; fp32's)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention
    gen = torch.Generator(device=dev).manual_seed(14)
    out = {}
    for name, c in flash_calls().items():
        H, Hkv, causal = c["H"], c["Hkv"], c["causal"]
        q, k, v = flash_inputs(gen, dev, c)
        kr, vr = (t.repeat_interleave(H // Hkv, dim=2).transpose(1, 2)
                  for t in (k, v))
        fold = lambda t: t.transpose(1, 2).reshape(-1, t.shape[1],
                                                   t.shape[-1])
        qf, kf, vf = fold(q), fold(k), fold(v)
        shape = dict(B=8, H=H, Hkv=Hkv, S=c["Sq"], Skv=c["Skv"], D=c["Dk"],
                     Dv=c["Dv"], causal=causal)
        rw, ops = attention_bound(**shape)
        b_fp32, _ = bound_ms(rw, ops)
        b, by = bound_ms(*attention_bound_tc(**shape))
        ms, lib = paired_ms(
            lambda: flash_attention(q, k, v, causal=causal),
            lambda: F.scaled_dot_product_attention(
                q.transpose(1, 2), kr, vr, is_causal=causal), iters=20)
        plain = cuda_ms(lambda: FR.attention_ref(qf, kf, vf, causal=causal),
                        iters=5)
        out[name] = dict(c, heads=f"{H}/{Hkv}", ms=ms, plain_ms=plain,
                         library_ms=lib, bound_ms=b, bound_by=by,
                         fp32_bound_ms=b_fp32, bytes=rw, flops=ops)
        log(f"  flash_attention_fwd at {name}'s prefill ({flash_shape(c)}): "
            f"{ms:.4f} ms, 3xTF32 bound {b:.4f} ms ({by}; "
            f"{100 * b / ms:.1f}% of it), fp32 bound {b_fp32:.4f} ms; plain "
            f"{plain:.4f} ms; scaled_dot_product_attention {lib:.4f} ms in "
            f"turns ({lib / ms:.2f}x the kernel's time); {c['calls']} calls "
            f"a prefill = {c['calls'] * ms:.3f} ms")
        del q, k, v, kr, vr, qf, kf, vf
        torch.cuda.empty_cache()
    return out


def time_serve_kernels(FK, FR, SK, SR, dev):
    """Phase 5d: both prefill kernels at the prefill's shapes, warm, beside
    their operation bounds, plain versions and library calls.  Flash
    attention is timed as the prefill calls it: ``ops.flash_attention`` on
    the model's contiguous (B, S, H, D) q, k and v (the kernel reads them
    as strided (B, H, S, D) views and writes o in (B, S, H, D)), in turns
    with scaled_dot_product_attention on the same views; the folded,
    contiguous (1, BH, S, D) form is timed beside it for comparison."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention
    gen = torch.Generator(device=dev).manual_seed(12)
    res = {}
    B, H, Hkv, S, D = 8, 15, 5, 1024, 64
    q = torch.randn((B, S, H, D), generator=gen, device=dev)
    k, v = torch.randn((2, B, S, Hkv, D), generator=gen, device=dev)
    # SDPA computes grouped attention only with k, v repeated to H heads
    kr, vr = (t.repeat_interleave(H // Hkv, dim=2).transpose(1, 2)
              for t in (k, v))
    fold = lambda t: t.transpose(1, 2).reshape(-1, S, D)
    qf, kf, vf = fold(q), fold(k), fold(v)
    rw, ops = attention_bound(S=S)
    b_fp32, _ = bound_ms(rw, ops)
    b, by = bound_ms(*attention_bound_tc(S=S))
    ms, lib = paired_ms(
        lambda: flash_attention(q, k, v, causal=True),
        lambda: F.scaled_dot_product_attention(q.transpose(1, 2), kr, vr,
                                               is_causal=True), iters=20)
    folded_ms = cuda_ms(lambda: FK.flash_attention_fwd(
        qf[None], kf[None], vf[None], causal=True), iters=20, warmup=3)
    res["flash_attention_fwd"] = dict(
        ms=ms, plain_ms=cuda_ms(lambda: FR.attention_ref(qf, kf, vf,
                                                         causal=True)),
        library_ms=lib,
        library="scaled_dot_product_attention on the same (B, H, S, D) "
        "views, k, v repeated to 15 heads",
        bound_ms=b, bound_by=by, bytes=rw, flops=ops)
    del q, k, v, kr, vr, qf, kf, vf
    x, dt, A, Bm, Cm = ssd_inputs(gen, dev, 8, 1024, 48, 1, 128, "init")
    rw, ops = ssd_bound(S=1024, G=1)
    ssd_b_fp32, _ = bound_ms(rw, ops)
    b, by = bound_ms(*ssd_bound_tc(S=1024, G=1))
    ssd_b_head = bound_ms(*ssd_bound(S=1024))[0], bound_ms(
        *ssd_bound_tc(S=1024))[0]
    ssd = lambda: SK.ssd_scan_fwd(x, dt, A, Bm, Cm, chunk=256)
    res["ssd_scan_fwd"] = dict(
        ms=cuda_ms(ssd, iters=20, warmup=3),
        plain_ms=cuda_ms(lambda: SR.ssd_chunked_ref(x, dt, A, Bm, Cm, 256),
                         iters=5),
        library_ms=None, library="none: no single call",
        bound_ms=b, bound_by=by, bytes=rw, flops=ops)
    ssd_kernels = device_kernels(ssd)
    del x, dt, A, Bm, Cm
    j = SSD_JAMBA_LAYER
    x, dt, A, Bm, Cm = ssd_inputs(gen, dev, j["B"], j["S"], j["H"], j["G"],
                                  j["N"], "init", P=128)
    rw, _, _ = ssd_bound_tc(B=j["B"], H=j["H"], S=j["S"], P=128, N=j["N"],
                            G=j["G"])
    b128, by128 = bound_ms(*ssd_bound_tc(B=j["B"], H=j["H"], S=j["S"],
                                         P=128, N=j["N"], G=j["G"]))
    res["ssd_scan_fwd"]["p128"] = dict(
        shape="one jamba mamba layer: B 1, 128 heads, P 128, N 128, 1 "
        "group, S 4096, chunk 256",
        ms=cuda_ms(lambda: SK.ssd_scan_fwd(x, dt, A, Bm, Cm, chunk=256),
                   iters=20, warmup=3),
        plain_ms=cuda_ms(lambda: SR.ssd_chunked_ref(x, dt, A, Bm, Cm, 256),
                         iters=3),
        bound_ms=b128, bound_by=by128, bytes=rw)
    del x, dt, A, Bm, Cm
    torch.cuda.empty_cache()
    for name, r in res.items():
        lib = ("" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms ")
        log(f"  {name}: {r['ms']:.4f} ms  bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}, {r['flops'] / 1e9:.3f} GFLOP, "
            f"{r['bytes'] / 1e6:.1f} MB; {100 * r['bound_ms'] / r['ms']:.1f}% "
            f"of bound, {r['flops'] / r['ms'] / 1e9:.2f} TFLOP/s)  plain "
            f"{r['plain_ms']:.4f} ms  library {lib}[{r['library']}]")
    r = res["flash_attention_fwd"]
    log(f"  flash_attention_fwd above: ops.flash_attention on the prefill's "
        f"(B, S, H, D) tensors, in turns with the library call; the folded, "
        f"contiguous (1, BH, S, D) form beside it: {folded_ms:.4f} ms")
    log(f"  flash_attention_fwd bounds: 3xTF32 on the tensor cores (three "
        f"TF32 products at 495 TFLOP/s plus the softmax at fp32's 67) "
        f"{r['bound_ms']:.4f} ms, the one its share above and the kernels "
        f"line use; fp32 outside the tensor cores (67 TFLOP/s) "
        f"{b_fp32:.4f} ms, {100 * b_fp32 / r['ms']:.1f}% of it")
    r = res["ssd_scan_fwd"]
    log(f"  ssd_scan_fwd bounds, C B^T once per group (the heads of a group "
        f"share B and C): 3xTF32 on the tensor cores (three TF32 products "
        f"at 495 TFLOP/s plus the decays and masks at fp32's 67) "
        f"{r['bound_ms']:.4f} ms, {100 * r['bound_ms'] / r['ms']:.1f}% of "
        f"the kernel's time, the one its share above and the kernels line "
        f"use; fp32 outside the tensor cores (67 TFLOP/s) {ssd_b_fp32:.4f} "
        f"ms, {100 * ssd_b_fp32 / r['ms']:.1f}% of it.  Counted per head, "
        f"as PRs 14-15 did: 3xTF32 {ssd_b_head[1]:.4f} ms "
        f"({100 * ssd_b_head[1] / r['ms']:.1f}%), fp32 {ssd_b_head[0]:.4f} "
        f"ms ({100 * ssd_b_head[0] / r['ms']:.1f}%)")
    p = r["p128"]
    log(f"  ssd_scan_fwd at P 128 ({p['shape']}): {p['ms']:.4f} ms, its "
        f"3xTF32 bound {p['bound_ms']:.4f} ms ({p['bound_by']}, "
        f"{100 * p['bound_ms'] / p['ms']:.1f}% of it); plain "
        f"{p['plain_ms']:.4f} ms")
    total = sum(ms for _, ms in ssd_kernels)
    log(f"  ssd_scan_fwd: one call launches {len(ssd_kernels)} device "
        f"kernels (torch.profiler): " + "; ".join(
            f"{name} {ms:.4f} ms" for name, ms in ssd_kernels)
        + f" (sum {total:.4f} ms, profiled)")
    assert len(ssd_kernels) == SK.kernels_per_call(), ssd_kernels
    return res


def device_kernels(fn, reps: int = 5, attempts: int = 3) -> list:
    """(name, mean ms) of each device kernel one ``fn()`` call launches,
    in launch order, from ``reps`` calls under torch.profiler.

    CUPTI can drop a kernel record (one of 20 once on an H100), and then
    the records do not split into ``reps`` equal calls: such a profile is
    thrown away and taken again, up to ``attempts`` times in all."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernels = sorted((e for e in prof.events()
                          if e.device_type == torch.autograd.DeviceType.CUDA),
                         key=lambda e: e.time_range.start)
        per_call = len(kernels) // reps
        if per_call and per_call * reps == len(kernels):
            break
        log(f"  device_kernels: profile {attempt} of {attempts} recorded "
            f"{len(kernels)} device kernels for {reps} calls, not a "
            f"multiple; profiled again")
    assert per_call and per_call * reps == len(kernels), len(kernels)
    out = []
    for i in range(per_call):
        evs = kernels[i::per_call]
        name = evs[0].name.replace("(anonymous namespace)::", "")
        name = name.replace("void ", "").split("(")[0]
        out.append((name, sum(e.time_range.elapsed_us() for e in evs)
                    / reps / 1e3))
    return out


def serve_path(counts_of, dev):
    """Phase 6s: ``repro_torch.launch.serve.main`` at full width, each run
    its own main path (counts zeroed just before, read just after)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve

    counts = {}
    for arch, (kernel, layers) in SERVE_ARCHS.items():
        tag = f"serve:{arch}"
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        counts_of.reset()
        toks, stats = serve.main(["--arch", arch] + SERVE_ARGS)
        counts[tag] = counts_of.read()
        log(f"kernels: {tag} {json.dumps(counts[tag])}")
        want = _launches(**{kernel: layers})
        assert counts[tag] == want, (tag, counts[tag], want)
        vocab = get_arch(arch).vocab_size
        assert toks.shape == (8, 32) and toks.is_cuda, toks.shape
        assert 0 <= int(toks.min()) and int(toks.max()) < vocab
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        log(f"  {tag}: prefill (B 8, S 1024) {stats['prefill_s']:.4f} s "
            f"wall (synchronized; the process's first prefill); decode 31 "
            f"steps {stats['decode_s']:.4f} s, {stats['tok_per_s']:.1f} "
            f"tok/s; max_memory_allocated {peak:.2f} GiB above the "
            f"{base / 2**30:.2f} GiB held before the run; {layers} {kernel} "
            f"launches, none of the other kernels")
        if arch in SERVE_PEAK_GIB:
            assert peak <= SERVE_PEAK_GIB[arch], (arch, peak)
        del toks
    return counts


def prefill_flops(cfg, B=8, S=1024) -> float:
    """Operations of one prefill at batch B and prompt S: 2 per
    multiply-add of each layer's weight matrices for every token, the
    attention or SSD scan as their bounds count them, and the last
    position's vocab projection (elementwise work and the convolution
    left out).  An encoder's layers count at its ``enc_len`` positions,
    with non-causal attention; a cross layer projects queries and output
    at the prompt's S tokens and keys and values at the encoder's
    positions, and attends non-causally."""
    from repro_torch.configs.base import CROSS, MAMBA
    d = cfg.d_model
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    total = 2 * B * d * cfg.vocab_size
    for i, kind in enumerate(cfg.layer_kinds()):
        if kind == MAMBA:
            s = cfg.ssm
            d_in = s.expand * d
            Hs = d_in // s.d_head
            weights = d * (2 * d_in + 2 * s.n_groups * s.d_state + Hs) \
                + d_in * d
            # per head, as PRs 14-15 counted: the rate compares across PRs
            mix = ssd_bound(B=B, H=Hs, S=S, P=s.d_head, N=s.d_state,
                            chunk=s.chunk)[1]
        elif kind == CROSS:
            L = cfg.encoder.enc_len
            weights = 2 * d * H * hd
            mix = (2 * B * L * 2 * d * Hkv * hd
                   + attention_bound(B=B, H=H, Hkv=Hkv, S=S, Skv=L, D=hd,
                                     causal=False)[1])
        elif cfg.mla is not None:        # MLA: latent kv, expanded per head
            r, rd = cfg.mla.kv_lora_rank, cfg.mla.rope_head_dim
            weights = (d * (r + rd) + 2 * r * H * hd + d * H * (hd + rd)
                       + H * hd * d)
            mix = attention_bound(B=B, H=H, Hkv=H, S=S, D=hd + rd, Dv=hd)[1]
        else:
            weights = 2 * d * H * hd + 2 * d * Hkv * hd
            mix = attention_bound(B=B, H=H, Hkv=Hkv, S=S, D=hd)[1]
        m = cfg.moe
        if m is not None and i % m.every == m.every - 1:
            de = m.d_expert or cfg.d_ff  # the routed top-k and the shared
            weights += (3 * d * de * (m.top_k + m.num_shared)   # experts a
                        + d * m.num_experts)     # token needs, the router
        elif cfg.d_ff > 0:
            weights += 3 * d * cfg.d_ff
        total += 2 * B * S * weights + mix
    e = cfg.encoder
    if e is not None:
        L, de = e.enc_len, e.enc_dim
        eff, ehd = e.enc_ff or 4 * de, de // e.enc_heads
        total += e.enc_layers * (
            2 * B * L * (4 * de * de + 2 * de * eff)
            + attention_bound(B=B, H=e.enc_heads, Hkv=e.enc_heads, S=L,
                              D=ehd, causal=False)[1])
        if de != d:
            total += 2 * B * L * de * d
    return total


def serve_consistency(counts_of, dev, times):
    """Phase 6t at full width: the decode of token 1024 after
    prefill(1024) against the last logits of prefill(1025), whose ragged
    tails the kernels mask (flash: 1025 = 16 tiles + 1; SSD: a fifth
    chunk of one position).  Counts: one launch per layer in a prefill,
    none in a decode step."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models.model import build_model

    for arch, (kernel, layers) in SERVE_ARCHS.items():
        cfg = get_arch(arch)
        model = build_model(cfg)
        params = model.init(torch.Generator(device=dev).manual_seed(0))
        toks = torch.from_numpy(np.random.default_rng(1).integers(
            0, cfg.vocab_size, (8, 1025))).to(dev)
        counts_of.reset()
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, cache = model.prefill(params, {"tokens": toks[:, :1024]},
                                 cache_len=1025)
        torch.cuda.synchronize()
        warm = time.perf_counter() - t
        pre = counts_of.read()
        counts_of.reset()
        dec, _ = model.decode(params, toks[:, 1024], cache)
        torch.cuda.synchronize()
        step = counts_of.read()
        del cache
        full, _ = model.prefill(params, {"tokens": toks})
        assert pre == _launches(**{kernel: layers}), (arch, pre)
        assert step == _launches(), (arch, step)
        diff = (dec - full).abs()
        bad = int((diff > 2e-4 + 1e-3 * full.abs()).sum())
        e = rel_err(dec, full)
        ops = prefill_flops(cfg)
        share = layers * times[kernel]["ms"] / (warm * 1e3)
        log(f"  {arch}: decode(token 1024 | prefill 1024) vs prefill(1025) "
            f"last logits: max |a-b| {float(diff.max()):.3e}, rel {e:.3e}, "
            f"{bad} elements beyond atol 2e-4 + rtol 1e-3; launches: "
            f"prefill {layers} {kernel}, decode step none")
        log(f"  {arch}: warm prefill (B 8, S 1024) {warm:.4f} s, "
            f"{ops / 1e12:.3f} TFLOP, {ops / warm / 1e12:.2f} TFLOP/s; "
            f"{layers} x {kernel} ({times[kernel]['ms']:.4f} ms, phase 5d) "
            f"= {100 * share:.1f}% of it")
        assert bad == 0, (arch, bad)
        del params, dec, full
        torch.cuda.empty_cache()


def serve_flash_models(counts_of, dev, forms) -> dict:
    """Phase 6u: ``serve.main`` at full width (batch 8, prompt 1024 or
    ``SERVE_PROMPT``'s, 32 tokens, greedy, seed 0) on each of FLASH_SERVE,
    its own main path (counts zeroed just before, read just after: one
    flash launch a layer in the prefill, an encoder's layers included,
    none in decode); then the warm prefill on a second init from the same
    seed, its last logits finite; for deepseek-v2-lite-16b the dropless
    check.  Each model is freed before the next is built."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve
    from repro_torch.models.model import build_model

    counts = {}
    for arch in FLASH_SERVE:
        cfg = get_arch(arch)
        S, tag = SERVE_PROMPT.get(arch, 1024), f"serve:{arch}"
        calls = {n: f for n, f in forms.items() if f["model"] == arch}
        launches = sum(f["calls"] for f in calls.values())
        assert launches == cfg.num_layers + (
            cfg.encoder.enc_layers if cfg.encoder else 0), (arch, launches)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        counts_of.reset()
        toks, stats = serve.main(["--arch", arch, "--batch", "8",
                                  "--prompt-len", str(S), "--gen", "32",
                                  "--seed", "0"])
        counts[tag] = counts_of.read()
        log(f"kernels: {tag} {json.dumps(counts[tag])}")
        assert counts[tag] == _launches(flash_attention_fwd=launches), (
            tag, counts[tag])
        assert toks.shape == (8, 32) and toks.is_cuda, toks.shape
        assert 0 <= int(toks.min()) and int(toks.max()) < cfg.vocab_size
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        del toks
        torch.cuda.empty_cache()
        model = build_model(cfg)
        params = model.init(torch.Generator(device=dev).manual_seed(0))
        n_params = sum(t.numel() for t in params.values())
        held = sum(t.numel() * t.element_size() for t in params.values())
        rng = np.random.default_rng(0)
        batch = {"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (8, S))).to(dev)}
        if cfg.encoder is not None:
            e = cfg.encoder
            batch["enc_embeds"] = torch.from_numpy(rng.normal(
                0, 1, (8, e.enc_len, e.enc_dim)).astype(np.float32)).to(dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, cache = model.prefill(params, batch, cache_len=S + 32 + 1)
        torch.cuda.synchronize()
        warm = time.perf_counter() - t
        finite = bool(torch.isfinite(logits).all())
        del logits, cache, batch
        ops = prefill_flops(cfg, S=S)
        flash_ms = sum(f["calls"] * f["ms"] for f in calls.values())
        log(f"  {tag}: {n_params:,} parameters ({held / 2**30:.2f} GiB "
            f"fp32); prefill (B 8, S {S}) first {stats['prefill_s']:.4f} s "
            f"(the process's first at this model), warm {warm:.4f} s, "
            f"{ops / 1e12:.3f} TFLOP, {ops / warm / 1e12:.2f} TFLOP/s; flash "
            + " + ".join(f"{f['calls']} x {f['ms']:.4f} ms ({n})"
                         for n, f in calls.items())
            + f" (phase 5d) = {100 * flash_ms / (warm * 1e3):.1f}% of it; "
            f"decode 31 steps {stats['decode_s']:.4f} s, "
            f"{stats['tok_per_s']:.1f} tok/s; max_memory_allocated "
            f"{peak:.2f} GiB above the {base / 2**30:.2f} GiB held before "
            f"the run; {launches} flash_attention_fwd launches, none of the "
            f"other kernels; last logits finite: {finite}")
        assert finite, arch
        if cfg.moe is not None:
            dropless_check(cfg, params, counts_of, dev)
        del params, model
        torch.cuda.empty_cache()
    return counts


def dropless_check(cfg, params, counts_of, dev):
    """Decode after prefill(256) against prefill(257), batch 2, on the
    full-width weights, with a copy of the config at capacity_factor
    DROPLESS_CF: capacity then exceeds a group's tokens, so neither
    prefill drops a token (at the config's 1.25 the two prefills group and
    drop differently, and the check would not hold).  atol 2e-4 + rtol
    1e-3, the JAX suite's tolerance; counts as in phase 6t."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.models.model import build_model
    m = cfg.moe
    dl = build_model(dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=DROPLESS_CF)))
    T = 2 * 257
    C = math.ceil(m.top_k * T / m.num_experts * DROPLESS_CF)
    assert C >= T, (C, T)                     # no expert can overflow
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 257))).to(dev)
    counts_of.reset()
    _, cache = dl.prefill(params, {"tokens": toks[:, :256]}, cache_len=257)
    pre = counts_of.read()
    counts_of.reset()
    dec, _ = dl.decode(params, toks[:, 256], cache)
    torch.cuda.synchronize()
    step = counts_of.read()
    del cache
    full, _ = dl.prefill(params, {"tokens": toks})
    assert pre == _launches(flash_attention_fwd=cfg.num_layers), pre
    assert step == _launches(), step
    diff = (dec - full).abs()
    bad = int((diff > 2e-4 + 1e-3 * full.abs()).sum())
    log(f"  {cfg.name}, dropless copy (capacity_factor {DROPLESS_CF:g}: "
        f"capacity {C} >= the {T} tokens of prefill(257)'s one group): "
        f"decode(token 256 | prefill 256) vs prefill(257) last logits, "
        f"batch 2: max |a-b| {float(diff.max()):.3e}, rel "
        f"{rel_err(dec, full):.3e}, {bad} elements beyond atol 2e-4 + rtol "
        f"1e-3; launches: prefill {cfg.num_layers} flash_attention_fwd, "
        f"decode step none")
    assert bad == 0, bad
    del dec, full


def small_serve_configs() -> list:
    """Phase 7s's configs: the smoke configs of SERVE_ARCHS, a dense one
    with flash in its prefill (phi3-mini-3.8b-smoke), the MoE one
    (llama4-scout-17b-a16e-smoke, D 64, windowed), deepseek's smoke
    config at deepseek's attention widths (head_dim 128, rope_head_dim 64)
    so that its MLA prefill reaches the kernel's (192, 128) form: the smoke
    config's own (96, 64) is not a built form; the hybrid
    (jamba-1.5-large-398b-smoke: a mamba layer through the SSD scan, an
    attention layer with a top-2 MoE), whisper-large-v3-smoke (its
    encoder's and cross layer's non-causal flash) and
    llama-3.2-vision-90b-smoke at head_dim 64 (its own 32 is not a built
    form either)."""
    import dataclasses

    from repro_torch.configs import get_arch
    cfgs = [get_arch(f"{a}-smoke") for a in SERVE_ARCHS]
    cfgs += [get_arch("phi3-mini-3.8b-smoke"),
             get_arch("llama4-scout-17b-a16e-smoke")]
    ds = get_arch("deepseek-v2-lite-16b-smoke")
    cfgs.append(dataclasses.replace(
        ds, name=f"{ds.name} (head_dim 128, rope_head_dim 64)",
        head_dim=128, mla=dataclasses.replace(ds.mla, rope_head_dim=64)))
    cfgs += [get_arch("jamba-1.5-large-398b-smoke"),
             get_arch("whisper-large-v3-smoke")]
    lv = get_arch("llama-3.2-vision-90b-smoke")
    cfgs.append(dataclasses.replace(lv, name=f"{lv.name} (head_dim 64)",
                                    head_dim=64))
    return cfgs


def small_reference_serve(dev):
    """Phase 7s: at smoke size, prefill (B 2, S 40: a ragged chunk for
    mamba2's chunk of 32; an encoder config's ``enc_embeds`` drawn with
    numpy) and 4 teacher-forced decode steps, the card against the CPU
    plain versions, on each of ``small_serve_configs``: the last logits,
    every cache entry just after the prefill (``enc_out`` too) and the
    decode steps' logits.  Under MoE the routing of every layer call (the
    chosen experts and the kept entries) is asserted equal on both devices
    before any value is compared: a flipped expert is an O(1) change, not
    a rounding one."""
    import numpy as np
    import torch
    from repro_torch.models import moe
    from repro_torch.models.model import build_model

    for cfg in small_serve_configs():
        model = build_model(cfg)
        params = model.init(torch.Generator().manual_seed(3))
        rng = np.random.default_rng(2)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 44)))
        enc = None
        if cfg.encoder is not None:
            e = cfg.encoder
            enc = torch.from_numpy(rng.normal(
                0, 1, (2, e.enc_len, e.enc_dim)).astype(np.float32))
        out, routes = [], []
        orig = moe._route
        for d in (dev, torch.device("cpu")):
            recs = []

            def route(xg, p, c):
                r = orig(xg, p, c)
                recs.append((r[1].cpu(), r[3].cpu()))   # expert_idx, keep
                return r

            moe._route = route
            try:
                p = {k: v.to(d) for k, v in params.items()}
                batch = {"tokens": toks[:, :40].to(d)}
                if enc is not None:
                    batch["enc_embeds"] = enc.to(d)
                logits, cache = model.prefill(p, batch, cache_len=45)
                snap = {f"{j}.{k}": t.clone()
                        for j, entry in enumerate(cache["layers"])
                        for k, t in entry.items()}
                if "enc_out" in cache:
                    snap["enc_out"] = cache["enc_out"].clone()
                steps = []
                for i in range(4):
                    lg, cache = model.decode(p, toks[:, 40 + i].to(d), cache)
                    steps.append(lg)
            finally:
                moe._route = orig
            out.append((logits, snap, steps))
            routes.append(recs)
        (lg, cg, sg), (lc, cc, sc) = out
        rg, rc = routes
        assert len(rg) == len(rc) and (cfg.moe is None) == (not rg), (
            cfg.name, len(rg), len(rc))
        for i, ((eg, kg), (ec, kc)) in enumerate(zip(rg, rc)):
            flips = int((eg != ec).sum())
            assert flips == 0 and torch.equal(kg, kc), (cfg.name, i, flips)
        e_pre = rel_err(lg.cpu(), lc)
        e_cache = max(rel_err(cg[k].cpu(), cc[k]) for k in cc)
        e_dec = max(rel_err(a.cpu(), b) for a, b in zip(sg, sc))
        routed = (f"; routing equal in all {len(rg)} MoE calls" if rg
                  else "")
        log(f"  {cfg.name}, card vs CPU plain: prefill logits rel "
            f"{e_pre:.3e}, cache ({', '.join(sorted(cc))}) {e_cache:.3e}, "
            f"4 teacher-forced decode steps {e_dec:.3e} (tol "
            f"{SERVE_TOL:g}){routed}")
        assert max(e_pre, e_cache, e_dec) <= SERVE_TOL, (
            cfg.name, e_pre, e_cache, e_dec)


def lint_check() -> None:
    """Phase 2b: ``python -m repro_torch.analysis.fedlint src/repro_torch``
    must report a clean tree (exit 0): the round bodies read no device
    value on the host, every kernel pass dispatches on its tensors' device
    beside a same-signature oracle, the registries declare their
    capabilities."""
    t = time.perf_counter()
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.fedlint",
         os.path.join(HERE, "src", "repro_torch")], capture_output=True,
        text=True, env={**os.environ,
                        "PYTHONPATH": os.path.join(HERE, "src")})
    log("  " + (p.stdout + p.stderr).strip().replace("\n", "\n  ")
        + f" (exit {p.returncode}, {time.perf_counter() - t:.1f} s)")
    assert p.returncode == 0 and "clean" in p.stdout, p.stdout


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--model-axis-rank"]:
        # one rank of phases 6x and 6y, under torchrun
        return model_axis_rank(sys.argv[2])
    if sys.argv[1:2] in (["--trace-only"], ["--dry-only"]):
        # phase 6l's workers: one of phase 6's rounds traced, not run; the
        # dry run
        from repro_torch.device import strict_fp32
        torch.set_num_threads(1)
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        strict_fp32()
        print(json.dumps(trace_only(sys.argv[2], dev)
                         if sys.argv[1] == "--trace-only" else dry_only()))
        return 0
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.device import strict_fp32
    from repro_torch.kernels.comm import kernel as CK
    from repro_torch.kernels.comm import ref as CR
    from repro_torch.kernels.fused_update import kernel as K
    from repro_torch.kernels.fused_update import ops as O
    from repro_torch.kernels.fused_update import ref as R
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention import ref as FR
    from repro_torch.kernels.ssd_scan import kernel as SK
    from repro_torch.kernels.ssd_scan import ref as SR

    t0 = time.perf_counter()

    def phase(*a):
        """A phase's header, with the time since the start."""
        log(*a, f"(at {time.perf_counter() - t0:.1f} s)")

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    strict_fp32()
    card = card_line()
    log(f"[1] card: {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")

    tb = time.perf_counter()
    libs = (K.LIB, CK.LIB, FK.LIB, SK.LIB)
    with ThreadPoolExecutor(len(libs)) as pool:       # one nvcc per source
        builds = [pool.submit(lib.build, True) for lib in libs]
        for f in builds:
            f.result()
    names = ", ".join(os.path.relpath(lib.source, HERE) for lib in libs)
    log(f"[2] built {names} in {time.perf_counter() - tb:.1f} s (in "
        f"parallel); nvcc -Xptxas -v:")
    for lib in libs:
        log(lib.build_log.strip())
    phase("[2b] the port's static analyzer over src/repro_torch:")
    lint_check()

    phase("[3,4] kernels against their plain versions (ssq, dw, dscal bitwise "
        "across launches; the codec kernels bitwise):")
    shapes = [8, 24, 264, 4104, *PAPER_ROWS.values(), FULL_ROWS]
    # rows 1-3 also at the rows a rank of phases 6x and 6y updates
    errs = check_kernels(K, R, O, dev, shapes + sorted(
        {axis_rows(*spec[:2])[1] for spec in MODEL_AXIS_RUNS.values()}))
    errs.update(check_bwd_kernels(K, R, O, dev, shapes))
    errs.update(check_codec_kernels(CK, CR, dev, shapes))
    phase("[3b] the serving prefill's kernels against their plain versions:")
    errs.update(check_serve_kernels(FK, FR, SK, SR, dev))

    phase("[5] kernel times at full width (CUDA events, 10 launches, warm):")
    times = time_kernels(K, R, dev)
    times.update(time_bwd_kernels(K, R, dev))
    times.update(time_codec_kernels(CK, CR, dev))
    phase("[5p] rows 1-3 at the paper models' flat shapes (CUDA events, 100 "
          "launches, inputs rotated past the L2):")
    paper_times = time_paper_kernels(K, R, dev)
    phase("[5d] the prefill's kernels at the prefill's shapes (CUDA events, "
        "warm):")
    times.update(time_serve_kernels(FK, FR, SK, SR, dev))
    times["flash_attention_fwd"]["forms"] = time_flash_prefills(FK, FR, dev)
    phase("[5c] one client's uplink at full width (CUDA events, 5 launches, "
        "warm):")
    time_codec_stage(dev)
    phase("[5b] bounds of the twelve Pallas kernels, and the library time of "
        "flash attention at S 128:")
    print_all_bounds()
    time_attention_library(dev)

    counts_of = Counts(K, CK, FK, SK)
    traces = start_roofline_traces()
    try:
        phase("[6] main path: smollm-360m, UGA + FedMeta, fused; the post, "
              "through_aggregation and lossy-uplink runs, rounds "
              f"{ {t: rounds_of(t) for t in EXPECTED_LAUNCHES} }; phase "
              f"6l's traces of {len(traces)} rounds without a run started "
              "beside it:")
        counts, ref = main_path(counts_of, dev)
        phase("[6o] the tracked run at full width: phase 6's post vmap/sgd "
              "run with the jsonl and csv trackers, the sanitizer and a "
              "profiled, summarized round 1, held bitwise to it:")
        counts.update(tracked_path(counts_of, dev, ref))
        phase("[6l] the live roofline and the dry run: phase 6's post "
              "vmap/sgd run with roofline=True, held bitwise to it; the "
              "traces of five more of phase 6's rounds without a run; the "
              "dry run of smollm-360m's four shapes and mamba2-780m's "
              "prefill:")
        counts.update(roofline_path(counts_of, dev, ref, traces))
    finally:
        stop(traces)
    counts.update(coded_path(counts_of, dev))
    phase(f"[6c] the chunked streaming cohort and the sharded executor at "
          f"full width: smollm-360m, UGA + FedMeta, sgd, cohort "
          f"{CHUNK_COHORT}, chunk {CHUNK} ({CHUNK_SLOTS} slots), client "
          f"batch 8, seq 128:")
    counts.update(chunked_path(counts_of, dev))
    phase("[6m] training through Mamba2 layers at full width: mamba2-780m, "
        "UGA + FedMeta, fused, meta_mode='post', cohort 4, client batch 8, "
        "seq 128 (one SSD chunk):")
    counts.update(mamba_path(counts_of, dev))
    phase(f"[6f] the synchronous fault model at full width: smollm-360m "
        f"vmap/sgd, {FAULT_ROUNDS} rounds, {FAULT_KW}:")
    counts.update(fault_path(counts_of, dev))
    phase("[6a] the buffered-async runtime at full width: smollm-360m, "
          "UGA + FedMeta, cohort 4, client batch 8, seq 128:")
    counts.update(async_path(counts_of, dev))
    phase("[6k] checkpoints of the full-width server state:")
    ckpt_path_check(dev)
    phase("[6g] the legacy tree engine at full width: smollm-360m, UGA + "
          "FedMeta post, cohort 4, client batch 8, seq 128; legacy_tree "
          f"vmap/sgd {LEGACY_VMAP_ROUNDS} rounds against phase 6's fused "
          "run, and scan/adam (warm) 1 round against fused_flat:")
    counts.update(legacy_path(counts_of, dev, ref))
    del ref
    phase(f"[6r] multi-round calls at full width: {RPC_SYNC_ROUNDS} fused "
          f"vmap/sgd rounds as one K={RPC_SYNC_ROUNDS} call and "
          f"{RPC_ASYNC_TICKS} buffered_async ticks as one "
          f"K={RPC_ASYNC_TICKS} call, each against K=1 calls, bitwise:")
    counts.update(rounds_per_call_path(counts_of, dev))
    phase(f"[6p] the paper's own models at their published widths: "
          f"FedMeta w/ UGA through experiments/common.py::train_method, "
          f"cohort {PAPER_COHORT}, {PAPER_ROUNDS} rounds:")
    counts.update(paper_path(counts_of, dev))

    phase("[6s] the serving main path at full width (serve.main, batch 8, "
        "prompt 1024, 32 tokens, greedy):")
    counts.update(serve_path(counts_of, dev))
    phase("[6t] full width: decode after prefill(1024) against prefill(1025):")
    serve_consistency(counts_of, dev, times)
    phase("[6u] serving at full width with flash in every prefill: "
        f"{', '.join(FLASH_SERVE)} (serve.main, batch 8, prompt 1024 "
        f"({SERVE_PROMPT}), 32 tokens, greedy), then the warm prefill; MoE: "
        "the dropless check:")
    counts.update(serve_flash_models(counts_of, dev,
                                     times["flash_attention_fwd"]["forms"]))

    phase(f"[6x, 6y] the model axis, {MODEL_AXIS_ROUNDS} rounds each at "
          "full width, depth cut: "
          + ", ".join(f"{a} at {n} layers (cohort {c}, chunks of {k}, lr "
                      f"{lr})" for a, n, c, k, lr in MODEL_AXIS_RUNS.values())
          + "; each run's world of one in this process, then a (1, "
          f"{MODEL_AXIS}) mesh, two ranks on the one card (one torchrun "
          "job, gloo) started here and run beside phase 7:")
    counts.update(model_axis_refs(counts_of, dev))
    model_axis = start_model_axis()
    try:
        phase("[7] small input, card against the CPU plain versions:")
        small_reference(dev)
        small_reference_through(dev)
        small_reference_chunked(dev)
        small_reference_coded(dev)
        small_reference_ssm(counts_of, dev)
        small_reference_faults(counts_of, dev)
        small_reference_async(counts_of, dev)
        small_reference_paper(dev)
        small_reference_legacy_rpc(counts_of, dev)
        small_reference_obs(counts_of, dev)
        small_reference_roofline_draws(counts_of, dev)
        small_reference_serve(dev)
        phase("[6x, 6y] joined: the model axis's ranks after phase 7:")
        counts.update(finish_model_axis(model_axis))
    finally:
        stop_model_axis(model_axis)

    kernels = []
    for name in KERNEL_NAMES:
        t = times[name]
        by_path = {tag: c[name] for tag, c in counts.items()}
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[FAMILY[name]],
            "replaces": REPLACES[name],
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
        if "forms" in t:          # flash at every served model's prefill
            kernels[-1]["prefill_shapes"] = t["forms"]
        if "p128" in t:           # the SSD scan at jamba's head dim
            kernels[-1]["p128"] = t["p128"]
        paper = paper_times.get("update_pass[sgd]" if name == "update_pass"
                                else name)
        if paper:                 # rows 1-3 at the paper models' shapes
            kernels[-1]["paper_shapes"] = paper
    log(f"[8] done in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
