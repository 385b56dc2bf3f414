"""One steady vmap/sgd round of the training main path under the port's
profiler window (``FederatedTrainer(profile=1, trace_summary=True)``, the
``repro_torch.obs`` path): smollm-360m at full width, UGA + FedMeta,
fused, cohort 4, client batch 8, seq 128.

Rounds 0 and 1 run unprofiled (round 1 is the unprofiled yardstick),
round 2 under ``torch.profiler``.  From the trace
(:func:`repro_torch.obs.trace_analysis.summarize_trace`, the
``profile_summary`` event): the device's busy share of its window
(``busy_frac``), the top kernels by self time, the fused-update kernels'
share of the busy time, and the device time by phase (dispatch against
device_sync), with the host's operator calls by self time from the
trace's ``cpu_op`` events.  On the same capture, the measure this script
took before the obs path: ``torch.profiler``'s own events (device time
summed over kernels, over the profiled round's host wall — its
sample_stack, dispatch and device_sync spans — and over the unprofiled
round's, as an estimate without the profiler) and ``key_averages``' aten
call count.

Run on one card from the repo's root::

    python3 tools/profile_round.py

About 2-3 minutes on an H100.  It exits non-zero without a CUDA device.
"""
from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

FUSED = ("aggregate_kernel", "accumulate_kernel", "update_kernel",
         "reduce_partials")


def profile_round(dev):
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_arch
    from repro_torch.core.trainer import FederatedTrainer
    from repro_torch.launch.train import build_synthetic_fed_data
    from repro_torch.models.model import build_model
    from repro_torch.obs import trace_analysis as TA

    cfg = get_arch("smollm-360m")
    run_dir = tempfile.mkdtemp(prefix="profile_round_",
                               dir=os.path.join(ROOT, "build"))
    trainer = FederatedTrainer(
        build_model(cfg, loss_chunk=256), cs._full_fed(fused_update=True),
        device=dev, tracker="jsonl", run_dir=run_dir, profile=1,
        profile_start=2, trace_summary=True, trace_top_k=100_000)
    data = build_synthetic_fed_data(cfg, num_clients=32, examples=2048,
                                    seq=128, iid=False)
    # keep the window's torch.profiler object for the earlier measure
    kept, stop = [], trainer.profiler._stop

    def keep_and_stop(last_round):
        kept.append(trainer.profiler._prof)
        stop(last_round)

    trainer.profiler._stop = keep_and_stop
    marks = [time.perf_counter()]

    def on_records(recs, tr):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    trainer.run(data, rounds=3, cohort=cs.COHORT, batch=8, meta_batch=16,
                on_records=on_records)
    trainer.finish()
    walls = [b - a for a, b in zip(marks, marks[1:])]
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        lines = [json.loads(ln) for ln in f]
    spans = {(e["phase"], e["round"]): e["dur_s"] for e in lines
             if e.get("event") == "phase"}
    (s,) = [e for e in lines if e.get("event") == "profile_summary"]
    busy_ms = s["busy_us"] / 1e3
    fused_us = sum(o["self_us"] for o in s["top_ops"]
                   if any(n in o["op"] for n in FUSED))
    # the profiled round's wall without the window's export and summary
    prof_s = sum(spans[p, 2] for p in ("sample_stack", "dispatch",
                                       "device_sync"))
    cs.log(f"  rounds' wall s {[round(w, 4) for w in walls]} (round 0 "
           f"includes init; round 2 profiled, with the trace's export and "
           f"summary); round 2's spans: sample_stack "
           f"{spans['sample_stack', 2]:.4f} s, dispatch "
           f"{spans['dispatch', 2]:.4f} s, device_sync "
           f"{spans['device_sync', 2]:.4f} s (round 1's: "
           f"{spans['dispatch', 1]:.4f} and {spans['device_sync', 1]:.4f})")
    cs.log(f"  obs path (summarize_trace): {s['n_op_events']} device ops of "
           f"{s['n_ops']} kinds; busy {busy_ms:.2f} ms of a "
           f"{s['wall_us'] / 1e3:.2f} ms device window: busy_frac "
           f"{s['busy_frac']:.4f} (idle {100 * (1 - s['busy_frac']):.1f}%); "
           f"fused-update kernels {fused_us / 1e3:.3f} ms "
           f"({100 * fused_us / max(s['busy_us'], 1):.2f}% of busy)")
    cs.log("  device self time by phase (ms): " + ", ".join(
        f"{k} {v / 1e3:.2f}" for k, v in s["phase_self_us"].items()))
    for o in s["top_ops"][:10]:
        cs.log(f"    {o['self_us'] / 1e3:9.3f} ms  "
               f"{100 * o['self_us'] / s['busy_us']:5.1f}%  x{o['count']:<6d}"
               f" {o['op'][:80]}")

    # the measure this script took before the obs path, on the same
    # capture: device time summed over kernels against the host's wall
    # (the device-side copies of the phase ranges are not kernels)
    from torch.autograd import DeviceType
    (prof,) = kept
    summed_us = sum(e.time_range.elapsed_us() for e in prof.events()
                    if e.device_type == DeviceType.CUDA
                    and not e.name.startswith(TA.PHASE_PREFIX))
    n_aten = sum(a.count for a in prof.key_averages()
                 if a.key.startswith("aten::"))
    cs.log(f"  torch.profiler's events: device time summed over kernels "
           f"{summed_us / 1e3:.2f} ms: idle share of the profiled round "
           f"({prof_s:.4f} s) {100 * (1 - summed_us / 1e6 / prof_s):.1f}%, "
           f"of the unprofiled round 1 ({walls[1]:.4f} s, the estimate "
           f"without the profiler) "
           f"{100 * (1 - summed_us / 1e6 / walls[1]):.1f}%; key_averages: "
           f"{n_aten} aten operator calls")
    assert summed_us > 0, "the profiler saw no device time"
    del prof, kept

    # the host: the trace's operator calls by self time
    trace = TA.load_trace(s["trace"])
    host = {"traceEvents": [e for e in trace["traceEvents"]
                            if isinstance(e, dict)
                            and e.get("cat") == TA.HOST_OP_CAT]}
    h = TA.summarize(host, top_k=8)
    aten = sum(1 for e in host["traceEvents"]
               if str(e.get("name", "")).startswith("aten::"))
    cs.log(f"  host (the trace's cpu_op events): {aten} aten operator "
           f"calls; self CPU time in operators "
           f"{h['total_self_us'] / 1e3:.2f} ms "
           f"({100 * h['total_self_us'] / (prof_s * 1e6):.1f}% of the "
           f"profiled round's wall); top:")
    for o in h["top_ops"]:
        cs.log(f"    {o['self_us'] / 1e3:9.3f} ms  {o['count']:7d} calls  "
               f"{o['op'][:70]}")
    cs.log(f"  trace {os.path.getsize(s['trace']) / 2**20:.1f} MiB")
    shutil.rmtree(run_dir)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("profile_round: no CUDA device available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.device import strict_fp32
    from repro_torch.kernels.fused_update import kernel as K

    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    strict_fp32()
    cs.log(cs.card_line())
    K.LIB.build(True)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    profile_round(dev)
    cs.log(f"profile_round: done in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
