"""One steady vmap/sgd round of the training main path under
``torch.profiler``: smollm-360m at full width, UGA + FedMeta, fused,
cohort 4, client batch 8, seq 128.  Prints the device's busy time by
kernel, the fused-update kernels' share of it, the device's idle share of
the profiled round and an estimate for the unprofiled one, and the host's
operator calls by self CPU time.  It was a phase of ``chip_smoke.py``,
taken out to keep the smoke script inside its time limit.

Run on one card from the repo's root::

    python3 tools/profile_round.py

About 150 s on an H100.  It exits non-zero without a CUDA device.
"""
from __future__ import annotations

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)


def profile_round(dev):
    """Two steady vmap/sgd rounds at full width, the second under
    ``torch.profiler``: device busy time by kernel, the share of the
    fused-update kernels, the device's idle share of the profiled round,
    an estimate of it for the unprofiled round, and the host's operator
    calls by self CPU time."""
    import collections

    import torch
    from torch.autograd import DeviceType

    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import FedConfig, get_arch
    from repro_torch.core.trainer import FederatedTrainer
    from repro_torch.launch.train import build_synthetic_fed_data
    from repro_torch.models.model import build_model

    cfg = get_arch("smollm-360m")
    fed = FedConfig(algorithm="uga", meta=True, cohort=cs.COHORT,
                    client_lr=0.01, server_lr=0.01, meta_lr=0.01,
                    lr_decay=0.992, fused_update=True)
    trainer = FederatedTrainer(build_model(cfg, loss_chunk=256), fed,
                               device=dev)
    data = build_synthetic_fed_data(cfg, num_clients=32, examples=2048,
                                    seq=128, iid=False)
    kw = dict(cohort=cs.COHORT, batch=8, meta_batch=16)
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
    cs.log(f"  profiled round wall {wall_us / 1e3:.2f} ms; device busy "
        f"{busy_us / 1e3:.2f} ms (idle share of the profiled round "
        f"{100 * (1 - busy_us / wall_us):.1f}%); fused-update kernels "
        f"{ours / 1e3:.3f} ms ({100 * ours / max(busy_us, 1):.2f}% of busy)")
    # The profiler slows the host, not the device: the busy time over the
    # wall of the unprofiled round just before is an estimate of the idle
    # share without the profiler (two rounds, one process).
    cs.log(f"  unprofiled round wall {plain_wall_us / 1e3:.2f} ms; estimated "
        f"idle share without the profiler "
        f"{100 * (1 - busy_us / plain_wall_us):.1f}%")
    for name, us in by_name.most_common(10):
        cs.log(f"    {us / 1e3:9.3f} ms  {100 * us / busy_us:5.1f}%  {name[:90]}")
    assert busy_us > 0, "the profiler saw no device time"
    # The host side: time inside operators (dispatch and launch) against
    # the round's wall time; the rest is Python and torch.func between ops.
    avgs = sorted(prof.key_averages(), key=lambda a: a.self_cpu_time_total,
                  reverse=True)
    op_us = sum(a.self_cpu_time_total for a in avgs)
    n_aten = sum(a.count for a in avgs if a.key.startswith("aten::"))
    cs.log(f"  host: {n_aten} aten operator calls; self CPU time in operators "
        f"{op_us / 1e3:.2f} ms ({100 * op_us / wall_us:.1f}% of wall); top:")
    for a in avgs[:8]:
        cs.log(f"    {a.self_cpu_time_total / 1e3:9.3f} ms  {a.count:7d} calls  "
            f"{a.key[:70]}")


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
    profile_round(dev)
    cs.log(f"profile_round: done in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
