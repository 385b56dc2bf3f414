#!/usr/bin/env python3
"""Observability and the round sanitizer on one NVIDIA GPU:
``chip_smoke.py``'s phase 6o (phase 6's post vmap/sgd run at full width
again with the jsonl and csv trackers, the sanitizer and a profiled,
summarized round, held bitwise to it; phase 6's run is made here first)
and phase 7o (the garbled ``--sanitize`` run, the clean sanitized K = 2
run, a profiled smoke round) — then ``tools/profile_round.py``'s round.
``--cli`` runs only the launcher check: ``python -m
repro_torch.launch.train --arch smollm-360m --fused`` for 2 rounds, once
plain and once with ``--tracker jsonl,csv --run-dir D --profile 1
--profile-start 1 --trace-summary --sanitize``, each saving its server
state with ``--ckpt``: the two blobs must be equal byte for byte, and the
flagged run must leave ``metrics.jsonl``, a trace and a
``profile_summary`` naming the fused-update kernels.

    python3 tools/obs_check.py [--no-profile-round | --cli]

About 3-5 minutes on one H100 (``--cli`` about 3); exits non-zero
without a card.
"""
import filecmp
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)


def cli_check(cs) -> None:
    """The launcher with and without the observability flags."""
    root = os.path.dirname(HERE)
    base = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            "smollm-360m", "--fused", "--rounds", "2", "--cohort", "4",
            "--client-batch", "8", "--seq", "128", "--log-every", "1"]
    env = {**os.environ, "PYTHONPATH": os.path.join(root, "src")}
    with tempfile.TemporaryDirectory(dir=os.path.join(root, "build")) as d:
        plain, flagged = os.path.join(d, "a.msgpack"), \
            os.path.join(d, "b.msgpack")
        run_dir = os.path.join(d, "run")
        for argv in (["--ckpt", plain],
                     ["--ckpt", flagged, "--tracker", "jsonl,csv",
                      "--run-dir", run_dir, "--profile", "1",
                      "--profile-start", "1", "--trace-summary",
                      "--trace-top-k", "1000", "--sanitize"]):
            t = time.perf_counter()
            subprocess.run(base + argv, check=True, env=env, cwd=root)
            cs.log(f"  cli {' '.join(argv[2:]) or 'plain'}: "
                   f"{time.perf_counter() - t:.1f} s")
        same = filecmp.cmp(plain, flagged, shallow=False)
        with open(os.path.join(run_dir, "metrics.jsonl")) as f:
            lines = [json.loads(ln) for ln in f]
        (summ,) = [ln for ln in lines if ln.get("event") == "profile_summary"]
        ops = [o["op"] for o in summ["top_ops"]]
        named = {k: any(k in o for o in ops) for k in cs.TRACKED_KERNELS}
        cs.log(f"  cli: --ckpt blobs equal byte for byte: {same} (required); "
               f"{sum(ln['kind'] == 'metrics' for ln in lines)} metrics "
               f"lines; trace {os.path.basename(summ['trace'])}, "
               f"{os.path.getsize(summ['trace']) / 2**20:.1f} MiB; "
               f"busy_frac {summ['busy_frac']:.4f}; kernels named {named}")
        assert same and all(named.values()), (same, named)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("obs_check: no CUDA device available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.device import strict_fp32
    from repro_torch.kernels.comm import kernel as CK
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.fused_update import kernel as K
    from repro_torch.kernels.ssd_scan import kernel as SK

    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    strict_fp32()
    cs.log(cs.card_line())
    os.makedirs(os.path.join(cs.HERE, "build"), exist_ok=True)
    K.LIB.build(True)
    if "--cli" in sys.argv:
        cli_check(cs)
        cs.log(f"obs_check: done in {time.perf_counter() - t0:.1f} s")
        return 0
    counts_of = cs.Counts(K, CK, FK, SK)
    ref = cs.post_vmap_reference(counts_of, dev, layers=cs.TRACKED_LAYERS)
    cs.log(f"  phase 6's post vmap/sgd run: round walls {ref['walls']}")
    cs.log(f"[6o] at {time.perf_counter() - t0:.1f} s")
    cs.tracked_path(counts_of, dev, ref)
    del ref
    cs.log(f"[7o] at {time.perf_counter() - t0:.1f} s")
    cs.small_reference_obs(counts_of, dev)
    if "--no-profile-round" not in sys.argv:
        import profile_round
        cs.log(f"[profile_round] at {time.perf_counter() - t0:.1f} s")
        profile_round.profile_round(dev)
    cs.log(f"obs_check: done in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
