#!/usr/bin/env python3
"""The live roofline and the dry run on one NVIDIA GPU: ``chip_smoke.py``'s
phase 6l (phase 6's post vmap/sgd run at full width again with
``roofline=True``, held bitwise to it; phase 6's run is made here first;
traces of five more of phase 6's rounds without a run, in parallel
processes; the dry run of smollm-360m's four shapes and mamba2-780m's
prefill).  ``--sweep DIR`` then runs ``python -m
repro_torch.launch.dryrun --all --jobs <cores> --out DIR`` and prints its
table: per pair the per-device FLOPs, bytes, peak (arguments + temp),
bottleneck and ``fits``, and the failures by cause.  ``--sweep-only DIR``
runs the sweep alone; ``--table DIR`` prints the table of the records a
sweep (or single ``dryrun`` runs) left in DIR, with the pairs of
``configs.matrix()`` that have none, on any host.

    python3 tools/roofline_check.py [--sweep DIR | --sweep-only DIR |
                                     --table DIR]

About 3-5 minutes on one H100 without the sweep; exits non-zero without a
card.
"""
import glob
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


def sweep(cs, out_dir: str) -> int:
    """The whole dry-run matrix in a process of its own; its table."""
    root = os.path.dirname(HERE)
    os.makedirs(out_dir, exist_ok=True)
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
         "--jobs", str(os.cpu_count() or 1), "--out", out_dir],
        capture_output=True, text=True, cwd=root,
        env={**os.environ, "PYTHONPATH": os.path.join(root, "src")})
    with open(os.path.join(out_dir, "sweep.log"), "w") as f:
        f.write(proc.stdout + proc.stderr)
    cs.log(f"dryrun --all: exit {proc.returncode} in "
           f"{time.perf_counter() - t:.1f} s")
    table(out_dir)
    for ln in proc.stdout.splitlines():
        if ln.startswith("[dryrun] FAIL"):
            cs.log(ln)
    return proc.returncode


def table(out_dir: str) -> None:
    """The records in ``out_dir`` as a markdown table, then the pairs of
    the matrix without one."""
    sys.path.insert(0, os.path.join(os.path.dirname(HERE), "src"))
    from repro_torch.configs import matrix
    print("| arch | shape | FLOP/dev | bytes/dev | args + temp GiB | "
          "bottleneck | fits | trace s | launches |")
    print("|---|---|---|---|---|---|---|---|---|")
    seen = set()
    for path in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(path) as f:
            r = json.load(f)
        seen.add((r["arch"], r["shape"]))
        m = r["memory"]
        peak = (m["argument_size_in_bytes"] + m["temp_size_in_bytes"]) / 2**30
        print(f"| {r['arch']} | {r['shape']} | {r['cost']['flops']:.4e} | "
              f"{r['cost']['bytes accessed']:.4e} | {peak:.2f} | "
              f"{r['roofline']['bottleneck']} | {r['fits']} | "
              f"{r['trace_s']} | {r['launches']} |", flush=True)
    missing = [p for p in matrix() if p not in seen]
    print(f"{len(seen)} pairs recorded; without a record: {missing}",
          flush=True)


def main() -> int:
    if "--table" in sys.argv:
        table(sys.argv[sys.argv.index("--table") + 1])
        return 0
    import torch
    if not torch.cuda.is_available():
        print("roofline_check: no CUDA device available", file=sys.stderr)
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
    if "--sweep-only" in sys.argv:
        return sweep(cs, sys.argv[sys.argv.index("--sweep-only") + 1])
    K.LIB.build(True)
    counts_of = cs.Counts(K, CK, FK, SK)
    ref = cs.post_vmap_reference(counts_of, dev)
    cs.log(f"  phase 6's post vmap/sgd run: round walls {ref['walls']}")
    cs.log(f"[6l] at {time.perf_counter() - t0:.1f} s")
    cs.roofline_path(counts_of, dev, ref)
    rc = 0
    if "--sweep" in sys.argv:
        cs.log(f"[sweep] at {time.perf_counter() - t0:.1f} s")
        rc = sweep(cs, sys.argv[sys.argv.index("--sweep") + 1])
    cs.log(f"roofline_check: done in {time.perf_counter() - t0:.1f} s")
    return rc


if __name__ == "__main__":
    sys.exit(main())
