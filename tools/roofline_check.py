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
``configs.matrix()`` that have none, on any host (``--against DIR0``:
each record's temp a device beside the same pair's in DIR0).  With
``--shortcut-check`` the sweep gives one core to a whole trace of
llama4-scout-17b-a16e x train_4k (``--no-extrapolate``, into
``DIR/whole``) and holds the sweep's record of that pair, made by the
scan cohort's shortcut (cohorts 1 and 2), to it: FLOPs, bytes and op
counts to 1e-9 relative, launches and every memory size exactly.

    python3 tools/roofline_check.py [--sweep DIR | --sweep-only DIR |
                                     --table DIR [--against DIR0]]
                                    [--shortcut-check]

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


SHORTCUT_PAIR = ("llama4-scout-17b-a16e", "train_4k")
SHORTCUT_REL = 1e-9


def sweep(cs, out_dir: str, shortcut_check: bool = False) -> int:
    """The whole dry-run matrix in a process of its own (beside it, with
    ``shortcut_check``, the whole trace of ``SHORTCUT_PAIR``); its
    table."""
    root = os.path.dirname(HERE)
    os.makedirs(out_dir, exist_ok=True)
    env = {**os.environ, "PYTHONPATH": os.path.join(root, "src")}
    dryrun = [sys.executable, "-m", "repro_torch.launch.dryrun"]
    jobs = os.cpu_count() or 1
    t = time.perf_counter()
    whole = os.path.join(out_dir, "whole")
    if shortcut_check:
        os.makedirs(whole, exist_ok=True)
    with open(os.path.join(whole, "whole.log") if shortcut_check
              else os.devnull, "w") as log:
        proof = None
        if shortcut_check:
            proof = subprocess.Popen(
                dryrun + ["--arch", SHORTCUT_PAIR[0], "--shape",
                          SHORTCUT_PAIR[1], "--no-extrapolate", "--out",
                          whole],
                stdout=log, stderr=subprocess.STDOUT, cwd=root, env=env)
            jobs = max(jobs - 1, 1)
        try:
            proc = subprocess.run(
                dryrun + ["--all", "--jobs", str(jobs), "--out", out_dir],
                capture_output=True, text=True, cwd=root, env=env)
            if proof is not None:
                proof.wait()
        finally:
            if proof is not None and proof.poll() is None:
                proof.kill()
                proof.wait()
    with open(os.path.join(out_dir, "sweep.log"), "w") as f:
        f.write(proc.stdout + proc.stderr)
    cs.log(f"dryrun --all --jobs {jobs}: exit {proc.returncode} in "
           f"{time.perf_counter() - t:.1f} s")
    table(out_dir)
    for ln in proc.stdout.splitlines():
        if ln.startswith("[dryrun] FAIL"):
            cs.log(ln)
    rc = proc.returncode
    if proof is not None:
        cs.log(f"whole trace of {SHORTCUT_PAIR}: exit {proof.returncode} "
               f"at {time.perf_counter() - t:.1f} s")
        rc = rc or proof.returncode or check_shortcut(cs, out_dir)
    return rc


def check_shortcut(cs, out_dir: str) -> int:
    """The sweep's shortcut record of ``SHORTCUT_PAIR`` against the whole
    trace's."""
    name = f"{SHORTCUT_PAIR[0]}__{SHORTCUT_PAIR[1]}__1x1.json"
    with open(os.path.join(out_dir, name)) as f:
        short = json.load(f)
    with open(os.path.join(out_dir, "whole", name)) as f:
        whole = json.load(f)
    bad = []
    if not short["extrapolated"] or whole["extrapolated"]:
        bad.append("extrapolated")
    for k in ("flops", "tc_flops", "bytes read", "bytes written",
              "bytes accessed", "aten ops"):
        a, b = short["cost"][k], whole["cost"][k]
        rel = abs(a - b) / max(abs(b), 1.0)
        cs.log(f"  {k}: shortcut {a:.10e}, whole {b:.10e}, rel {rel:.2e}")
        if rel > SHORTCUT_REL:
            bad.append(k)
    a, b = (short["hlo_cost"]["collective_bytes"],
            whole["hlo_cost"]["collective_bytes"])
    if abs(a - b) > SHORTCUT_REL * max(abs(b), 1.0):
        bad.append("collective_bytes")
    for k in ("launches", "memory"):
        cs.log(f"  {k}: shortcut {short[k]}, whole {whole[k]}")
        if short[k] != whole[k]:
            bad.append(k)
    cs.log(f"  trace seconds: shortcut {short['trace_s']} (cohorts 1 + 2), "
           f"whole {whole['trace_s']}")
    cs.log(f"shortcut check of {SHORTCUT_PAIR}: "
           f"{'equal' if not bad else 'DIFFERS in ' + ', '.join(bad)}")
    return 1 if bad else 0


def table(out_dir: str, against: str = None) -> None:
    """The records in ``out_dir`` as a markdown table, then the pairs of
    the matrix without one.  ``against``: a directory of earlier records
    of the same pairs and meshes, whose temp a device each row shows
    beside its own (and the change)."""
    sys.path.insert(0, os.path.join(os.path.dirname(HERE), "src"))
    from repro_torch.configs import matrix
    extra = " temp GiB | against | change |" if against else ""
    print("| arch | shape | mesh | dtype | FLOP/dev | bytes/dev | args + "
          "temp GiB | bottleneck | fits | trace s | launches | traced |"
          + extra)
    print("|---" * (12 + 3 * bool(against)) + "|")
    seen = set()
    for path in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(path) as f:
            r = json.load(f)
        seen.add((r["arch"], r["shape"]))
        m = r["memory"]
        peak = (m["argument_size_in_bytes"] + m["temp_size_in_bytes"]) / 2**30
        row = (f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
               f"{r.get('dtype', 'float32')} | {r['cost']['flops']:.4e} | "
               f"{r['cost']['bytes accessed']:.4e} | {peak:.2f} | "
               f"{r['roofline']['bottleneck']} | {r['fits']} | "
               f"{r['trace_s']} | {r['launches']} | "
               f"{'cohorts 1, 2' if r.get('extrapolated') else 'whole'} |")
        if against:
            temp = m["temp_size_in_bytes"] / 2**30
            other = os.path.join(against, os.path.basename(path))
            if os.path.exists(other):
                with open(other) as f:
                    t0 = json.load(f)["memory"]["temp_size_in_bytes"] / 2**30
                row += (f" {temp:.2f} | {t0:.2f} | "
                        f"{100 * (temp / t0 - 1) if t0 else 0:+.1f}% |")
            else:
                row += f" {temp:.2f} | none | |"
        print(row, flush=True)
    missing = [p for p in matrix() if p not in seen]
    print(f"{len(seen)} pairs recorded; without a record: {missing}",
          flush=True)


def main() -> int:
    if "--table" in sys.argv:
        table(sys.argv[sys.argv.index("--table") + 1],
              sys.argv[sys.argv.index("--against") + 1]
              if "--against" in sys.argv else None)
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
    check = "--shortcut-check" in sys.argv
    if "--sweep-only" in sys.argv:
        return sweep(cs, sys.argv[sys.argv.index("--sweep-only") + 1],
                     check)
    K.LIB.build(True)
    counts_of = cs.Counts(K, CK, FK, SK)
    traces = cs.start_roofline_traces()
    try:
        ref = cs.post_vmap_reference(counts_of, dev)
        cs.log(f"  phase 6's post vmap/sgd run: round walls {ref['walls']}")
        cs.log(f"[6l] at {time.perf_counter() - t0:.1f} s")
        cs.roofline_path(counts_of, dev, ref, traces)
    finally:
        cs.stop(traces)
    rc = 0
    if "--sweep" in sys.argv:
        cs.log(f"[sweep] at {time.perf_counter() - t0:.1f} s")
        rc = sweep(cs, sys.argv[sys.argv.index("--sweep") + 1], check)
    cs.log(f"roofline_check: done in {time.perf_counter() - t0:.1f} s")
    return rc


if __name__ == "__main__":
    sys.exit(main())
