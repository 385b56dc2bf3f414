"""Time forms of ``accumulate_pass`` against one another on the card.

``accumulate_pass`` (out = acc + w g, out may alias acc; four launches a
scan round) is timed at full width (smollm-360m's flat layout, 2,826,728
rows of 128 fp32) in place (``out=acc``, the scan executor's form) and out
of place, beside:

  * the port's kernel, ``repro_torch.kernels.fused_update.accumulate_pass``;
  * the forms in ``tools/csrc/accumulate_forms.cu``: one float4 a thread
    with a plain store, the same with a streaming store (``__stcs``), and a
    grid-stride loop with four float4 of each input in flight a thread at
    4, 8 and 16 blocks an SM;
  * the library call of the same form: ``acc.add_(g, alpha=w)`` in place,
    ``torch.add(acc, g, alpha=w, out=out)`` out of place.

Every form is first checked bitwise against the port's kernel, then all
are warmed (20 launches each) and timed in turns: each form for 10
launches in order, then in reverse order, three times over, so neither a
drift of the card's clocks nor a slow first pass favours one of them.  For
each form the script prints the mean of its six timings and their range,
beside the byte bound (3 x 1.447 GB over 3.35 TB/s).  The two one-float4
forms are timed twice, as two entries far apart in the order: the gap
between the copies of one form is the spread of the comparison.

Run on one card from the repo's root::

    python3 tools/accumulate_forms.py [--out results.json]

It builds its source with ``nvcc`` for ``sm_90a`` into ``tools/build/``
and exits non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "src"))

ROWS = 2_826_728                # smollm-360m's flat layout (rows, 128)
SOURCE = os.path.join(HERE, "csrc", "accumulate_forms.cu")


def kernel_bound_ms(kc) -> float:
    """A kernel's declared cost (``kernels/*/kernel.py``'s ``*_cost``) over
    the H100 SXM rates of ``repro_torch/roofline/analysis.py``."""
    from repro_torch.roofline.analysis import bound_s
    return bound_s(kc.bytes_read + kc.bytes_written, kc.flops,
                   kc.tc_flops)[0] * 1e3


def _bind(lib: ctypes.CDLL) -> None:
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.af_launch.argtypes = [I, I, P, P, P, P, ctypes.c_int64, P]
    lib.af_launch.restype = ctypes.c_int


def cuda_ms(fn, iters: int) -> float:
    """One untimed call, then the start event queued behind it (the card
    busy while the host issues the timed calls), then ``iters`` calls."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(fns: dict, reps: int = 3, iters: int = 10) -> dict:
    """name -> its timings (ms a launch): every function warmed, then
    timed in order and in reverse order, ``reps`` times over."""
    import torch
    for fn in fns.values():
        for _ in range(20):
            fn()
    torch.cuda.synchronize()
    got = {name: [] for name in fns}
    order = list(fns)
    for _ in range(reps):
        for name in order + order[::-1]:
            got[name].append(cuda_ms(fns[name], iters))
    return got


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="", help="write the results as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("accumulate_forms: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.device import strict_fp32
    from repro_torch.kernels._cuda import CudaLibrary, raise_on, stream
    from repro_torch.kernels.fused_update import kernel as K

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    strict_fp32()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader", "--id=0"],
                          capture_output=True, text=True,
                          check=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    lib = CudaLibrary("accumulate_forms", SOURCE, _bind).load()
    K.LIB.load()

    n = ROWS * 128
    gen = torch.Generator(device=dev).manual_seed(1)
    acc, g, out = torch.randn((3, ROWS, 128), generator=gen, device=dev)
    w = torch.tensor([0.25], device=dev)
    s = stream(dev)

    def form(code, per_sm=0):
        def launch(a, o):
            raise_on(lib.af_launch(code, per_sm, a.data_ptr(), g.data_ptr(),
                                   w.data_ptr(), o.data_ptr(), n, s),
                     "accumulate form")
        return launch

    # the two one-float4 forms twice each, apart in the order: the gap
    # between two copies of one form is the spread a difference between
    # forms has to exceed
    forms = {"one float4, plain store": form(0),
             "one float4, __stcs": form(1),
             "port kernel (fused_update.cu)":
             lambda a, o: K.accumulate_pass(a, g, w, out=o),
             "grid-stride U4, 4 blocks/SM": form(2, 4),
             "grid-stride U4, 8 blocks/SM": form(2, 8),
             "grid-stride U4, 16 blocks/SM": form(2, 16),
             "one float4, __stcs (second copy)": form(1),
             "one float4, plain store (second copy)": form(0)}

    # bitwise: every form, in place and out of place, against the port's
    # kernel out of place from the same inputs
    want = torch.empty_like(acc)
    K.accumulate_pass(acc, g, w, out=want)
    for name, fn in forms.items():
        o = torch.empty_like(acc)
        fn(acc, o)
        a = acc.clone()
        fn(a, a)
        torch.cuda.synchronize()
        if not (torch.equal(o, want) and torch.equal(a, want)):
            raise AssertionError(f"{name}: not bitwise the port's kernel")
        del o, a
    del want
    torch.cuda.empty_cache()
    print("every form bitwise the port's kernel, in place and out of place",
          flush=True)

    bound = kernel_bound_ms(K.accumulate_cost(ROWS))
    results = {"card": card, "bound_ms": bound, "rows": ROWS}
    for mode in ("in place", "out of place"):
        dst = (lambda: acc) if mode == "in place" else (lambda: out)
        fns = {name: (lambda fn=fn: fn(acc, dst())) for name, fn in
               forms.items()}
        if mode == "in place":
            fns["library: acc.add_(g, alpha=w)"] = (
                lambda: acc.add_(g, alpha=0.25))
        else:
            fns["library: torch.add(acc, g, alpha=w, out=out)"] = (
                lambda: torch.add(acc, g, alpha=0.25, out=out))
        got = in_turns(fns)
        results[mode] = {}
        print(f"{mode} (bound {bound:.4f} ms, bytes):", flush=True)
        for name, ts in got.items():
            mean = sum(ts) / len(ts)
            results[mode][name] = dict(mean_ms=mean, min_ms=min(ts),
                                       max_ms=max(ts), timings_ms=ts)
            print(f"  {name}: {mean:.4f} ms (range {min(ts):.4f}-"
                  f"{max(ts):.4f}, spread {max(ts) - min(ts):.4f}), "
                  f"{100 * bound / mean:.1f}% of bound", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    print(json.dumps({m: {k: round(v["mean_ms"], 4) for k, v in
                          results[m].items()}
                      for m in ("in place", "out of place")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
