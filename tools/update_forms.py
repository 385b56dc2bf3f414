"""Time forms of ``update_pass`` against one another on the card.

``update_pass`` (the clip scale and the optimizer step over the flat
buffers; one launch every round) is timed at full width (smollm-360m's
flat layout, 2,826,728 rows of 128 fp32), each of its four instances
(sgd, sgdm, adam, yogi), beside:

  * the port's kernel, ``repro_torch.kernels.fused_update.update_pass``;
  * the forms in ``tools/csrc/update_forms.cu``, which differ from one
    another only in how they load and store: form 0 is the kernel as
    ``fused_update.cu`` had it before its stores became streaming
    (``__stcs``); the others add the streaming store, a plain load of p
    instead of ``__ldcs``, and the four scalars read through ``__ldg`` or
    once a block into shared memory;
  * the library calls of the same function: ``torch.add(p, G,
    alpha=-lr)`` and ``torch.add(p, G, alpha=-lr, out=out)`` for sgd,
    ``torch._fused_adam_`` (in place) for adam.

sgd is timed in every form; sgdm, adam and yogi in forms 0 and 1, the two
the port chooses between.

Every form is first checked bitwise against the port's kernel, then all
are warmed (20 launches each) and timed in turns: each form for 10
launches in order, then in reverse order, three times over, so neither a
drift of the card's clocks nor a slow first pass favours one of them.  For
each form the script prints the mean of its six timings and their range,
beside the byte bound (3, 5, 7 and 7 x 1.447 GB for sgd, sgdm, adam and
yogi, over 3.35 TB/s).  Form 0 and form 1 are timed twice, as two entries
far apart in the order: the gap between the copies of one form is the
spread of the comparison.

Run on one card from the repo's root::

    python3 tools/update_forms.py [--out results.json]

It builds its source with ``nvcc`` for ``sm_90a`` into ``tools/build/``
and exits non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "src"))

from accumulate_forms import ROWS, in_turns, kernel_bound_ms  # noqa: E402

SOURCE = os.path.join(HERE, "csrc", "update_forms.cu")
OPT_CODES = {"sgd": 0, "sgdm": 1, "adam": 2, "yogi": 3}
FORMS = {0: "form 0: plain store (fused_update.cu before)",
         1: "form 1: __stcs",
         2: "form 2: plain load of p",
         3: "form 3: __stcs + plain load of p",
         4: "form 4: __stcs, scalars by __ldg",
         5: "form 5: __stcs, scalars once a block in shared memory"}
HYPER = dict(momentum=0.9, b1=0.9, b2=0.99, eps=1e-8)


def _bind(lib: ctypes.CDLL) -> None:
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.uf_launch.argtypes = ([I, I] + [P] * 8 + [ctypes.c_int64]
                              + [F] * 6 + [P])
    lib.uf_launch.restype = ctypes.c_int


def library():
    """The forms' library, built into ``tools/build/`` at first use."""
    from repro_torch.kernels._cuda import CudaLibrary
    return CudaLibrary("update_forms", SOURCE, _bind)


def launcher(lib, opt: str, form: int):
    """A function (G, p, m, v, scal, np, nm, nv) -> None launching one
    form on the current stream with ``update_pass``'s hyperparameters."""
    from repro_torch.kernels._cuda import ptr, raise_on, stream
    h = HYPER

    def launch(G, p, m, v, scal, np_, nm, nv):
        raise_on(lib.uf_launch(
            OPT_CODES[opt], form, G.data_ptr(), p.data_ptr(), ptr(m), ptr(v),
            scal.data_ptr(), np_.data_ptr(), ptr(nm), ptr(nv), G.numel(),
            h["momentum"], h["b1"], 1.0 - h["b1"], h["b2"], 1.0 - h["b2"],
            h["eps"], stream(G.device)), f"update form {form}")
    return launch


def main() -> int:
    import subprocess

    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="", help="write the results as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("update_forms: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.device import strict_fp32
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
    lib = library().load()
    K.LIB.load()

    n = ROWS * 128
    gen = torch.Generator(device=dev).manual_seed(1)
    G, p, m = torch.randn((3, ROWS, 128), generator=gen, device=dev) * 0.1
    v = torch.rand((ROWS, 128), generator=gen, device=dev) * 0.01 + 1e-3
    np_, nm, nv = torch.empty((3, ROWS, 128), device=dev)
    lr = 0.01
    scal = torch.tensor([1.0, lr, 1.0 / (1 - 0.9), 1.0 / (1 - 0.99)],
                        device=dev)
    results = {"card": card, "rows": ROWS}
    for opt in OPT_CODES:
        mm = None if opt == "sgd" else m
        vv = v if opt in ("adam", "yogi") else None
        nmm = None if opt == "sgd" else nm
        nvv = nv if opt in ("adam", "yogi") else None
        forms = {name: launcher(lib, opt, f) for f, name in FORMS.items()}
        # bitwise: every form against the port's kernel from the same inputs
        want = K.update_pass(G, p, mm, vv, scal, opt=opt, **HYPER)
        for name, fn in forms.items():
            fn(G, p, mm, vv, scal, np_, nmm, nvv)
            got = (np_, nmm, nvv)
            torch.cuda.synchronize()
            for a, b in zip(got, want):
                if (a is None) != (b is None) or (
                        a is not None and not torch.equal(a, b)):
                    raise AssertionError(f"{opt} {name}: not bitwise the "
                                         "port's kernel")
        del want
        print(f"{opt}: every form bitwise the port's kernel", flush=True)

        fns = {name: (lambda fn=fn: fn(G, p, mm, vv, scal, np_, nmm, nvv))
               for name, fn in forms.items()}
        fns["port kernel (fused_update.cu)"] = (
            lambda: K.update_pass(G, p, mm, vv, scal, opt=opt, **HYPER))
        if opt == "sgd":
            fns["library: torch.add(p, G, alpha=-lr)"] = (
                lambda: torch.add(p, G, alpha=-lr))
            fns["library: torch.add(p, G, alpha=-lr, out=out)"] = (
                lambda: torch.add(p, G, alpha=-lr, out=np_))
        else:
            # forms 2-5 would only repeat the sgd comparison: the other
            # instances keep the two forms the port chooses between
            fns = {k: f for k, f in fns.items()
                   if not k.startswith(("form 2", "form 3", "form 4",
                                        "form 5"))}
        if opt == "adam":
            step = torch.tensor(1.0, device=dev)
            pl, ml, vl = p.clone(), m.clone(), v.clone()
            fns["library: torch._fused_adam_ (in place)"] = (
                lambda: torch._fused_adam_(
                    [pl], [G], [ml], [vl], [], [step], lr=lr, beta1=0.9,
                    beta2=0.99, weight_decay=0.0, eps=1e-8, amsgrad=False,
                    maximize=False))
        # the second copies of forms 0 and 1, far from the first ones
        fns[FORMS[1] + " (second copy)"] = fns[FORMS[1]]
        fns[FORMS[0] + " (second copy)"] = fns[FORMS[0]]
        bound = kernel_bound_ms(K.update_cost(opt, ROWS))
        got = in_turns(fns)
        results[opt] = {"bound_ms": bound}
        print(f"update_pass[{opt}] (bound {bound:.4f} ms, bytes):",
              flush=True)
        for name, ts in got.items():
            mean = sum(ts) / len(ts)
            results[opt][name] = dict(mean_ms=mean, min_ms=min(ts),
                                      max_ms=max(ts), timings_ms=ts)
            print(f"  {name}: {mean:.4f} ms (range {min(ts):.4f}-"
                  f"{max(ts):.4f}, spread {max(ts) - min(ts):.4f}), "
                  f"{100 * bound / mean:.1f}% of bound", flush=True)
        if opt == "adam":
            del pl, ml, vl
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    print(json.dumps({o: {k: round(v["mean_ms"], 4) for k, v in
                          results[o].items() if isinstance(v, dict)}
                      for o in OPT_CODES}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
