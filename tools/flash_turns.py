"""Flash attention at the prefill shapes of smollm-360m (15/5 heads, D 64),
phi3-medium-14b (40/10 heads, D 128) and deepseek-v2-lite-16b (16/16
heads, Dk 192, Dv 128), B 8, S 1024, causal, timed in turns with
scaled_dot_product_attention, from the package of a given tree.  The
shapes are written here, not read from the tree's config registry, so
that a tree without those configs is timed at the same shapes.

To compare two trees on one card, unpack the other into a directory that
``.gitignore`` lists and run the script once per tree in turns, from the
repo's root::

    git archive <commit> | tar -x -C build/parent
    for r in build/parent . . build/parent; do
        python3 tools/flash_turns.py --root $r
    done

Each run builds that tree's flash kernel, calls it as the prefill does
(``ops.flash_attention`` on the model's (B, S, H, D) tensors), and times
it and SDPA (k, v repeated to H heads) in turns (a, b, b, a; CUDA events,
20 calls a timing, each after 20 warm calls).  It prints the card's name
and power limit, then one JSON line per shape; a shape whose form the
tree's kernel is not built for gets a line saying so.  Exits non-zero
without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

SHAPES = {"smollm-360m": (15, 5, 64, 64),
          "phi3-medium-14b": (40, 10, 128, 128),
          "deepseek-v2-lite-16b": (16, 16, 192, 128)}


def cuda_ms(fn, iters: int) -> float:
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=".", help="the tree whose package "
                    "(src/repro_torch) is timed")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, os.path.join(root, "src"))
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("flash_turns: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.device import strict_fp32
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention import kernel as FK

    strict_fp32()
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader", "--id=0"], check=True,
                          capture_output=True, text=True).stdout.strip()
    print(card)
    FK.LIB.build(True)
    gen = torch.Generator(device=dev).manual_seed(14)
    for model, (H, Hkv, Dk, Dv) in SHAPES.items():
        q = torch.randn((8, 1024, H, Dk), generator=gen, device=dev)
        k = torch.randn((8, 1024, Hkv, Dk), generator=gen, device=dev)
        v = torch.randn((8, 1024, Hkv, Dv), generator=gen, device=dev)
        kr, vr = (t.repeat_interleave(H // Hkv, dim=2).transpose(1, 2)
                  for t in (k, v))

        def fa():
            return flash_attention(q, k, v, causal=True)

        def sdpa():
            return F.scaled_dot_product_attention(q.transpose(1, 2), kr, vr,
                                                  is_causal=True)

        try:
            fa()
        except (NotImplementedError, ValueError) as e:
            print(json.dumps({"root": args.root, "model": model,
                              "not_built": str(e)}))
            continue
        cuda_ms(fa, 20), cuda_ms(sdpa, 20)
        a1, b1 = cuda_ms(fa, 20), cuda_ms(sdpa, 20)
        b2, a2 = cuda_ms(sdpa, 20), cuda_ms(fa, 20)
        print(json.dumps({"root": args.root, "model": model,
                          "heads": f"{H}/{Hkv}", "Dk": Dk, "Dv": Dv,
                          "ms": (a1 + a2) / 2, "ms_each": [a1, a2],
                          "sdpa_ms": (b1 + b2) / 2, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
