"""Where the SSD scan's time goes: its device kernels timed with one part
of their work taken out at a time.

Each variant is ``src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu`` with
one piece of code removed by a text replacement (the script stops if the
text is not found, so it follows the source or fails loudly); two more
run the same code at two blocks an SM instead of three.  Each is built
with ``nvcc`` for ``sm_90a`` into ``tools/build/ssd_ablations/``, all in
parallel, and run at the serving prefill's shape (mamba2-780m: B 8, 48
heads, one group, S 1024, P 64, N 128, chunk 256, the init's decays).  An
ablation's outputs are wrong by design; only its time means something.
The time each kernel loses when a piece goes is what that piece costs,
all else equal (a removed load takes its split and store with it: the
compiler drops what nothing reads).  Each kernel's time is the mean over
10 calls under torch.profiler, after 3 warm calls.

Run on one card from the repo's root::

    python3 tools/ssd_ablations.py

It exits non-zero without a CUDA device.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, os.path.join(ROOT, "src"))

SOURCE = os.path.join(ROOT, "src", "repro_torch", "kernels", "ssd_scan",
                      "csrc", "ssd_scan.cu")
OUT = os.path.join(HERE, "build", "ssd_ablations")

# name -> (kernel or block function whose body is edited, or None for the
# whole source; text removed; text put in its place)
VARIANTS = {
    "as committed": None,
    "out: no decay exp (exp(acum_t - acum_s) -> 1)":
        ("ssd_out_kernel", "expf(acum[tl] - acum[sl])", "1.f"),
    "out: no M (x dt) products":
        ("ssd_out_kernel",
         "      wgmma_rs_n64(part, mlo[q], xh, q > 0);\n"
         "      wgmma_rs_n64(part, mhi[q], xl, 1);\n"
         "      wgmma_rs_n64(part, mhi[q], xh, 1);\n", ""),
    "out: no x dt tiles (loads, split, store)":
        ("ssd_out_kernel", "    xt.store(Xhi, Xlo, s0, dts);\n", ""),
    "out: no carried-state term (C h)":
        ("ssd_out_kernel", "  if (u.c > 0) {\n", "  if (false) {\n"),
    "state: no products":
        ("state_block",
         "        wgmma_ss_n64(part, xl, dh, kk > 0);\n"
         "        wgmma_ss_n64(part, xh, dl, 1);\n"
         "        wgmma_ss_n64(part, xh, dh, 1);\n", ""),
    "state: no cumsum":
        ("state_block", "    if (tid == 0) {\n      float run",
         "    if (false) {\n      float run"),
    "state: no x dt / B tiles (loads, split, store)":
        ("state_block",
         "      xt.store(Xhi, Xlo, s0, dts);\n"
         "      bt.store(Bhi, Blo, s0, dte);\n", ""),
    # not ablations: the same work at two blocks an SM instead of three
    # (the register cap rises from 168 to 255 and the spills go)
    "out: two blocks an SM":
        (None, "__launch_bounds__(kThreads, 3) ssd_out_kernel",
         "__launch_bounds__(kThreads, 2) ssd_out_kernel"),
    "states and C B^T: two blocks an SM":
        (None, "__launch_bounds__(kThreads, 3)\nssd_states_cb_kernel",
         "__launch_bounds__(kThreads, 2)\nssd_states_cb_kernel"),
}


def variant_source(src: str, edit) -> str:
    if edit is None:
        return src
    kernel, old, new = edit
    if kernel is None:
        start, end = 0, len(src)
    else:
        start = src.index(f" {kernel}(")
        nxt = src.find("__global__", start)
        end = len(src) if nxt < 0 else nxt
    body = src[start:end]
    if old not in body:
        raise SystemExit(f"ssd_ablations: {kernel or 'the source'} no "
                         f"longer has {old!r}")
    return src[:start] + body.replace(old, new) + src[end:]


def build(name: str, src: str) -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    tag = "".join(c if c.isalnum() else "_" for c in name)
    cu, so = os.path.join(OUT, f"{tag}.cu"), os.path.join(OUT, f"lib{tag}.so")
    with open(cu, "w") as f:
        f.write(variant_source(src, VARIANTS[name]))
    proc = subprocess.run(
        [os.path.join(CUDA_HOME, "bin", "nvcc"), "-gencode",
         "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
         "-Xcompiler", "-fPIC", "-o", so, cu], capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"ssd_ablations: {name}: nvcc failed\n{proc.stderr}")
    return so


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("ssd_ablations: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.device import strict_fp32
    from repro_torch.kernels.ssd_scan import kernel as SK

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    strict_fp32()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader", "--id=0"],
                          capture_output=True, text=True,
                          check=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    os.makedirs(OUT, exist_ok=True)
    with open(SOURCE) as f:
        src = f.read()
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(lambda n: build(n, src),
                                           VARIANTS)))

    B, S, H, G, N, L, P = 8, 1024, 48, 1, 128, 256, 64
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((B, S, H, P), generator=gen, device=dev)
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, H), generator=gen, device=dev))
    A = -torch.linspace(1.0, 16.0, H, device=dev)
    Bm, Cm = torch.randn((2, B, S, G, N), generator=gen, device=dev)
    nc = S // L
    y = torch.empty((B, S, H, P), device=dev)
    hT = torch.empty((B, H, N, P), device=dev)
    states = torch.empty((B * H * nc, P, N), device=dev)
    acum = torch.empty((B * H * nc, L), device=dev)
    cb = torch.empty((B * G * nc, L // 64, L // 32, 64 * 32), device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    base = None
    for name, so in libs.items():
        lib = ctypes.CDLL(so)
        SK._bind(lib)

        def call():
            err = lib.ssd_forward(
                x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                Cm.data_ptr(), y.data_ptr(), hT.data_ptr(),
                states.data_ptr(), acum.data_ptr(), cb.data_ptr(), B, S, H,
                G, N, P, L, *x.stride()[:3], *dt.stride(),
                *Bm.stride()[:3], *Cm.stride()[:3], stream)
            if err:
                raise RuntimeError(f"{name}: launch failed ({err})")
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                call()
            torch.cuda.synchronize()
        times = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                k = e.name.replace("(anonymous namespace)::", "")
                k = k.replace("void ", "").split("(")[0].split("<")[0]
                times[k] = times.get(k, 0.0) + e.time_range.elapsed_us() / 10
        base = base or times
        print(f"{name}: " + "; ".join(
            f"{k} {v:.1f} us ({v - base[k]:+.1f})" for k, v in times.items())
            + f"; total {sum(times.values()):.1f} us", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
