"""Serving entry point of the PyTorch port (mirrors
``repro/launch/serve.py``): batched prefill, then greedy (or temperature)
decode.

Runs on one CUDA device — the prefill's attention through the
flash-attention kernel (GQA or MLA self-attention, and the encoder's and
the cross layers' non-causal attention), its mamba layers through the
SSD-scan kernel — and on the CPU with ``--device cpu``, where the
kernels' plain versions run.  Every registered config serves; ``--window``
gives GQA self-attention a ring-buffer cache (MLA writes its latent cache
at the clamped index, as JAX does).  Weights are random from ``--seed``;
prompts, then an encoder config's frame or patch embeddings (``enc_len``
of ``enc_dim``, unit normal), are drawn with numpy from the same seed:
the JAX launcher's inputs.  ``--ckpt`` restores the parameters from a
bare-params blob (``repro_torch.checkpoint.save(path, params)``, or the
JAX package's ``repro.checkpoint.save``) in place of the random ones.

  python -m repro_torch.launch.serve --arch smollm-360m-smoke \\
      --batch 2 --prompt-len 40 --gen 8 --device cpu [--window 16]
  python -m repro_torch.launch.serve --arch mamba2-780m \\
      --batch 8 --prompt-len 1024 --gen 32
  python -m repro_torch.launch.serve --arch deepseek-v2-lite-16b \\
      --batch 8 --prompt-len 1024 --gen 32
  python -m repro_torch.launch.serve --arch whisper-large-v3 \\
      --batch 8 --prompt-len 416 --gen 32
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint import restore as ckpt_restore
from repro_torch.configs import get_arch
from repro_torch.device import resolve_device, strict_fp32
from repro_torch.models.model import build_model


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def generate(model, params, prompts: torch.Tensor, *, gen_len: int,
             cache_len: int, temperature: float = 0.0, seed: int = 0,
             enc_embeds: Optional[torch.Tensor] = None):
    """prompts: (B, P) int; ``enc_embeds`` (B, L, enc_dim), the encoder's
    input where the config has one.  Greedy decoding by argmax, or
    sampling at ``temperature`` from a ``torch.Generator`` seeded with
    ``seed`` (its stream is not JAX's).  Returns (tokens (B, gen_len),
    stats): the decode wall and tokens per second of the JAX launcher, and
    the synchronized prefill wall."""
    B = prompts.shape[0]
    dev = prompts.device
    gen = torch.Generator(device=dev).manual_seed(seed)

    def pick(logits):
        if temperature == 0.0:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0]

    with torch.inference_mode():
        _sync(dev)
        t0 = time.time()
        batch = {"tokens": prompts}
        if enc_embeds is not None:
            batch["enc_embeds"] = enc_embeds
        logits, cache = model.prefill(params, batch, cache_len=cache_len)
        tok = pick(logits)
        _sync(dev)
        prefill_s = time.time() - t0
        out = [tok]
        t0 = time.time()
        for _ in range(gen_len - 1):
            logits, cache = model.decode(params, tok, cache)
            tok = pick(logits)
            out.append(tok)
        toks = torch.stack(out, dim=1)                     # (B, gen_len)
        _sync(dev)
        dt = time.time() - t0
    return toks, {"prefill_s": prefill_s, "decode_s": dt,
                  "tok_per_s": B * max(gen_len - 1, 1) / max(dt, 1e-9)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--window", type=int, default=0)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    strict_fp32()
    cfg = get_arch(args.arch)
    model = build_model(cfg, dtype=torch.float32, decode_window=args.window)
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed))
    if args.ckpt:
        # bare parameters, as the JAX launcher restores them
        params, extra = ckpt_restore(args.ckpt, params)
        print(f"[serve] restored {args.ckpt} ({extra})")
    rng = np.random.default_rng(args.seed)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len))).to(dev)
    enc = None
    if cfg.encoder is not None:
        e = cfg.encoder
        enc = torch.from_numpy(rng.normal(
            0, 1, (args.batch, e.enc_len, e.enc_dim)).astype(np.float32)
        ).to(dev)
    cache_len = (args.window if args.window
                 else args.prompt_len + args.gen + 1)
    toks, stats = generate(model, params, prompts, gen_len=args.gen,
                           cache_len=cache_len, temperature=args.temperature,
                           seed=args.seed, enc_embeds=enc)
    print(f"[serve] generated {tuple(toks.shape)} tokens: "
          f"{stats['tok_per_s']:.1f} tok/s (decode {stats['decode_s']:.2f}s)")
    print("[serve] sample:", toks[0, :16].tolist())
    return toks, stats


if __name__ == "__main__":
    main()
