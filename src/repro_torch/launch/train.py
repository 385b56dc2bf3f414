"""End-to-end federated training driver of the PyTorch port (mirrors
``repro/launch/train.py``, with the flags the port implements).

Runs real federated rounds — host data pipeline, UGA/FedAvg clients,
fused flat server update on the CUDA kernels, FedMeta step — on one CUDA
device (``--device cpu`` runs the kernels' plain versions on the CPU).

  python -m repro_torch.launch.train --arch smollm-360m --fused \\
      --algorithm uga --meta --rounds 3 --cohort 4 --client-batch 8 \\
      --seq 128 [--strategy scan] [--server-opt adam]
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs import FedConfig, get_arch
from repro_torch.configs.base import ALGORITHMS, SERVER_OPTS, STRATEGIES
from repro_torch.core.trainer import FederatedTrainer
from repro_torch.data.partition import partition_iid
from repro_torch.data.pipeline import FederatedData
from repro_torch.data.synthetic import synthetic_tokens
from repro_torch.device import resolve_device, strict_fp32
from repro_torch.models.model import build_model


def build_synthetic_fed_data(cfg, *, num_clients: int, examples: int,
                             seq: int, iid: bool, seed: int = 0,
                             meta_fraction: float = 0.01) -> FederatedData:
    """Byte-identical to the JAX package's synthetic federated data for
    the same arguments."""
    rng = np.random.default_rng(seed)
    ds = synthetic_tokens(rng, n=examples, seq_len=seq + 1,
                          vocab=cfg.vocab_size, num_clients=num_clients)
    arrays = {"tokens": ds.tokens}
    if iid:
        parts = partition_iid(rng, examples, num_clients)
    else:
        parts = [np.where(ds.role == c)[0] for c in range(num_clients)]
        parts = [p if p.size else np.array([0]) for p in parts]
    n_meta = max(int(examples * meta_fraction), 8)
    meta_idx = rng.choice(examples, n_meta, replace=False)
    shared_idx = rng.choice(examples, n_meta, replace=False)
    return FederatedData(arrays=arrays, client_indices=parts,
                         meta_indices=meta_idx, shared_indices=shared_idx,
                         seed=seed)


def run_training(arch: str, *, rounds: int, cohort: int, client_batch: int,
                 seq: int, algorithm: str = "uga", meta: bool = True,
                 share: bool = False, local_steps: int = 2,
                 local_epochs: int = 1, client_lr: float = 0.01,
                 server_lr: Optional[float] = None,
                 meta_lr: Optional[float] = None, server_opt: str = "sgd",
                 num_clients: int = 32, examples: int = 2048,
                 iid: bool = False, seed: int = 0, log_every: int = 10,
                 strategy: str = "vmap", fused: bool = False,
                 device=None, params=None,
                 on_records: Optional[Callable] = None):
    """Assemble (model, FedConfig, FederatedData) and train.  ``params``
    starts from given parameters instead of a seeded init; ``on_records``
    is the trainer's per-round hook.  Returns (state, history)."""
    dev = resolve_device(device)
    strict_fp32()
    cfg = get_arch(arch)
    model = build_model(cfg, dtype=torch.float32, loss_chunk=256)
    fed = FedConfig(
        algorithm=algorithm, meta=meta, share=share, cohort=cohort,
        local_steps=local_steps, local_epochs=local_epochs,
        client_lr=client_lr,
        server_lr=server_lr if server_lr is not None else client_lr,
        meta_lr=meta_lr if meta_lr is not None else client_lr,
        server_opt=server_opt, cohort_strategy=strategy, lr_decay=0.992,
        fused_update=fused)
    data = build_synthetic_fed_data(cfg, num_clients=num_clients,
                                    examples=examples, seq=seq, iid=iid,
                                    seed=seed)
    trainer = FederatedTrainer(model, fed, seed=seed, device=dev,
                               params=params)
    meta_bs = min(client_batch * 2, 32)
    history = trainer.run(data, rounds=rounds, cohort=cohort,
                          batch=client_batch, meta_batch=meta_bs,
                          share=share, log_every=log_every,
                          on_records=on_records)
    return trainer.state, history


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--rounds", type=int, default=50)
    ap.add_argument("--cohort", type=int, default=4)
    ap.add_argument("--client-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--algorithm", default="uga", choices=ALGORITHMS)
    ap.add_argument("--meta", action="store_true")
    ap.add_argument("--no-meta", dest="meta", action="store_false")
    ap.set_defaults(meta=True)
    ap.add_argument("--share", action="store_true")
    ap.add_argument("--local-steps", type=int, default=2)
    ap.add_argument("--local-epochs", type=int, default=1)
    ap.add_argument("--client-lr", type=float, default=0.01)
    ap.add_argument("--server-lr", type=float, default=None,
                    help="eta_g (default: --client-lr)")
    ap.add_argument("--meta-lr", type=float, default=None,
                    help="eta_meta (default: --client-lr)")
    ap.add_argument("--server-opt", default="sgd", choices=SERVER_OPTS)
    ap.add_argument("--strategy", default="vmap", choices=STRATEGIES,
                    help="cohort executor: client-parallel stack (vmap) or "
                         "client-sequential streaming (scan)")
    ap.add_argument("--fused", action="store_true",
                    help="fused flat-buffer CUDA server engine (the only "
                         "engine ported so far; required)")
    ap.add_argument("--num-clients", type=int, default=32)
    ap.add_argument("--examples", type=int, default=2048)
    ap.add_argument("--iid", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    ap.add_argument("--history-out", default=None)
    args = ap.parse_args(argv)
    _, history = run_training(
        args.arch, rounds=args.rounds, cohort=args.cohort,
        client_batch=args.client_batch, seq=args.seq,
        algorithm=args.algorithm, meta=args.meta, share=args.share,
        local_steps=args.local_steps, local_epochs=args.local_epochs,
        client_lr=args.client_lr, server_lr=args.server_lr,
        meta_lr=args.meta_lr, server_opt=args.server_opt,
        num_clients=args.num_clients, examples=args.examples, iid=args.iid,
        seed=args.seed, log_every=args.log_every, strategy=args.strategy,
        fused=args.fused, device=args.device)
    if args.history_out:
        os.makedirs(os.path.dirname(os.path.abspath(args.history_out)),
                    exist_ok=True)
        with open(args.history_out, "w") as f:
            json.dump(history, f, indent=1)


if __name__ == "__main__":
    main()
