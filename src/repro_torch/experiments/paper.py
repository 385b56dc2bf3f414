"""The paper's three experimental settings on the synthetic stand-ins, and
a command line that trains one of them.

:func:`paper_setup` builds (model, data, evaluation indices, the
``train_method`` keywords) for a config of
``repro_torch.configs.paper_models``, full width or ``-smoke``:

  * ``paper-cifar-cnn``: split CIFAR-10, 100 IID clients, E 2 local steps
    of B 64 (client batch 128);
  * ``paper-femnist-cnn``: FEMNIST by writer (100 writers, style shift
    and Dir(0.2) label skew), E 5 local steps of B 64 (client batch 320);
  * ``paper-shakespeare-gru``: Shakespeare by role (100 roles), 4 local
    steps of B 10 sequences (client batch 40).

The images and sequences have the config's sizes; D_meta and the FedShare
set are 1% of the examples; the learning rates are those of the JAX
package's benchmarks (``table1_cifar.py``, ``table2_femnist.py``,
``fig4_shakespeare.py``).

    python -m repro_torch.experiments.paper --model paper-cifar-cnn-smoke \\
        --method fedmeta_uga --rounds 3 --cohort 4 --examples 2000 \\
        --device cpu

runs on the card unless ``--device`` names another, and prints each
evaluation (round, loss, accuracy, client loss) and the wall time.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import List, Optional

import numpy as np

from repro_torch.configs.paper_models import PAPER_MODELS, CNNConfig
from repro_torch.data.partition import partition_by_writer, partition_iid
from repro_torch.data.pipeline import FederatedData
from repro_torch.data.synthetic import synthetic_chars, synthetic_images
from repro_torch.experiments.common import METHODS, train_method
from repro_torch.models.model import build_paper_cnn, build_paper_gru

CLIENTS = 100


def paper_setup(name: str, *, n: int, n_eval: int = 1000, seed: int = 0):
    """(model, FederatedData, evaluation indices, train_method keywords)
    of the paper config ``name`` on ``n`` synthetic examples from
    ``seed``."""
    cfg = PAPER_MODELS[name]
    rng = np.random.default_rng(seed)
    if isinstance(cfg, CNNConfig):
        femnist = name.startswith("paper-femnist")
        skew = (dict(style_strength=1.2, label_skew_alpha=0.2, noise=0.5)
                if femnist else dict(style_strength=0.15))
        ds = synthetic_images(rng, n=n, image_size=cfg.image_size,
                              channels=cfg.in_channels,
                              num_classes=cfg.num_classes,
                              num_writers=CLIENTS, **skew)
        arrays = {"x": ds.x, "y": ds.y}
        parts = (partition_by_writer(ds.writer, list(range(CLIENTS)))
                 if femnist else partition_iid(rng, n, CLIENTS))
        kw = (dict(local_steps=5, batch=320, lr=0.002, uga_server_lr=0.02)
              if femnist else
              dict(local_steps=2, batch=128, lr=0.002, uga_server_lr=0.01))
        model = build_paper_cnn(cfg)
    else:
        ds = synthetic_chars(rng, n=n, seq_len=cfg.seq_len + 1,
                             vocab=cfg.vocab_size, num_roles=CLIENTS)
        arrays = {"tokens": ds.tokens}
        parts = partition_by_writer(ds.role, list(range(CLIENTS)))
        kw = dict(local_steps=4, batch=40, lr=0.5, uga_server_lr=1.0,
                  clip_norm=0.5, lr_decay=0.999)
        model = build_paper_gru(cfg)
    parts = [p if p.size else np.array([0]) for p in parts]
    meta = rng.choice(n, max(n // 100, 1), replace=False)
    data = FederatedData(arrays=arrays, client_indices=parts,
                         meta_indices=meta, shared_indices=meta.copy(),
                         seed=seed)
    return model, data, rng.choice(n, min(n_eval, n), replace=False), kw


def main(argv: Optional[List[str]] = None) -> List[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", required=True, choices=sorted(PAPER_MODELS))
    ap.add_argument("--method", default="fedmeta_uga",
                    choices=list(METHODS))
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--cohort", type=int, default=10)
    ap.add_argument("--examples", type=int, default=20_000)
    ap.add_argument("--eval-every", type=int, default=5)
    ap.add_argument("--strategy", default="vmap", choices=("vmap", "scan"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    model, data, eval_idx, kw = paper_setup(args.model, n=args.examples,
                                            seed=args.seed)
    t0 = time.perf_counter()
    hist = train_method(model, data, args.method, rounds=args.rounds,
                        cohort=args.cohort, eval_idx=eval_idx,
                        eval_every=args.eval_every, seed=args.seed,
                        device=args.device, cohort_strategy=args.strategy,
                        **kw)
    for h in hist:
        print(f"[paper] {json.dumps(h)}")
    print(f"[paper] {args.model} {args.method}: {args.rounds} rounds in "
          f"{time.perf_counter() - t0:.2f} s")
    return hist


if __name__ == "__main__":
    main()
