"""The paper's six-method training loop, PyTorch port of the training half
of ``benchmarks/common.py``.

A paper table or figure builds a (model, FederatedData) pair and calls
:func:`run_methods` with the method grid of the paper:

  FedAvg | FedProx | FedShare | UGA | FedMeta | FedMeta w/ UGA

``train_method`` maps a method onto a :class:`FedConfig` with the JAX
package's defaults, trains through :class:`FederatedTrainer` — the fused
engine and 4 rounds a call by default, as the JAX paper tables run;
``fused=False, rounds_per_call=1`` is the legacy tree engine's exact
round-by-round loop — and evaluates on held-out examples after each call
that reaches a multiple of ``eval_every`` or the last round, so under K
rounds a call the evaluations land on call boundaries, as in JAX.  Metric
trackers are ROADMAP Queue 1 item 8 and raise ``NotImplementedError``
naming it; so do the JAX file's report writers (``bench_tracker``,
``write_bench_report``, ``peak_memory_bytes``), which are not ported.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import FedConfig
from repro_torch.core.trainer import FederatedTrainer, batch_to_device
from repro_torch.data.pipeline import FederatedData

__all__ = ["METHODS", "evaluate", "train_method", "rounds_to_accuracy",
           "run_methods"]

# method name -> FedConfig kwargs (the paper's comparison grid)
METHODS = {
    "fedavg": dict(algorithm="fedavg", meta=False, share=False),
    "fedprox": dict(algorithm="fedprox", meta=False, share=False),
    "fedshare": dict(algorithm="fedavg", meta=False, share=True),
    "uga": dict(algorithm="uga", meta=False, share=False),
    "fedmeta": dict(algorithm="fedavg", meta=True, share=False),
    "fedmeta_uga": dict(algorithm="uga", meta=True, share=False),
}


@torch.no_grad()
def evaluate(model, params, data: FederatedData, idx: np.ndarray,
             batch: int = 256) -> Dict[str, float]:
    """Example-weighted mean loss and accuracy over ``idx``, without
    dropout, on the device of ``params``."""
    device = next(iter(params.values())).device
    accs, losses, ns = [], [], []
    for b in data.eval_batches(idx, batch):
        l, m = model.loss(params, batch_to_device(b, device))
        n = len(next(iter(b.values())))
        losses.append(float(l) * n)
        accs.append(float(m.get("acc", float("nan"))) * n)
        ns.append(n)
    n = sum(ns)
    return {"loss": sum(losses) / n, "acc": sum(accs) / n}


def train_method(model, data: FederatedData, method: str, *, rounds: int,
                 cohort: int, batch: int, local_steps: int, lr: float,
                 eval_idx: np.ndarray, eval_every: int = 5, seed: int = 0,
                 lr_decay: float = 0.996, meta_batch: int = 32,
                 prox_mu: float = 2e-4, uga_server_lr: Optional[float] = None,
                 clip_norm: float = 2.0, fused: bool = True,
                 rounds_per_call: int = 4, tracker=None, device=None,
                 params: Optional[Dict[str, torch.Tensor]] = None,
                 cohort_strategy: str = "vmap",
                 on_records: Optional[Callable] = None
                 ) -> List[Dict[str, float]]:
    """Train one method of :data:`METHODS`; returns its evaluation history,
    ``[{"round", "loss", "acc", "client_loss"}, ...]``.

    ``uga_server_lr``: eta_g of the UGA variants, by default
    ``2 * local_steps * lr``, so that one unbiased server step moves about
    as far a round as FedAvg's ``local_steps`` biased ones.  ``clip_norm``
    tames the HVP amplification the paper notes in §4.5.1.  ``params``:
    the initial parameters (e.g. bridged from the JAX package), else
    ``model.init`` from ``seed``; ``device``: as every entry point's, the
    card unless the caller names another.  ``fused``: the fused flat
    engine, else ``legacy_tree``; ``rounds_per_call``: the trainer's K, the
    evaluations on call boundaries.  ``cohort_strategy``: the vmap or scan
    cohort; ``on_records(recs, trainer)``: called after every call, after
    its evaluation."""
    if tracker is not None:
        raise NotImplementedError(
            "train_method(tracker=...): metric trackers are not yet ported "
            "to repro_torch (ROADMAP Queue 1 item 8)")
    kw = METHODS[method]
    if uga_server_lr is None:
        uga_server_lr = 2 * local_steps * lr
    fed = FedConfig(algorithm=kw["algorithm"], meta=kw["meta"],
                    share=kw["share"], cohort=cohort,
                    local_steps=local_steps, client_lr=lr,
                    server_lr=uga_server_lr, meta_lr=lr, lr_decay=lr_decay,
                    prox_mu=prox_mu, clip_norm=clip_norm, fused_update=fused,
                    cohort_strategy=cohort_strategy)
    trainer = FederatedTrainer(model, fed, rounds_per_call=rounds_per_call,
                               seed=seed, device=device, params=params)

    def sample_meta(d, r, mb_size, sample):
        if not kw["meta"]:
            return None
        return (d.sample_meta(r, mb_size) if d.meta_indices is not None
                else {k: v[:mb_size]
                      for k, v in sample["cohort_batch"].items()})

    history = []

    def evaluate_some(recs, tr):
        if any(rec["round"] % eval_every == 0 or rec["round"] == rounds - 1
               for rec in recs):
            ev = evaluate(model, tr.state["params"], data, eval_idx)
            history.append({"round": recs[-1]["round"], **ev,
                            "client_loss": recs[-1]["client_loss"]})
        if on_records is not None:
            on_records(recs, tr)

    trainer.run(data, rounds=rounds, cohort=cohort, batch=batch,
                meta_batch=meta_batch, share=kw["share"],
                sample_meta=sample_meta, on_records=evaluate_some)
    trainer.finish()
    return history


def rounds_to_accuracy(history: Sequence[Dict], target: float
                       ) -> Optional[int]:
    """The first evaluated round whose accuracy reaches ``target``."""
    for h in history:
        if h["acc"] >= target:
            return h["round"]
    return None


def run_methods(model, data, *, methods: Sequence[str], rounds: int,
                cohort: int, batch: int, local_steps: int, lr: float,
                eval_idx: np.ndarray, seed: int = 0, **kw
                ) -> Dict[str, List[Dict]]:
    """:func:`train_method` for each method in turn; ``out[m]`` its history,
    ``out[m + "__wall_s"]`` its wall seconds."""
    out = {}
    for m in methods:
        t0 = time.time()
        out[m] = train_method(model, data, m, rounds=rounds, cohort=cohort,
                              batch=batch, local_steps=local_steps, lr=lr,
                              eval_idx=eval_idx, seed=seed, **kw)
        out[m + "__wall_s"] = time.time() - t0
    return out
