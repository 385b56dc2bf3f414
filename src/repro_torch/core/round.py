"""One federated round (PyTorch port of the synchronous, codec-free,
fault-free arm of ``repro/core/round.py``), composed from the registries:

    local updating    (ClientAlgorithm: uga / fedavg / fedprox / fednova)
 -> aggregation       (CohortExecutor: vmap / scan -> a flat handle)
 -> server update     (ServerEngine: fused_flat)
 -> FedMeta step      (core/meta.py, Eq. 20, ``meta_mode='post'``)

``make_federated_round(model, fed)`` returns ``one_round(state,
cohort_batch, meta_batch, client_weights) -> (state, metrics)``.  The
round counter lives on the host (``state["round"]`` is an int), so the
decayed learning rates are host numbers computed in fp32 as the JAX round
computes them on the device; metrics come back as device scalars.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import FedConfig
from repro_torch.core.algorithms import get_algorithm
from repro_torch.core.engines import resolve_engine
from repro_torch.core.executors import resolve_executor
from repro_torch.core.meta import meta_update
from repro_torch.models.model import Model

State = Dict[str, Any]


def resolve_server_lr(fed: FedConfig) -> float:
    """Effective eta_g: 1.0 exactly for pseudo-gradient algorithms under a
    plain-SGD server (FedAvg averaging), ``fed.server_lr`` otherwise."""
    if not get_algorithm(fed.algorithm).pseudo_gradient \
            or fed.server_opt != "sgd":
        return fed.server_lr
    return 1.0


def init_server_state(model: Model, fed: FedConfig, *,
                      generator: Optional[torch.Generator] = None,
                      params: Optional[Dict[str, torch.Tensor]] = None
                      ) -> State:
    """Server state from given ``params`` (e.g. bridged from the JAX
    package) or from ``model.init(generator)``."""
    if params is None:
        if generator is None:
            raise ValueError("init_server_state needs params= or "
                             "generator=")
        params = model.init(generator)
    eng = resolve_engine(fed)
    return {"params": params, "opt": eng.init_state(params), "round": 0}


def decayed_lr(base: float, decay: float, round_idx: int) -> float:
    """``base * decay ** round`` in fp32, as the JAX round traces it."""
    return float(np.float32(base)
                 * np.power(np.float32(decay), np.float32(round_idx)))


def make_federated_round(model: Model, fed: FedConfig):
    alg = get_algorithm(fed.algorithm)
    client_update = alg.build(model.loss, local_steps=fed.local_steps,
                              local_epochs=fed.local_epochs,
                              prox_mu=fed.prox_mu)
    exe = resolve_executor(fed)
    eng = resolve_engine(fed)
    server_lr = resolve_server_lr(fed)

    def one_round(state: State, cohort_batch, meta_batch,
                  client_weights: torch.Tensor
                  ) -> Tuple[State, Dict[str, torch.Tensor]]:
        params = state["params"]
        r = state["round"]
        lr_c = decayed_lr(fed.client_lr, fed.lr_decay, r)
        handle, client_loss = exe.run(client_update, params, cohort_batch,
                                      client_weights, lr_c)
        new_params, opt_state, gn_post = eng.apply(params, handle,
                                                   state["opt"], lr=server_lr)
        del handle
        metrics = {"client_loss": client_loss, "grad_norm": gn_post}
        if fed.meta:
            lr_m = decayed_lr(fed.meta_lr, fed.lr_decay, r)
            new_params, meta_loss = meta_update(model.loss, new_params,
                                                meta_batch, lr_m)
            metrics["meta_loss"] = meta_loss
        return ({"params": new_params, "opt": opt_state, "round": r + 1},
                metrics)

    return one_round
