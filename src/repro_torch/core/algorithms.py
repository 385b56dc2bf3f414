"""Client-algorithm registry (PyTorch port of ``repro/core/algorithms.py``).

A :class:`ClientAlgorithm` bundles the client-update factory with its
aggregation semantics: ``pseudo_gradient=True`` means G_k is a parameter
delta, so a plain-SGD server forces lr = 1 (see
:func:`repro_torch.core.round.resolve_server_lr`).  Built-ins: uga,
fedavg, fedprox, fednova.  A plugin registers its own with
:func:`register_algorithm` (``examples/plugins/fedagg_torch.py``; the
launcher's ``--plugin`` imports it before ``--algorithm``'s choices are
read).  ``build(loss_fn, *, local_steps, local_epochs, prox_mu)`` returns
``client_update(w_t, batch, lr, rng) -> (G_k, client_loss)``.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable

from repro_torch.core.client import fedavg_update, uga_update
from repro_torch.core.registry import Registry

__all__ = ["ClientAlgorithm", "register_algorithm", "get_algorithm",
           "available_algorithms", "fednova_update"]


@dataclasses.dataclass(frozen=True)
class ClientAlgorithm:
    name: str
    build: Callable      # (loss_fn, *, local_steps, local_epochs, prox_mu)
    pseudo_gradient: bool
    description: str = ""


_ALGORITHMS = Registry("client algorithm",
                       "repro_torch.core.algorithms.register_algorithm")


def register_algorithm(name: str, *, pseudo_gradient: bool = False,
                       description: str = ""):
    def deco(build: Callable) -> Callable:
        _ALGORITHMS.register(name, ClientAlgorithm(
            name=name, build=build, pseudo_gradient=pseudo_gradient,
            description=description or (build.__doc__ or "").strip()))
        return build
    return deco


def get_algorithm(name: str) -> ClientAlgorithm:
    return _ALGORITHMS.get(name)


def available_algorithms() -> tuple:
    return _ALGORITHMS.names()


@register_algorithm("uga", pseudo_gradient=False,
                    description="keep-trace GD + gradient evaluation "
                                "(unbiased aggregation, paper §3.1)")
def _build_uga(loss_fn, *, local_steps, local_epochs, prox_mu):
    del prox_mu
    return partial(uga_update, loss_fn, local_steps=local_steps,
                   local_epochs=local_epochs)


@register_algorithm("fedavg", pseudo_gradient=True,
                    description="local SGD, delta aggregation (biased "
                                "baseline, paper §2.1)")
def _build_fedavg(loss_fn, *, local_steps, local_epochs, prox_mu):
    del prox_mu
    return partial(fedavg_update, loss_fn, local_steps=local_steps,
                   local_epochs=local_epochs)


@register_algorithm("fedprox", pseudo_gradient=True,
                    description="fedavg + proximal term mu/2 ||w - w_t||^2 "
                                "(Li et al., 2018)")
def _build_fedprox(loss_fn, *, local_steps, local_epochs, prox_mu):
    return partial(fedavg_update, loss_fn, local_steps=local_steps,
                   local_epochs=local_epochs, prox_mu=prox_mu)


def fednova_update(loss_fn, w_t, batch, lr, rng=None, *, local_steps: int = 2,
                   local_epochs: int = 1, prox_mu: float = 0.0):
    """FedNova-style normalized averaging (Wang et al., 2020): the local
    delta divided by the client's step count tau = steps * epochs."""
    pseudo, l = fedavg_update(loss_fn, w_t, batch, lr, rng,
                              local_steps=local_steps,
                              local_epochs=local_epochs, prox_mu=prox_mu)
    tau = float(local_steps * local_epochs)
    return {k: g / tau for k, g in pseudo.items()}, l


@register_algorithm("fednova", pseudo_gradient=False,
                    description="tau_k-normalized delta averaging "
                                "(FedNova, Wang et al. 2020)")
def _build_fednova(loss_fn, *, local_steps, local_epochs, prox_mu):
    return partial(fednova_update, loss_fn, local_steps=local_steps,
                   local_epochs=local_epochs, prox_mu=prox_mu)
