"""FedMeta — controllable meta updating (§3.2; PyTorch port of
``repro/core/meta.py``).

Two meta modes:

  * :func:`meta_update` (``meta_mode='post'``, the paper's Eq. 20): after
    aggregation the server takes one gradient step on the curated meta set
    D_meta.
  * ``meta_mode='through_aggregation'``: differentiate the D_meta loss
    *through* the Eq. (14) aggregation and the server optimizer — the
    fused engine's backward kernels — into hypergradients w.r.t. the
    per-client weight logits and the log server step size, held in
    ``state["ctrl"] = {"w_logits": (cohort,), "log_lr": ()}`` and stepped
    by SGD with ``ctrl_lr`` once a round.

The round uses :func:`meta_update_through_cohort`, which differentiates
through any :class:`repro_torch.core.executors.ReweightableCohort` and any
engine declaring the ``through_aggregation`` capability.
:func:`meta_update_through_aggregation` (over a given gradient stack) and
:func:`meta_update_through_aggregation_scan` (over a streamed cohort) are
the strategy-specific reference forms.

The objective is differentiated with :func:`torch.autograd.grad` w.r.t.
the two ctrl leaves only.  The client gradients are constants of it: the
vmap cohort computes them before the objective, the scan cohort inside a
``torch.autograd.Function`` whose backward re-runs each client without a
graph through ``client_update``.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
from torch.func import grad_and_value

from repro_torch.core.aggregate import scan_cohort_gradient_flat
from repro_torch.core.flat import make_flat_spec
from repro_torch.kernels.fused_update.ops import (fused_apply_flat,
                                                  fused_server_update)

Ctrl = Dict[str, torch.Tensor]


def meta_update(loss_fn: Callable, params, meta_batch, meta_lr, rng=None
                ) -> Tuple[dict, torch.Tensor]:
    """w <- w - eta_meta * grad L(w; D_meta).  Returns (params, meta_loss)."""

    def obj(w):
        return loss_fn(w, meta_batch, rng)[0]

    g, meta_loss = grad_and_value(obj)(params)
    new = {k: (p.to(torch.float32) - meta_lr * g[k].to(torch.float32)
               ).to(p.dtype) for k, p in params.items()}
    return new, meta_loss


def _ctrl_step(objective: Callable, ctrl: Ctrl, ctrl_lr):
    """Evaluate ``objective(w_logits, log_lr) -> (meta_loss, aux)`` with
    grad w.r.t. the two ctrl leaves, and take one SGD step on them.
    Returns (aux with every tensor detached, new_ctrl, metrics)."""
    w_logits = ctrl["w_logits"].detach().requires_grad_(True)
    log_lr = ctrl["log_lr"].detach().requires_grad_(True)
    with torch.enable_grad():
        meta_loss, aux = objective(w_logits, log_lr)
    d_wl, d_llr = torch.autograd.grad(meta_loss, (w_logits, log_lr))
    new_ctrl = {"w_logits": ctrl["w_logits"] - ctrl_lr * d_wl,
                "log_lr": ctrl["log_lr"] - ctrl_lr * d_llr}
    metrics = {"meta_loss": meta_loss.detach(),
               "ctrl_w_gnorm": torch.sqrt(torch.sum(d_wl * d_wl)),
               "ctrl_lr_grad": d_llr,
               "server_lr_eff": torch.exp(ctrl["log_lr"])}
    return _detach(aux), new_ctrl, metrics


def _detach(x):
    if isinstance(x, torch.Tensor):
        return x.detach()
    if isinstance(x, dict):
        return {k: _detach(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_detach(v) for v in x)
    return x


def meta_update_through_cohort(loss_fn: Callable, reweightable,
                               client_weights: torch.Tensor, params,
                               opt_state, meta_batch, ctrl: Ctrl, *, engine,
                               ctrl_lr, rng=None):
    """Controllable aggregation over any executor and engine.

    ``reweightable.aggregate(weights)`` re-runs Eq. (14) under new weights
    (differentiably); ``engine`` declares ``through_aggregation``.  The
    objective takes this round's server step under eff_w = n_k *
    exp(w_logits) and step size exp(log_lr); one SGD step with ``ctrl_lr``
    on the D_meta-loss hypergradients updates ``ctrl``.

    Returns (new_params, new_opt_state, grad_norm_after_clip, client_loss,
    new_ctrl, metrics)."""

    def objective(w_logits, log_lr):
        eff_w = client_weights.to(torch.float32) * torch.exp(w_logits)
        handle, client_loss = reweightable.aggregate(eff_w)
        new_p, new_opt, gn = engine.apply(params, handle, opt_state,
                                          lr=torch.exp(log_lr))
        return (loss_fn(new_p, meta_batch, rng)[0],
                (new_p, new_opt, gn, client_loss))

    (new_p, new_opt, gn, client_loss), new_ctrl, metrics = _ctrl_step(
        objective, ctrl, ctrl_lr)
    return new_p, new_opt, gn, client_loss, new_ctrl, metrics


def meta_update_through_aggregation(loss_fn: Callable, params, grad_stack,
                                    client_weights: torch.Tensor, opt_state,
                                    meta_batch, ctrl: Ctrl, *, opt: str,
                                    clip_norm: float, momentum: float,
                                    ctrl_lr, rng=None):
    """Reference form over a given stack of per-client gradients
    (``params``' names, a leading cohort axis): the fused server step under
    the controllable weights and step size, and the ctrl update by the
    hypergradient of the D_meta loss through it.  Returns (new_params,
    new_opt_state, grad_norm_after_clip, new_ctrl, metrics)."""

    def objective(w_logits, log_lr):
        eff_w = client_weights.to(torch.float32) * torch.exp(w_logits)
        new_p, new_opt, gn = fused_server_update(
            params, grad_stack, eff_w, opt_state, opt=opt,
            lr=torch.exp(log_lr), clip_norm=clip_norm, momentum=momentum)
        return loss_fn(new_p, meta_batch, rng)[0], (new_p, new_opt, gn)

    (new_p, new_opt, gn), new_ctrl, metrics = _ctrl_step(objective, ctrl,
                                                         ctrl_lr)
    return new_p, new_opt, gn, new_ctrl, metrics


def meta_update_through_aggregation_scan(loss_fn: Callable,
                                         client_update: Callable, params,
                                         cohort_batch,
                                         client_weights: torch.Tensor,
                                         client_lr, opt_state, meta_batch,
                                         ctrl: Ctrl, *, opt: str,
                                         clip_norm: float, momentum: float,
                                         ctrl_lr, rng=None):
    """Reference form under the client-sequential cohort: the clients
    stream through the accumulate kernel and are re-run once in the
    backward; no gradient stack exists.  ``client_loss`` is weighted by
    the raw n_k.  Returns (new_params, new_opt_state, grad_norm_after_clip,
    client_loss, new_ctrl, metrics)."""
    spec = make_flat_spec(params)

    def objective(w_logits, log_lr):
        eff_w = client_weights.to(torch.float32) * torch.exp(w_logits)
        G_groups, client_loss = scan_cohort_gradient_flat(
            client_update, params, cohort_batch, eff_w, client_lr,
            spec=spec, loss_weights=client_weights)
        new_p, new_opt, gn = fused_apply_flat(
            params, G_groups, opt_state, opt=opt, lr=torch.exp(log_lr),
            clip_norm=clip_norm, momentum=momentum, spec=spec)
        return (loss_fn(new_p, meta_batch, rng)[0],
                (new_p, new_opt, gn, client_loss))

    (new_p, new_opt, gn, client_loss), new_ctrl, metrics = _ctrl_step(
        objective, ctrl, ctrl_lr)
    return new_p, new_opt, gn, client_loss, new_ctrl, metrics
