"""Client local-update strategies (PyTorch port of ``repro/core/client.py``).

Every strategy maps (loss_fn, w_t, client_batch, lr, rng) -> (G_k, loss):

  * ``uga_update``     — §3.1: keep-trace local SGD, a gradient evaluation
    on the whole client batch, then a reverse sweep of Hessian-vector
    products, so G_k is the derivative of the evaluation loss w.r.t. the
    round's INITIAL parameters w_t (unbiased aggregation, Eq. 14);
  * ``uga_update_autodiff`` — the same G_k by differentiating straight
    through the trajectory (double backward); the oracle;
  * ``fedavg_update``  — local SGD; G_k = w_t - w_k (FedProx adds the
    proximal term).

Parameters are flat dicts of tensors; all updates are out of place, so the
``torch.func`` transforms can differentiate through them.

``rng`` is the client's dropout masks for the round
(:class:`repro_torch.core.dropout.ClientMasks`) or None: local step i's
loss takes ``rng.step(i)``, wherever it is evaluated (the keep-trace
forward, the HVP sweep), and the gradient evaluation ``rng.evaluation``,
as JAX's ``fold_in(rng, i)`` and ``fold_in(rng, EVAL_FOLD)`` key them.
FedAvg's final loss runs without dropout, as in JAX.  The LM losses ignore
``rng``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch
from torch.func import grad, grad_and_value, jvp

Params = Dict[str, torch.Tensor]
LossFn = Callable[..., Tuple[torch.Tensor, Any]]


def _split_microbatches(batch: Dict[str, torch.Tensor], steps: int):
    """(b, ...) leaves -> (steps, b//steps, ...)."""
    out = {}
    for k, x in batch.items():
        b = x.shape[0]
        if b % steps:
            raise ValueError(f"client batch {b} not divisible by {steps} "
                             "steps")
        out[k] = x.reshape((steps, b // steps) + tuple(x.shape[1:]))
    return out


def _microbatch_at(mbs, i: int, steps: int):
    """Microbatch of global step ``i``, cycling the schedule over epochs."""
    return {k: x[i % steps] for k, x in mbs.items()}


def _sgd(w: Params, g: Params, lr) -> Params:
    return {k: (p.to(torch.float32) - lr * g[k].to(torch.float32)).to(p.dtype)
            for k, p in w.items()}


def _step_rng(rng, i: int):
    return None if rng is None else rng.step(i)


def _eval_rng(rng):
    return None if rng is None else rng.evaluation


def _sgd_steps(loss_fn: LossFn, w: Params, mbs, lr, rng=None, *,
               n_steps: int, prox_mu: float = 0.0,
               w_ref: Params = None) -> Params:
    steps = next(iter(mbs.values())).shape[0]

    def local_loss(wi, mb, step_rng):
        l, _ = loss_fn(wi, mb, step_rng)
        if prox_mu > 0.0 and w_ref is not None:
            sq = sum(torch.sum(torch.square(wi[k].to(torch.float32)
                                            - w_ref[k].to(torch.float32)))
                     for k in wi)
            l = l + 0.5 * prox_mu * sq
        return l

    for i in range(n_steps):
        w = _sgd(w, grad(local_loss)(w, _microbatch_at(mbs, i, steps),
                                     _step_rng(rng, i)), lr)
    return w


def uga_update(loss_fn: LossFn, w_t: Params, batch, lr, rng=None, *,
               local_steps: int = 2, local_epochs: int = 1
               ) -> Tuple[Params, torch.Tensor]:
    """Unbiased gradient aggregation client update (Algorithm 1),
    memory-optimal form:

        w_{i+1} = w_i - lr * g_i(w_i)              (forward, w_i saved)
        v_S     = grad L(w_S; D_k)                 (gradient evaluation)
        v_i     = v_{i+1} - lr * H_i(w_i) v_{i+1}  (reverse, HVP)

    Each HVP is ``torch.func.jvp`` over ``torch.func.grad``
    (forward-over-reverse): one gradient pass of memory.
    Returns (g_k fp32, eval_loss)."""
    n_kt = local_steps * local_epochs - 1
    mbs = _split_microbatches(batch, local_steps)
    eval_rng = _eval_rng(rng)

    def local_loss(w, mb, i):
        return loss_fn(w, mb, _step_rng(rng, i))[0]

    def eval_loss_fn(w):
        return loss_fn(w, batch, eval_rng)[0]

    if n_kt == 0:
        g, eval_loss = grad_and_value(eval_loss_fn)(w_t)
        return g, eval_loss

    ws = []
    w = w_t
    for i in range(n_kt):
        ws.append(w)
        w = _sgd(w, grad(local_loss)(w, _microbatch_at(mbs, i, local_steps),
                                     i), lr)

    v, eval_loss = grad_and_value(eval_loss_fn)(w)
    del w
    v = {k: x.to(torch.float32) for k, x in v.items()}

    for i in reversed(range(n_kt)):
        w_i = ws.pop()
        mb = _microbatch_at(mbs, i, local_steps)
        tangent = {k: v[k].to(p.dtype) for k, p in w_i.items()}
        _, hvp = jvp(lambda w_: grad(local_loss)(w_, mb, i), (w_i,),
                     (tangent,))
        v = {k: v[k] - lr * hvp[k].to(torch.float32) for k in v}
        del w_i, hvp, tangent
    return v, eval_loss


def uga_update_autodiff(loss_fn: LossFn, w_t: Params, batch, lr, rng=None,
                        *, local_steps: int = 2, local_epochs: int = 1
                        ) -> Tuple[Params, torch.Tensor]:
    """Reference form of UGA: reverse mode straight through the keep-trace
    trajectory (a double backward).  Same math as :func:`uga_update`."""
    n_kt = local_steps * local_epochs - 1
    mbs = _split_microbatches(batch, local_steps)

    def traced_objective(w0):
        w_k = (_sgd_steps(loss_fn, w0, mbs, lr, rng, n_steps=n_kt)
               if n_kt > 0 else w0)
        return loss_fn(w_k, batch, _eval_rng(rng))[0]

    g_k, eval_loss = grad_and_value(traced_objective)(w_t)
    return g_k, eval_loss


def fedavg_update(loss_fn: LossFn, w_t: Params, batch, lr, rng=None, *,
                  local_steps: int = 2, local_epochs: int = 1,
                  prox_mu: float = 0.0) -> Tuple[Params, torch.Tensor]:
    """Vanilla FedAvg (optionally FedProx) local update.  Returns
    (pseudo_grad = w_t - w_k, final_loss); the final loss without
    dropout."""
    mbs = _split_microbatches(batch, local_steps)
    with torch.no_grad():
        w_k = _sgd_steps(loss_fn, w_t, mbs, lr, rng, prox_mu=prox_mu,
                         w_ref=w_t, n_steps=local_steps * local_epochs)
        l, _ = loss_fn(w_k, batch, None)
    pseudo = {k: w_t[k].to(torch.float32) - w_k[k].to(torch.float32)
              for k in w_t}
    return pseudo, l


def make_client_update(algorithm: str, loss_fn: LossFn, *, local_steps: int,
                       local_epochs: int = 1, prox_mu: float = 0.0):
    """Bind a strategy: ``(w_t, batch, lr, rng) -> (G_k, client_loss)``,
    for any algorithm registered in :mod:`repro_torch.core.algorithms`
    (the built-ins and plugins)."""
    from repro_torch.core.algorithms import get_algorithm  # import cycle
    return get_algorithm(algorithm).build(
        loss_fn, local_steps=local_steps, local_epochs=local_epochs,
        prox_mu=prox_mu)
