"""Unbiased weighted aggregation over the cohort (Eq. 14) — PyTorch port of
the two forward arms of ``repro/core/aggregate.py`` that the fused engine
runs:

  * :func:`cohort_gradient_stacked` — the vmap (client-parallel) arm with
    ``aggregate=False``: every client's flat gradient lands in its slot of
    a preallocated ``(cohort, rows, 128)`` stack, for the aggregate kernel
    to reduce.  The clients run one after another (the JAX package vmaps
    them); filling the stack slot by slot keeps one client's tree alive at
    a time instead of stacking a list, which would double peak memory.
  * :func:`scan_cohort_gradient_flat` — the client-sequential (scan) arm:
    each client's flat gradient streams into the group accumulators with
    the accumulate kernel, ``acc <- acc + w_k g_k`` in place, so only one
    client's gradient exists at a time.  Weights are normalized once
    outside the loop, as the JAX chunked core does.  It is differentiable
    in the weights (``meta_mode='through_aggregation'``) and keeps the
    scan's memory property there too: the backward re-runs each client's
    update and feeds its gradient to the accumulate backward kernel, one
    client at a time — JAX's ``jax.checkpoint`` of the scan body.

:func:`scan_cohort_deltas_flat` is the scan arm of the buffered-async
runtime: it keeps each client's flat delta instead of accumulating it,
writing it where the caller says (a slot of the delta pool), so no
``(cohort, rows, 128)`` stack is made.

Each arm has a coded form for a lossy uplink codec (``meta_mode='post'``
only): :func:`cohort_gradient_stacked_coded` runs the codec stage over the
filled stack, :func:`scan_cohort_gradient_coded` as each client's gradient
arrives; both accumulate with the codec's decode instead of the aggregate
or accumulate kernel.

Every arm takes ``rngs``: one client's dropout masks per cohort slot
(:class:`repro_torch.core.dropout.ClientMasks`), handed to client k's
update wherever it runs (the scan backward's re-run too), or None.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.comm.transport import (client_coded_accumulate,
                                        coded_aggregate_stacked)
from repro_torch.core import flat as flat_mod
from repro_torch.core.flat import LANES, FlatSpec
from repro_torch.kernels.fused_update import kernel as K
from repro_torch.kernels.fused_update.ops import flat_accumulate


def _client_batch(cohort_batch: Dict[str, torch.Tensor], k: int):
    return {name: x[k] for name, x in cohort_batch.items()}


def _client_rng(rngs, k: int):
    return None if rngs is None else rngs[k]


def _run_stacked(client_update: Callable, w_t, cohort_batch, lr,
                 cohort: int, spec: FlatSpec, device, rngs=None
                 ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Run every client into its slot of preallocated (cohort, rows, 128)
    stacks; returns (the stacks, the per-client losses)."""
    stacks = [torch.empty((cohort, g.rows, LANES), dtype=torch.float32,
                          device=device) for g in spec.groups]
    losses = []
    for k in range(cohort):
        g_k, l_k = client_update(w_t, _client_batch(cohort_batch, k), lr,
                                 _client_rng(rngs, k))
        flat_mod.flatten_tree(spec, g_k, out=[s[k] for s in stacks])
        losses.append(l_k)
        del g_k
    return stacks, losses


def cohort_gradient_stacked(client_update: Callable, w_t, cohort_batch,
                            client_weights: torch.Tensor, lr, *,
                            spec: FlatSpec, rngs=None
                            ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Run every client; returns (per-group (cohort, rows, 128) gradient
    stacks, n_k-weighted mean client loss)."""
    stacks, losses = _run_stacked(client_update, w_t, cohort_batch, lr,
                                  client_weights.shape[0], spec,
                                  client_weights.device, rngs)
    w32 = client_weights.to(torch.float32)
    wsum = torch.clamp(torch.sum(w32), min=1e-30)
    mean_loss = torch.sum(torch.stack(losses) * w32) / wsum
    return stacks, mean_loss


def cohort_gradient_stacked_coded(client_update: Callable, w_t,
                                  cohort_batch, client_weights: torch.Tensor,
                                  lr, *, spec: FlatSpec, codec,
                                  residuals: Optional[tuple] = None,
                                  rngs=None
                                  ) -> Tuple[List[torch.Tensor], torch.Tensor,
                                             Optional[tuple]]:
    """The vmap cohort with a lossy uplink codec: every client's gradient
    fills its stack slot, then :func:`repro_torch.comm.transport.
    coded_aggregate_stacked` runs each client's uplink in cohort order — the
    JAX chunked core at chunk = cohort, which also fixes the loss: weighted
    by the normalized aggregation weights, accumulated in client order.
    ``residuals`` (per-group (cohort, rows, 128) error-feedback stacks) are
    updated in place.  Returns (G_groups, mean_loss, residuals)."""
    stacks, losses = _run_stacked(client_update, w_t, cohort_batch, lr,
                                  client_weights.shape[0], spec,
                                  client_weights.device, rngs)
    G, new_res = coded_aggregate_stacked(codec, spec, stacks,
                                         client_weights, residuals)
    del stacks
    w32 = client_weights.to(torch.float32)
    wn = w32 / torch.clamp(torch.sum(w32), min=1e-30)
    return G, _loss_in_client_order(wn, losses), new_res


def _loss_in_client_order(wn: torch.Tensor, losses) -> torch.Tensor:
    l_acc = torch.zeros((), dtype=torch.float32, device=wn.device)
    for k in range(wn.shape[0]):
        l_acc = l_acc + wn[k] * losses[k]
    return l_acc


class _ScanCohort(torch.autograd.Function):
    """wn (cohort,) normalized weights -> (G_groups..., per-client losses).

    The forward streams the clients (``acc <- acc + wn_k g_k`` in place)
    and keeps no gradient.  The backward re-runs client k's update — same
    batch, same ``lr`` — and calls the accumulate backward kernel on it,
    ``dwn_k = sum over groups <g_k, dG>``, so one client's gradient is
    alive at a time in both directions; the stack the vmap cohort keeps
    (cohort x the model) never exists.  The losses are outputs without a
    gradient: the caller weights them by the raw n_k."""

    @staticmethod
    def forward(ctx, wn, client_update, w_t, cohort_batch, lr, spec, rngs):
        ctx.args = (client_update, w_t, cohort_batch, lr, spec, rngs)
        ctx.save_for_backward(wn)
        cohort = wn.shape[0]
        accs = flat_mod.zeros_flat(spec, wn.device)
        scratch = [torch.empty_like(a) for a in accs]
        losses = []
        for k in range(cohort):
            g_k, l_k = client_update(w_t, _client_batch(cohort_batch, k),
                                     lr, _client_rng(rngs, k))
            g_bufs = flat_mod.flatten_tree(spec, g_k, out=scratch)
            del g_k
            for acc, g in zip(accs, g_bufs):
                flat_accumulate(acc, g, wn[k:k + 1], out=acc)
            losses.append(l_k.to(torch.float32))
        losses = torch.stack(losses)
        ctx.mark_non_differentiable(losses)
        return (*accs, losses)

    @staticmethod
    def backward(ctx, *cts):
        client_update, w_t, cohort_batch, lr, spec, rngs = ctx.args
        (wn,) = ctx.saved_tensors
        dGs = [d.contiguous() for d in cts[:-1]]
        scratch = [torch.empty_like(d) for d in dGs]
        dwn = []
        for k in range(wn.shape[0]):
            g_k, _ = client_update(w_t, _client_batch(cohort_batch, k), lr,
                                   _client_rng(rngs, k))
            g_bufs = flat_mod.flatten_tree(spec, g_k, out=scratch)
            del g_k
            dw = None
            for g, dG in zip(g_bufs, dGs):
                _, dw_j = K.accumulate_pass_bwd(g, wn[k:k + 1], dG)
                dw = dw_j if dw is None else dw + dw_j
            dwn.append(dw)
        return torch.stack(dwn), None, None, None, None, None, None


def scan_cohort_gradient_flat(client_update: Callable, w_t, cohort_batch,
                              client_weights: torch.Tensor, lr, *,
                              spec: FlatSpec,
                              loss_weights: Optional[torch.Tensor] = None,
                              rngs=None
                              ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Client-sequential cohort fused into the flat engine.  Returns
    (G_groups, mean_loss): the Eq. (14) weighted-mean flat buffers and the
    weighted mean client loss, accumulated in client order.

    Differentiable in ``client_weights`` (see :class:`_ScanCohort`).
    ``loss_weights`` (default: ``client_weights``) weights the loss metric
    apart from the aggregation: through_aggregation aggregates with the
    controllable eff_w but reports the n_k-weighted loss, so the metric
    means the same on every strategy."""
    w32 = client_weights.to(torch.float32)
    wn = w32 / torch.clamp(torch.sum(w32), min=1e-30)
    if loss_weights is None:
        lwn = wn.detach()
    else:
        lw32 = loss_weights.to(torch.float32)
        lwn = lw32 / torch.clamp(torch.sum(lw32), min=1e-30)
    *accs, losses = _ScanCohort.apply(wn, client_update, w_t, cohort_batch,
                                      lr, spec, rngs)
    return accs, _loss_in_client_order(lwn, losses)


def scan_cohort_gradient_coded(client_update: Callable, w_t, cohort_batch,
                               client_weights: torch.Tensor, lr, *,
                               spec: FlatSpec, codec,
                               residuals: Optional[tuple] = None, rngs=None
                               ) -> Tuple[List[torch.Tensor], torch.Tensor,
                                          Optional[tuple]]:
    """:func:`scan_cohort_gradient_flat` with a lossy uplink codec
    (:mod:`repro_torch.comm`) between each client and the accumulators:
    client k's flat gradient is encoded (error-compensated against its
    ``residuals`` slot, which is updated in place), decoded and folded into
    the Eq. (14) accumulators — for ``int8`` / ``sign1bit`` the decode is
    the accumulation itself (``kernels/comm``).  One client's gradient is
    alive at a time; weights are normalized once; the loss is weighted by
    the normalized weights, accumulated in client order.  Not
    differentiable in the weights: lossy codecs are ``meta_mode='post'``
    only.  Returns (G_groups, mean_loss, residuals)."""
    w32 = client_weights.to(torch.float32)
    wn = w32 / torch.clamp(torch.sum(w32), min=1e-30)
    accs = flat_mod.zeros_flat(spec, wn.device)
    scratch = [torch.empty_like(a) for a in accs]
    losses = []
    for k in range(wn.shape[0]):
        g_k, l_k = client_update(w_t, _client_batch(cohort_batch, k), lr,
                                 _client_rng(rngs, k))
        g_bufs = flat_mod.flatten_tree(spec, g_k, out=scratch)
        del g_k
        res_k = (None if residuals is None
                 else [stack[k] for stack in residuals])
        accs, _ = client_coded_accumulate(codec, spec, accs, g_bufs, wn[k],
                                          res_k)
        losses.append(l_k.to(torch.float32))
    return list(accs), _loss_in_client_order(wn, losses), (
        None if residuals is None else tuple(residuals))


def scan_cohort_deltas_flat(client_update: Callable, w_t, cohort_batch,
                            client_weights: torch.Tensor, lr, *,
                            spec: FlatSpec, out: Callable,
                            finish: Optional[Callable] = None, rngs=None
                            ) -> torch.Tensor:
    """Client-sequential local updates that KEEP each client's flat delta
    (the buffered-async pool weighs every delta on its own at flush time).
    Client k's delta is flattened into ``out(k)`` (per-group ``(rows,
    128)`` fp32 buffers, e.g. a pool slot) or, where that is None, into a
    scratch buffer reused across clients; ``finish(k, bufs)`` then runs on
    it (the uplink codec).  Returns the mean client loss, weighted and
    summed in client order as :func:`scan_cohort_gradient_flat` sums it,
    so the fault-free tick reproduces the synchronous scan round's
    bits.  The clients run with grad mode off, as inside that function's
    ``_ScanCohort.forward``: on CUDA the client update's bits depend on
    the grad mode around its ``torch.func`` transforms (4.7e-7 apart at
    smollm-360m's full width)."""
    w32 = client_weights.to(torch.float32)
    wn = w32 / torch.clamp(torch.sum(w32), min=1e-30)
    scratch = None
    losses = []
    for k in range(wn.shape[0]):
        with torch.no_grad():
            g_k, l_k = client_update(w_t, _client_batch(cohort_batch, k),
                                     lr, _client_rng(rngs, k))
        bufs = out(k)
        if bufs is None:
            if scratch is None:
                scratch = flat_mod.zeros_flat(spec, wn.device)
            bufs = scratch
        flat_mod.flatten_tree(spec, g_k, out=bufs)
        del g_k
        if finish is not None:
            finish(k, bufs)
        losses.append(l_k.to(torch.float32))
    return _loss_in_client_order(wn, losses)
