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
    outside the loop, as the JAX chunked core does.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch

from repro_torch.core import flat as flat_mod
from repro_torch.core.flat import LANES, FlatSpec
from repro_torch.kernels.fused_update.ops import flat_accumulate


def _client_batch(cohort_batch: Dict[str, torch.Tensor], k: int):
    return {name: x[k] for name, x in cohort_batch.items()}


def cohort_gradient_stacked(client_update: Callable, w_t, cohort_batch,
                            client_weights: torch.Tensor, lr, *,
                            spec: FlatSpec
                            ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Run every client; returns (per-group (cohort, rows, 128) gradient
    stacks, n_k-weighted mean client loss)."""
    cohort = client_weights.shape[0]
    device = client_weights.device
    stacks = [torch.empty((cohort, g.rows, LANES), dtype=torch.float32,
                          device=device) for g in spec.groups]
    losses = []
    for k in range(cohort):
        g_k, l_k = client_update(w_t, _client_batch(cohort_batch, k), lr,
                                 None)
        flat_mod.flatten_tree(spec, g_k, out=[s[k] for s in stacks])
        losses.append(l_k)
        del g_k
    w32 = client_weights.to(torch.float32)
    wsum = torch.clamp(torch.sum(w32), min=1e-30)
    mean_loss = torch.sum(torch.stack(losses) * w32) / wsum
    return stacks, mean_loss


def scan_cohort_gradient_flat(client_update: Callable, w_t, cohort_batch,
                              client_weights: torch.Tensor, lr, *,
                              spec: FlatSpec
                              ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Client-sequential cohort fused into the flat engine.  Returns
    (G_groups, mean_loss): the Eq. (14) weighted-mean flat buffers and the
    weighted mean client loss, accumulated in client order."""
    cohort = client_weights.shape[0]
    device = client_weights.device
    w32 = client_weights.to(torch.float32)
    wn = w32 / torch.clamp(torch.sum(w32), min=1e-30)
    accs = flat_mod.zeros_flat(spec, device)
    scratch = [torch.empty_like(a) for a in accs]
    l_acc = torch.zeros((), dtype=torch.float32, device=device)
    for k in range(cohort):
        g_k, l_k = client_update(w_t, _client_batch(cohort_batch, k), lr,
                                 None)
        g_bufs = flat_mod.flatten_tree(spec, g_k, out=scratch)
        del g_k
        for acc, g in zip(accs, g_bufs):
            flat_accumulate(acc, g, wn[k:k + 1], out=acc)
        l_acc = l_acc + wn[k] * l_k
    return accs, l_acc
