"""Unbiased weighted aggregation over the cohort (Eq. 14) — PyTorch port of
the forward arms of ``repro/core/aggregate.py`` that the fused engine runs:

  * :func:`cohort_gradient_stacked` — the vmap (client-parallel) arm with
    ``aggregate=False``: every client's flat gradient lands in its slot of
    a preallocated ``(cohort, rows, 128)`` stack, for the aggregate kernel
    to reduce.  The clients run one after another (the JAX package vmaps
    them); filling the stack slot by slot keeps one client's tree alive at
    a time instead of stacking a list, which would double peak memory.
  * :func:`chunked_cohort_gradient_flat` — the chunked streaming core
    (``FedConfig.cohort_chunk``): the cohort runs in chunks of clients,
    ``torch.func.vmap`` within a chunk, and each client's flat gradient
    streams into the group accumulators with the accumulate kernel, ``acc
    <- acc + w_k g_k`` in place, in global client order; a ragged final
    chunk is padded with weight-0 replicas.  Weights are normalized once
    outside the loop.  It is differentiable in the weights
    (``meta_mode='through_aggregation'``) at one chunk of memory in both
    directions: the backward re-runs one chunk of clients at a time and
    feeds each client's gradient to the accumulate backward kernel — JAX's
    ``jax.checkpoint`` of the chunk body.  With a :class:`CohortPart` it
    runs one process's slots of the cohort and sums the partials over the
    processes (the sharded executor).
  * :func:`scan_cohort_gradient_flat` — the client-sequential (scan) arm:
    the chunked core at chunk = 1, each client run unbatched, one
    client's gradient alive at a time.

:func:`scan_cohort_deltas_flat` is the scan arm of the buffered-async
runtime: it keeps each client's flat delta instead of accumulating it,
writing it where the caller says (a slot of the delta pool), so no
``(cohort, rows, 128)`` stack is made.

Each arm has a coded form for a lossy uplink codec (``meta_mode='post'``
only): :func:`cohort_gradient_stacked_coded` runs the codec stage over the
filled stack, :func:`chunked_cohort_gradient_coded` (the scan cohort at
chunk = 1) as each client's gradient arrives; both accumulate with the codec's decode instead of the aggregate
or accumulate kernel.

Every arm takes ``rngs``: one client's dropout masks per cohort slot
(:class:`repro_torch.core.dropout.ClientMasks`), handed to client k's
update wherever it runs (the backward's re-run too; a vmapped chunk takes
its clients' masks stacked), or None.
"""
from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

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


class CohortPart(NamedTuple):
    """The slots ``[start, stop)`` of a padded cohort that this process
    runs, and the collectives that join its partials with the other
    processes' (:class:`repro_torch.core.executors.ShardedExecutor`, tier
    2): ``reduce(tensors)`` sums each tensor over the processes in place;
    ``gather(dw)`` returns every slot's ``dw`` in slot order from this
    process's ``(stop - start,)``."""
    start: int
    stop: int
    reduce: Callable
    gather: Callable


def _chunk_cohort_inputs(cohort: int, n_slots: int, chunk: int,
                         part: Optional[CohortPart] = None) -> List[list]:
    """The chunks of cohort slots this process streams: lists of ``(slot,
    client)`` pairs, in global slot order.

    The slots are ``range(n_slots)`` (``part``: its ``[start, stop)``);
    a slot past the cohort (a sharded cohort padded to a multiple of its
    processes) replicates client 0.  A ragged final chunk is padded with
    ``(None, client)`` pairs replicating the first client of the slots:
    its batch and dropout masks, at weight 0, so ``acc + 0 * g == acc``
    bitwise for a finite g."""
    start, stop = (0, n_slots) if part is None else (part.start, part.stop)
    members = [(s, s if s < cohort else 0) for s in range(start, stop)]
    chunk = max(1, min(int(chunk), len(members)))
    pad = -len(members) % chunk
    members += [(None, members[0][1])] * pad
    return [members[i:i + chunk] for i in range(0, len(members), chunk)]


def _chunk_masks(rngs, clients: List[int]):
    """The dropout masks of ``clients`` stacked on a leading axis, the
    form a vmapped chunk takes; None for a model without dropout."""
    if rngs is None:
        return None
    first = rngs[clients[0]]
    return type(first)(*(tuple(torch.stack([rngs[k][f][l] for k in clients])
                               for l in range(len(first[f])))
                         for f in range(len(first))))


def _run_chunk(client_update: Callable, w_t, cohort_batch, lr, rngs,
               members: list):
    """Run one chunk's clients: -> (each member's gradient tree, each
    member's loss).  A chunk of one runs its client unbatched, exactly as
    the scan cohort does, so chunk = 1 is the scan cohort bit for bit; a
    wider one runs ``torch.func.vmap`` over its clients."""
    clients = [k for _, k in members]
    if len(clients) == 1:
        (k,) = clients
        g, loss = client_update(w_t, _client_batch(cohort_batch, k), lr,
                                _client_rng(rngs, k))
        return [g], [loss]
    idx = torch.tensor(clients, device=next(iter(
        cohort_batch.values())).device)
    batch = {n: x.index_select(0, idx) for n, x in cohort_batch.items()}
    masks = _chunk_masks(rngs, clients)
    if masks is None:
        g, losses = torch.func.vmap(
            lambda b: client_update(w_t, b, lr, None))(batch)
    else:
        g, losses = torch.func.vmap(
            lambda b, r: client_update(w_t, b, lr, r))(batch, masks)
    return ([{n: x[i] for n, x in g.items()} for i in range(len(clients))],
            list(losses.unbind(0)))


def _slot_weight(wn: torch.Tensor, slot: Optional[int], zero: torch.Tensor
                 ) -> torch.Tensor:
    return zero if slot is None else wn[slot:slot + 1]


def _stream_flat_chunks(client_update: Callable, w_t, cohort_batch, lr,
                        rngs, chunks: List[list], wn: torch.Tensor,
                        lwn: torch.Tensor, *, spec: FlatSpec, codec=None,
                        residuals: Optional[tuple] = None
                        ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """The chunked streaming core (JAX's ``_stream_flat_chunks``), shared
    by the chunked and scan executors and by each process of the sharded
    one.  Chunk after chunk, the chunk's clients run (:func:`_run_chunk`)
    and each client's flat gradient goes into the group accumulators in
    global slot order: ``acc <- acc + wn_s g_s`` in place by the
    accumulate kernel, or, with ``codec``, through the client's uplink
    (:func:`repro_torch.comm.transport.client_coded_accumulate`, the
    decode fused into the accumulation; ``residuals``: the per-group
    ``(cohort, rows, 128)`` error-feedback stacks, slot s's row updated in
    place).  The loss is accumulated mul-then-add in the same order,
    ``l <- l + lwn_s * l_s``.  So every fp32 bit of the accumulation is
    invariant to the chunk size; peak gradient memory is one chunk.

    ``wn`` / ``lwn``: the normalized aggregation / loss weights of every
    slot.  A chunk's pad member weighs 0 and, under error feedback, codes
    against a zero residual that the codec's transmitted-gate leaves
    zero.  Returns (accs, loss)."""
    accs = flat_mod.zeros_flat(spec, wn.device)
    zero = wn.new_zeros((1,))
    zero_res = None
    l_acc = torch.zeros((), dtype=torch.float32, device=wn.device)
    for members in chunks:
        g, losses = _run_chunk(client_update, w_t, cohort_batch, lr, rngs,
                               members)
        # the flattening buffer lives between a chunk's run and the next
        # one's, not through it: the clients' run is the peak
        scratch = [torch.empty_like(a) for a in accs]
        for i, (s, _) in enumerate(members):
            g_bufs = flat_mod.flatten_tree(spec, g[i], out=scratch)
            w_s = _slot_weight(wn, s, zero)
            if codec is None:
                for acc, gb in zip(accs, g_bufs):
                    flat_accumulate(acc, gb, w_s, out=acc)
            else:
                res_s = None
                if residuals is not None:
                    if s is None or s >= residuals[0].shape[0]:
                        if zero_res is None:
                            zero_res = flat_mod.zeros_flat(spec, wn.device)
                        res_s = zero_res
                    else:
                        res_s = [stack[s] for stack in residuals]
                accs, _ = client_coded_accumulate(codec, spec, accs, g_bufs,
                                                  w_s.reshape(()), res_s)
            l_acc = l_acc + _slot_weight(lwn, s, zero).reshape(()) * \
                losses[i].to(torch.float32)
        del g, losses, scratch
    return list(accs), l_acc


class _ChunkedCohort(torch.autograd.Function):
    """wn (n_slots,) normalized weights -> (G_groups..., loss).

    The forward streams the chunks (:func:`_stream_flat_chunks`) and keeps
    no gradient; with ``part`` it runs only its slots and sums the partial
    accumulators and loss over the processes.  The backward re-runs one
    chunk of clients at a time and calls the accumulate backward kernel
    per client, ``dwn_s = sum over groups <g_s, dG>`` (a pad member's too,
    then dropped), so one chunk of gradients is alive in either direction
    — JAX's ``jax.checkpoint`` of each chunk body; with ``part`` the slots'
    ``dwn`` are gathered from every process.  The loss is an output
    without a gradient: the caller's ``lwn`` weight it."""

    @staticmethod
    def forward(ctx, wn, lwn, client_update, w_t, cohort_batch, lr, spec,
                rngs, chunks, part):
        ctx.args = (client_update, w_t, cohort_batch, lr, spec, rngs,
                    chunks, part)
        ctx.save_for_backward(wn)
        accs, loss = _stream_flat_chunks(client_update, w_t, cohort_batch,
                                         lr, rngs, chunks, wn, lwn,
                                         spec=spec)
        if part is not None:
            part.reduce(accs + [loss])
        ctx.mark_non_differentiable(loss)
        return (*accs, loss)

    @staticmethod
    def backward(ctx, *cts):
        client_update, w_t, cohort_batch, lr, spec, rngs, chunks, part = \
            ctx.args
        (wn,) = ctx.saved_tensors
        dGs = [d.contiguous() for d in cts[:-1]]
        zero = wn.new_zeros((1,))
        dwn = []
        for members in chunks:
            g, _ = _run_chunk(client_update, w_t, cohort_batch, lr, rngs,
                              members)
            scratch = [torch.empty_like(d) for d in dGs]
            for i, (s, _) in enumerate(members):
                g_bufs = flat_mod.flatten_tree(spec, g[i], out=scratch)
                dw = None
                for gb, dG in zip(g_bufs, dGs):
                    _, dw_j = K.accumulate_pass_bwd(
                        gb, _slot_weight(wn, s, zero), dG)
                    dw = dw_j if dw is None else dw + dw_j
                if s is not None:
                    dwn.append(dw)
            del g, scratch
        dwn = torch.stack(dwn)
        if part is not None:
            dwn = part.gather(dwn)
        return (dwn,) + (None,) * 9


def _normalized(w: torch.Tensor) -> torch.Tensor:
    w32 = w.to(torch.float32)
    return w32 / torch.clamp(torch.sum(w32), min=1e-30)


def _pad_slots(x: torch.Tensor, n_slots: int) -> torch.Tensor:
    """(cohort,) -> (n_slots,), the slots past the cohort weighing 0."""
    pad = n_slots - x.shape[0]
    return x if pad == 0 else torch.cat([x, x.new_zeros((pad,))])


def chunked_cohort_gradient_flat(client_update: Callable, w_t, cohort_batch,
                                 client_weights: torch.Tensor, lr, *,
                                 spec: FlatSpec, chunk: int,
                                 loss_weights: Optional[torch.Tensor] = None,
                                 rngs=None, n_slots: Optional[int] = None,
                                 part: Optional[CohortPart] = None
                                 ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Chunked streaming cohort execution, the core of the ``chunked``
    executor, of which ``scan`` is the chunk = 1 pin.  Returns (G_groups,
    mean_loss): the Eq. (14) weighted-mean flat buffers and the weighted
    mean client loss, both accumulated in client order, so every bit is
    invariant to the chunk size wherever a client's gradient is
    (``chunk`` clients run under ``torch.func.vmap``; on the CPU a
    vmapped client's gradient can differ from an unbatched one's in the
    last bits, ROADMAP Queue 3 item 4).

    Weights are normalized over the whole cohort once, outside the chunk
    loop.  Differentiable in ``client_weights`` (see
    :class:`_ChunkedCohort`): peak memory is one chunk in both
    directions.  ``loss_weights`` (default: ``client_weights``) weights
    the loss metric apart from the aggregation: through_aggregation
    aggregates with the controllable eff_w but reports the n_k-weighted
    loss, so the metric means the same on every strategy.

    ``n_slots`` (default: the cohort) pads the cohort with weight-0
    replicas of client 0 and ``part`` runs only some of its slots, summing
    the partials over the processes: the sharded executor's tier 1 and
    2."""
    cohort = client_weights.shape[0]
    n_slots = cohort if n_slots is None else n_slots
    wn = _normalized(client_weights)
    lwn = wn.detach() if loss_weights is None else _normalized(loss_weights)
    chunks = _chunk_cohort_inputs(cohort, n_slots, chunk, part)
    *accs, loss = _ChunkedCohort.apply(
        _pad_slots(wn, n_slots), _pad_slots(lwn, n_slots), client_update,
        w_t, cohort_batch, lr, spec, rngs, chunks, part)
    return accs, loss


def chunked_cohort_gradient_coded(client_update: Callable, w_t,
                                  cohort_batch, client_weights: torch.Tensor,
                                  lr, *, spec: FlatSpec, chunk: int, codec,
                                  residuals: Optional[tuple] = None,
                                  rngs=None, n_slots: Optional[int] = None,
                                  part: Optional[CohortPart] = None
                                  ) -> Tuple[List[torch.Tensor], torch.Tensor,
                                             Optional[tuple]]:
    """:func:`chunked_cohort_gradient_flat` with a lossy uplink codec
    between each client and the accumulators (``kernels/comm``: the decode
    is the accumulation), ``meta_mode='post'`` only; the loss is weighted
    by the normalized aggregation weights.  ``residuals``: per-group
    ``(cohort, rows, 128)`` error-feedback stacks or None, client k's row
    updated in place as its gradient is coded (with ``part``: only this
    process's clients' rows; the caller gathers the rest).  Pad slots
    weigh 0, so the codec's transmitted-gate leaves their zero residuals
    as they were, and no cohort row holds them.  Returns (G_groups,
    mean_loss, residuals)."""
    cohort = client_weights.shape[0]
    n_slots = cohort if n_slots is None else n_slots
    wn = _pad_slots(_normalized(client_weights), n_slots)
    chunks = _chunk_cohort_inputs(cohort, n_slots, chunk, part)
    accs, loss = _stream_flat_chunks(client_update, w_t, cohort_batch, lr,
                                     rngs, chunks, wn, wn, spec=spec,
                                     codec=codec, residuals=residuals)
    if part is not None:
        part.reduce(accs + [loss])
    return accs, loss, None if residuals is None else tuple(residuals)


def scan_cohort_gradient_flat(client_update: Callable, w_t, cohort_batch,
                              client_weights: torch.Tensor, lr, *,
                              spec: FlatSpec,
                              loss_weights: Optional[torch.Tensor] = None,
                              rngs=None
                              ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Client-sequential cohort fused into the flat engine: the chunked
    core at chunk = 1, one client's gradient alive at a time in both
    directions (:func:`chunked_cohort_gradient_flat`)."""
    return chunked_cohort_gradient_flat(
        client_update, w_t, cohort_batch, client_weights, lr, spec=spec,
        chunk=1, loss_weights=loss_weights, rngs=rngs)


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
    ``_ChunkedCohort.forward``: on CUDA the client update's bits depend on
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
