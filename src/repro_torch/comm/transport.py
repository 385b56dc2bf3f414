"""Uplink simulation glue (PyTorch port of ``repro/comm/transport.py``):
per-client encode -> decode -> Eq. (14) accumulation over the flat dtype
group buffers, the per-client error-feedback state and the byte
accounting.

  * :func:`client_coded_accumulate` is one client's uplink, shared by the
    cohort executors: the chunked core (scan included) calls it as each
    client's gradient arrives (:func:`repro_torch.core.aggregate.
    chunked_cohort_gradient_coded`), the vmap cohort over its filled
    gradient stack
    (:func:`coded_aggregate_stacked`), client after client in cohort order
    — what the JAX chunked core does at chunk = cohort.
  * The decode fuses into the accumulation and writes the accumulator in
    place; with error feedback the encode emits the residual in the same
    sweep.
  * :func:`coded_decode_stacked` (and :func:`client_coded_decode`, one
    client of it) is the buffered-async runtime's uplink: each client's
    delta is encoded and decoded on its own, without an accumulation,
    because the delta pool stores what the server received and weighs it
    only at flush time.

Error-feedback state (``state["comm"]``): ``{"residual": tuple}``, one
``(cohort, rows, 128)`` fp32 stack per dtype group, client k in slot k.
The uplink updates the stacks IN PLACE (the JAX package returns new
stacks): at full width one stack is 5.8 GB, and the round that consumes a
state's ``comm`` slot is the only reader of it.
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import torch

from repro_torch.comm.codecs import GradientCodec
from repro_torch.core import flat as flat_mod
from repro_torch.core.flat import LANES, FlatSpec


def init_comm_state(fed, spec: FlatSpec, device=None) -> dict:
    """Zero per-client error-feedback residuals in the comm-state layout."""
    return {"residual": tuple(
        torch.zeros((fed.cohort, g.rows, LANES), dtype=torch.float32,
                    device=device) for g in spec.groups)}


def comm_bytes_per_client(codec: GradientCodec, spec: FlatSpec) -> int:
    """Uplink bytes ONE client ships per round under ``codec``."""
    return sum(codec.payload_bytes(g) for g in spec.groups)


def client_coded_accumulate(codec: GradientCodec, spec: FlatSpec,
                            accs: Sequence[torch.Tensor],
                            g_bufs: Sequence[torch.Tensor], w: torch.Tensor,
                            residuals: Optional[Sequence[torch.Tensor]]
                            ) -> Tuple[tuple, Optional[tuple]]:
    """One client's uplink across all dtype groups.

    accs / g_bufs: per-group (rows, 128) fp32 accumulators / gradient; w:
    the client's normalized aggregation weight (a device scalar);
    residuals: per-group error-feedback memory or None.  The accumulators,
    and the residuals with error feedback, are updated in place; returns
    (accs, residuals).

    A client with w == 0 did not transmit: its contribution is zero, and
    its residual must stay unchanged (overwriting it would drop the
    decoded part of its error as if the server had received it).  The
    gate is JAX's, ``t * r_new + (1 - t) * res`` with ``t = (w > 0)``."""
    new_accs = []
    if residuals is None:
        for group, acc, g in zip(spec.groups, accs, g_bufs):
            payload = codec.encode(group, g)
            new_accs.append(codec.decode_fma(group, acc, payload, w))
        return tuple(new_accs), None
    t = (w > 0).to(torch.float32)
    for group, acc, g, res in zip(spec.groups, accs, g_bufs, residuals):
        payload, r_new = codec.encode_ef(group, g + res)
        new_accs.append(codec.decode_fma(group, acc, payload, w))
        del payload
        res.mul_(1.0 - t).add_(r_new.mul_(t))
    return tuple(new_accs), tuple(residuals)


def coded_aggregate_stacked(codec: GradientCodec, spec: FlatSpec,
                            g_groups: Sequence[torch.Tensor],
                            client_weights: torch.Tensor,
                            residuals: Optional[Sequence[torch.Tensor]]
                            ) -> Tuple[List[torch.Tensor], Optional[tuple]]:
    """The vmap cohort's codec stage: each client's uplink over the filled
    ``(cohort, rows, 128)`` gradient stacks, accumulated into the Eq. (14)
    weighted mean one client at a time.

    Returns (G_groups, residuals): G in the layout
    :func:`repro_torch.kernels.fused_update.ops.flat_weighted_aggregate`
    gives (a list of (rows, 128) fp32), and the residual stacks, updated
    in place (None without error feedback)."""
    w = client_weights.to(torch.float32)
    w = w / torch.clamp(torch.sum(w), min=1e-30)
    accs: Any = flat_mod.zeros_flat(spec, w.device)
    for k in range(w.shape[0]):
        res_k = (None if residuals is None
                 else [stack[k] for stack in residuals])
        accs, _ = client_coded_accumulate(
            codec, spec, accs, [stack[k] for stack in g_groups], w[k], res_k)
    return list(accs), (None if residuals is None else tuple(residuals))


def client_coded_decode(codec: GradientCodec, spec: FlatSpec,
                        g_bufs: Sequence[torch.Tensor], w: torch.Tensor,
                        residuals: Optional[Sequence[torch.Tensor]]) -> None:
    """One client's uplink without the accumulation: each group's delta in
    ``g_bufs`` is encoded (against its error-feedback residual when
    ``residuals`` is given) and replaced, in place, by its decode.  ``w``
    (the client's weight, a device scalar) only gates the residual: a
    client with w == 0 did not transmit and keeps its residual, by the
    gate of :func:`client_coded_accumulate`."""
    if residuals is None:
        for group, g in zip(spec.groups, g_bufs):
            g.copy_(codec.decode(group, codec.encode(group, g)))
        return
    t = (w > 0).to(torch.float32)
    for group, g, res in zip(spec.groups, g_bufs, residuals):
        payload, r_new = codec.encode_ef(group, g + res)
        g.copy_(codec.decode(group, payload))
        del payload
        res.mul_(1.0 - t).add_(r_new.mul_(t))


def coded_decode_stacked(codec: GradientCodec, spec: FlatSpec,
                         g_groups: Sequence[torch.Tensor],
                         client_weights: torch.Tensor,
                         residuals: Optional[Sequence[torch.Tensor]]
                         ) -> Tuple[List[torch.Tensor], Optional[tuple]]:
    """The buffered-async executor's codec stage over ``(cohort, rows,
    128)`` delta stacks: every client's delta encoded and decoded on its
    own (:func:`client_coded_decode`), written back into its stack slot.
    Returns (the stacks, now decoded, and the residual stacks, updated in
    place; None without error feedback)."""
    w = client_weights.to(torch.float32)
    for k in range(w.shape[0]):
        client_coded_decode(
            codec, spec, [stack[k] for stack in g_groups], w[k],
            None if residuals is None else [stack[k] for stack in residuals])
    return list(g_groups), (None if residuals is None else tuple(residuals))
