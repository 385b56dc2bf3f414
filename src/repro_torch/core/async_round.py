"""Buffered asynchronous federation (FedBuff-style): PyTorch port of
``repro/core/async_round.py``.

The synchronous round is a barrier: every cohort delta must arrive before
the server steps.  The ``buffered_async`` engine replaces the barrier with
a bounded pool of client deltas, each stamped with the server version it
was computed against and a delivery tick (``tick + delay`` under a delay
fault), and the server steps every ``K = FedConfig.async_buffer`` arrived
deltas with staleness-discounted weights.

One **tick** (one ``state["round"]`` increment, the signature of the
synchronous ``one_round``) is one dispatch period: a fresh cohort trains on
the current parameters, its deltas enter the pool, and the server flushes
every K arrived deltas (delivered and not yet consumed):

  * flush weights are ``n_k * discount(s)`` with ``s = server_version -
    delta_version`` (:func:`staleness_discount`), normalized as the
    synchronous scan cohort normalizes its weights;
  * the weighted mean streams through the accumulate kernel
    (``flat_accumulate``, one launch per flushed delta and group) and the
    engine's fused clip / optimizer / write sweep, the synchronous scan
    strategy's kernels: a fault-free tick with ``K = async_capacity =
    cohort`` on the scan base is bitwise the synchronous scan round;
  * each flush advances the server version, staling the deltas left in
    the pool; ``async_max_staleness`` evicts arrived deltas staler than
    that.

Faults act where a real system sees them: crash and drop zero a delta's
pool weight (it never arrives), delay pushes its delivery tick, garble
scales the decoded payload.  A lossy codec runs per client before the pool
(the pool keeps what the server received); error-feedback residuals live in
``state["comm"]`` as in the synchronous round.

Where the state lives.  The slot weights, versions, delivery ticks and the
server version are host numpy (as the round counter and the draws are);
the pool is one ``(capacity, rows, 128)`` fp32 tensor per dtype group on
the device.  The pool's order is JAX's, kept on the host: ``slot[i]`` is
the physical slot of logical slot i.  An arriving delta is written straight
into a free or evicted physical slot (the scan base as each client
finishes), so the pool is never copied.  :func:`async_checkpoint_view`
gives the pool in logical order, JAX's checkpoint layout.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.ckpt import check_leaf_bytes
from repro_torch.comm import comm_bytes_per_client, resolve_codec
from repro_torch.core.algorithms import get_algorithm
from repro_torch.core.engines import resolve_engine
from repro_torch.core.executors import FlatAggregate, get_executor
from repro_torch.core.flat import LANES, FlatSpec, make_flat_spec, zeros_flat
from repro_torch.core.meta import meta_update
from repro_torch.core.round import (decayed_lr, dropout_rngs,
                                    host_weights, resolve_server_lr)
from repro_torch.core.sanitize import check_flat_groups
from repro_torch.kernels.fused_update.ops import flat_accumulate
from repro_torch.models.model import Model
from repro_torch.sim.faults import resolve_faults

State = Dict[str, Any]

STALENESS_HIST_BINS = 8     # staleness histogram: counts of s in 0..6, 7+

_INT32_MAX = int(np.iinfo(np.int32).max)


def resolve_async_shape(fed) -> Tuple[int, int]:
    """(K, capacity): the server steps every K arrivals; the pool holds
    ``capacity`` delta slots.  Defaults: K = cohort, capacity = 2 *
    cohort."""
    k = int(getattr(fed, "async_buffer", 0)) or fed.cohort
    cap = int(getattr(fed, "async_capacity", 0)) or 2 * fed.cohort
    return k, cap


def staleness_discount(mode: str) -> Callable[[np.ndarray], np.ndarray]:
    """Staleness (fp32 numpy) -> fp32 weight multiplier.  ``discount(0)
    == 1.0`` exactly in every mode, so a fresh delta's weight is
    unchanged."""
    one = np.float32(1.0)
    if mode == "none":
        return lambda s: np.ones_like(s, dtype=np.float32)
    if mode == "inv":
        return lambda s: one / (one + np.asarray(s, np.float32))
    if mode == "invsqrt":
        return lambda s: one / np.sqrt(one + np.asarray(s, np.float32))
    raise ValueError(
        f"unknown staleness_mode {mode!r}; expected 'none', 'inv' or "
        "'invsqrt' (the FedBuff 1/sqrt(1+s) default)")


def init_async_state(fed, spec: FlatSpec, device=None) -> State:
    """The empty delta pool: per-dtype-group ``(capacity, rows, 128)`` fp32
    slots on ``device``, the host vectors (``weight == 0`` marks a free
    slot) and the server version."""
    _, cap = resolve_async_shape(fed)
    return {
        "pool": tuple(torch.zeros((cap, g.rows, LANES), dtype=torch.float32,
                                  device=device) for g in spec.groups),
        "slot": np.arange(cap, dtype=np.int64),
        "weight": np.zeros((cap,), np.float32),
        "version": np.zeros((cap,), np.int32),
        "deliver": np.zeros((cap,), np.int32),
        "server_version": 0,
    }


def async_checkpoint_view(a: State) -> State:
    """``state["async"]`` in JAX's checkpoint layout: the pool in logical
    slot order (a gather only when the physical order differs), without
    the slot map."""
    # fail on an oversized pool before the gather allocates its copy
    for j, p in enumerate(a["pool"]):
        check_leaf_bytes(f"async/pool/{j}", p.numel() * p.element_size())
    slot = a["slot"]
    if np.array_equal(slot, np.arange(slot.shape[0])):
        pool = a["pool"]
    else:
        idx = torch.as_tensor(slot, device=a["pool"][0].device)
        pool = tuple(p.index_select(0, idx) for p in a["pool"])
    return {"pool": pool, **{k: a[k] for k in ("weight", "version",
                                               "deliver", "server_version")}}


def async_from_checkpoint(a: State) -> State:
    """Inverse of :func:`async_checkpoint_view`: logical order is the
    physical order."""
    return {**a, "slot": np.arange(a["weight"].shape[0], dtype=np.int64)}


def _insert(a: State, w_in: np.ndarray, delay: np.ndarray, tick: int,
            cap: int):
    """JAX's pool insert on the host: candidates are the old slots then
    the cohort in client order; a stable sort on ``-version`` with free
    slots last keeps ``cap`` of them, evicting the stalest.  Returns the
    new logical vectors, the new slot map, ``dest`` (client -> physical
    slot of its kept delta) and the overflow count."""
    cohort = w_in.shape[0]
    cand_w = np.concatenate([a["weight"], w_in.astype(np.float32)])
    cand_v = np.concatenate([a["version"],
                             np.full((cohort,), a["server_version"],
                                     np.int32)])
    cand_d = np.concatenate([a["deliver"],
                             (tick + delay).astype(np.int32)])
    occupied = cand_w > 0.0
    sort_key = np.where(occupied, -cand_v.astype(np.int64), _INT32_MAX)
    keep = np.argsort(sort_key, kind="stable")[:cap]
    from_old = keep < cap
    slot = np.empty((cap,), np.int64)
    slot[from_old] = a["slot"][keep[from_old]]
    spare = iter(sorted(set(a["slot"].tolist())
                        - set(slot[from_old].tolist())))
    dest = {}
    for i in np.flatnonzero(~from_old):
        slot[i] = next(spare)
        if cand_w[keep[i]] > 0.0:
            dest[int(keep[i]) - cap] = int(slot[i])
    pw = cand_w[keep]
    overflow = np.float32(np.sum(occupied) - np.sum(pw > 0))
    return pw, cand_v[keep], cand_d[keep], slot, dest, overflow


def make_async_tick(model: Model, fed, *, engine: Optional[str] = None,
                    sanitize: bool = False):
    """Build ``one_tick(state, cohort_batch, meta_batch, client_weights,
    draws=None) -> (state, metrics)``, the synchronous ``one_round``'s
    signature.  ``draws`` (:class:`repro_torch.core.round.RoundDraws`)
    carries the tick's participation mask and fault streams, garble
    included.  ``client_weights``: a host fp32 array, or a tensor read back
    once (:func:`repro_torch.core.round.host_weights`); the pool's
    bookkeeping reads them on the host.  ``engine`` overrides ``fed``'s, as in
    ``make_federated_round``; ``sanitize`` probes the deltas the tick
    writes into the pool (:func:`repro_torch.core.sanitize.
    check_flat_groups`)."""
    alg = get_algorithm(fed.algorithm)
    client_update = alg.build(model.loss, local_steps=fed.local_steps,
                              local_epochs=fed.local_epochs,
                              prox_mu=fed.prox_mu)
    exe = get_executor("buffered_async")(fed)
    eng = resolve_engine(fed, engine=engine)
    faults = resolve_faults(fed)
    codec = resolve_codec(fed)
    use_ef = codec.lossy and fed.error_feedback
    K, cap = resolve_async_shape(fed)
    if K > cap:
        raise ValueError(
            f"async_buffer={K} exceeds async_capacity={cap}: the pool can "
            "never hold K deltas, so the server would never step "
            "(deadlock). Raise async_capacity or lower async_buffer.")
    max_steps = max(cap // K, 1)
    server_lr = resolve_server_lr(fed)
    discount = staleness_discount(fed.staleness_mode)
    max_stale = fed.async_max_staleness
    needs_draws = fed.participation < 1.0 or faults.active
    slot_idx = np.arange(cap, dtype=np.int64)

    def one_tick(state: State, cohort_batch, meta_batch, client_weights,
                 draws=None) -> Tuple[State, Dict[str, Any]]:
        params = state["params"]
        a = state["async"]
        tick = state["round"]
        cohort = client_weights.shape[0]
        spec = make_flat_spec(params)
        dev = a["pool"][0].device

        rngs, rng_m = dropout_rngs(model, fed, draws, cohort_batch,
                                   meta_batch)
        w_in = host_weights(client_weights)
        delay = np.zeros((cohort,), np.int32)
        part_metrics, fault_metrics, fs = {}, {}, None
        if needs_draws:
            if draws is None:
                raise ValueError(
                    "participation < 1 or an active fault config: the tick "
                    "needs its draws (draws=RoundDraws(...), e.g. from "
                    "draw_round)")
            if fed.participation < 1.0:
                mask = np.asarray(draws.participation, np.float32)
                w_in = w_in * mask
                part_metrics["participants"] = np.sum(mask, dtype=np.float32)
            if faults.active:
                fs = draws.faults
                # crashed or dropped reports never reach the pool; weight 0
                # also keeps them out of the loss and freezes their residual
                w_in = w_in * fs.alive
                delay = np.asarray(fs.delay, np.int32)
                fault_metrics = {
                    "fault_crashed": np.sum(fs.crashed, dtype=np.float32),
                    "fault_dropped": np.sum(fs.dropped, dtype=np.float32),
                    "fault_delayed": np.sum(fs.delayed, dtype=np.float32)}

        # ---- pool insert: the order on the host, the deltas in place ----
        pw, pv, pd, slot, dest, overflow = _insert(a, w_in, delay, tick, cap)
        pool = a["pool"]

        def out(k):
            p = dest.get(k)
            return None if p is None else [g[p] for g in pool]

        comm_metrics, new_comm = {}, state.get("comm")
        client_loss: Any = 0.0
        if np.any(w_in > 0):
            # ---- local updates -> per-client decoded flat deltas ---------
            lr_c = decayed_lr(fed.client_lr, fed.lr_decay, tick)
            w_t = torch.from_numpy(w_in).to(dev)
            if codec.lossy:
                client_loss, new_comm = exe.run_deltas_coded(
                    client_update, params, cohort_batch, w_t, lr_c,
                    spec=spec, codec=codec, comm=state.get("comm"), out=out,
                    rngs=rngs)
            else:
                client_loss = exe.run_deltas(client_update, params,
                                             cohort_batch, w_t, lr_c,
                                             spec=spec, out=out, rngs=rngs)
            if fs is not None and faults.garble > 0:
                # payload corruption on the wire: after the decode, before
                # the flush (ungarbled multipliers are 1.0, skipped)
                for k, p in dest.items():
                    m = float(fs.garble_mult[k])
                    if m != 1.0:
                        for g in pool:
                            g[p].mul_(m)
            if sanitize and dest:
                # the decoded (and possibly garbled) deltas as they enter
                # the pool: a NaN caught here names the uplink, not a
                # server step several flushes later
                check_flat_groups(
                    spec, [[g[p] for p in dest.values()] for g in pool],
                    "decoded client deltas before pool insert (async tick)",
                    round_idx=tick)
        if codec.lossy:
            comm_metrics["comm_bytes"] = np.float32(comm_bytes_per_client(
                codec, spec)) * np.float32(np.sum(w_in > 0))
        arrivals = np.float32(np.sum((pw > 0) & (pd == tick)))

        # ---- flush every K arrived deltas --------------------------------
        new_params, new_opt = params, state["opt"]
        ver = int(a["server_version"])
        steps, grad_norm = 0, 0.0
        s_sum = s_cnt = s_max = np.float32(0.0)
        hist = np.zeros((STALENESS_HIST_BINS,), np.float32)
        for _ in range(max_steps):
            eligible = (pw > 0.0) & (pd <= tick)
            if max_stale > 0:
                eligible &= (ver - pv) <= max_stale
            if int(np.sum(eligible)) < K:
                break
            # the K earliest-delivered eligible deltas, slot index breaking
            # ties
            sel_key = np.where(eligible,
                               pd.astype(np.int64) * (cap + 1) + slot_idx,
                               _INT32_MAX)
            sel = np.zeros((cap,), bool)
            sel[np.argsort(sel_key, kind="stable")[:K]] = True
            sel &= eligible
            s = (ver - pv).astype(np.float32)
            w_eff = (pw * discount(s) * sel.astype(np.float32)
                     ).astype(np.float32)
            # normalized on the device exactly as the scan cohort does
            w_t = torch.from_numpy(w_eff).to(dev)
            wn = w_t / torch.clamp(torch.sum(w_t), min=1e-30)
            accs = zeros_flat(spec, dev)
            for i in np.flatnonzero(w_eff > 0):
                # a zero weight adds nothing: acc + 0 g == acc
                for acc, g in zip(accs, pool):
                    flat_accumulate(acc, g[slot[i]], wn[i:i + 1], out=acc)
            handle = FlatAggregate(accs, spec, sq_norm=None)
            new_params, new_opt, grad_norm = eng.apply(
                new_params, handle, new_opt, lr=server_lr)
            del handle, accs
            bins = np.clip(s[sel].astype(np.int32), 0, STALENESS_HIST_BINS - 1)
            hist += np.bincount(bins, minlength=STALENESS_HIST_BINS)
            steps += 1
            s_sum = np.float32(s_sum + np.sum(s[sel], dtype=np.float32))
            s_cnt = np.float32(s_cnt + np.sum(sel, dtype=np.float32))
            s_max = np.float32(max(s_max, np.max(s[sel])))
            pw = np.where(sel, np.float32(0.0), pw)
            ver += 1

        if max_stale > 0:
            # arrived deltas the staleness bound made ineligible for good:
            # free their slots and count them
            stale = (pw > 0.0) & (pd <= tick) & ((ver - pv) > max_stale)
            fault_metrics["expired"] = np.float32(np.sum(stale))
            pw = np.where(stale, np.float32(0.0), pw)

        metrics = {
            "client_loss": client_loss,
            "grad_norm": grad_norm,
            "arrivals": arrivals,
            "server_steps": np.float32(steps),
            "buffer_fill": np.float32(np.sum(pw > 0)),
            "overflow_dropped": overflow,
            "staleness_mean": np.float32(s_sum / max(s_cnt, np.float32(1))),
            "staleness_max": s_max,
            "staleness_hist": hist,
            **part_metrics, **fault_metrics, **comm_metrics,
        }
        if fed.meta:
            # one FedMeta step a tick, only if the server stepped: a tick
            # without a flush leaves params and opt as they were
            if steps > 0:
                lr_m = decayed_lr(fed.meta_lr, fed.lr_decay, tick)
                new_params, metrics["meta_loss"] = meta_update(
                    model.loss, new_params, meta_batch, lr_m, rng_m)
            else:
                metrics["meta_loss"] = 0.0

        new_state = {
            "params": new_params, "opt": new_opt, "round": tick + 1,
            "async": {"pool": pool, "slot": slot, "weight": pw,
                      "version": pv, "deliver": pd, "server_version": ver},
        }
        if use_ef:
            new_state["comm"] = new_comm
        return new_state, metrics

    return one_tick
