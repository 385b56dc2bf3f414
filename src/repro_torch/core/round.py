"""One federated round (PyTorch port of ``repro/core/round.py``), composed
from the registries:

    local updating    (ClientAlgorithm: uga / fedavg / fedprox / fednova /
                       a plugin's)
 -> uplink            (GradientCodec: none / int8 / sign1bit / topk; a
                       lossy codec runs the executor's coded path, with
                       per-client error feedback in ``state["comm"]``)
 -> aggregation       (CohortExecutor: vmap / scan / chunked / sharded
                       -> an aggregate handle of a kind the engine accepts:
                       ``produces & accepts``, the engine's preferred kind
                       first)
 -> server update     (ServerEngine: legacy_tree / fused_flat)
 -> FedMeta step      (core/meta.py: Eq. 20 after the server step under
                       ``meta_mode='post'``; under ``'through_aggregation'``
                       the aggregation and server step run inside the
                       hypergradient objective and ``state["ctrl"]`` is
                       stepped instead)

``make_federated_round(model, fed, executor=None, mesh=None)`` returns
``one_round(state, cohort_batch, meta_batch, client_weights, draws=None)
-> (state, metrics)``.  ``client_weights`` (cohort,) is a host fp32 array
(numpy, what the trainer passes) or a tensor: the round's host tests read
the weights on the host (:func:`host_weights`), so a tensor on the card
costs one read back where the round needs draws, and a host array none.
``executor`` and ``engine`` name registered plugins that override the
ones ``fed`` selects;
a ``mesh`` (:mod:`repro_torch.launch.mesh`) selects the two-tier sharded
one, whose processes each run a slice of the cohort and hold the whole
server state, replicated; on a model axis above 1 the processes of a
model group run each client tensor-parallel over their parameter shards
(:mod:`repro_torch.sharding.tensor_parallel`: every transformer config,
both meta modes, the lossy codecs, both synchronous engines).  The
buffered-async runtime runs on no mesh, as in the JAX package
(:func:`refuse_async_on_mesh`).  The
round counter lives on the host (``state["round"]`` is an int), so the
decayed learning rates are host numbers computed in fp32 as the JAX round
computes them on the device; metrics come back as device scalars.

Partial participation and client faults: under ``fed.participation < 1``
or an active fault config the round takes ``draws`` (:class:`RoundDraws`,
drawn on the host by :func:`draw_round`).  A client masked out, crashed,
dropped or past the round deadline gets aggregation weight 0 inside the
weighted mean (every client still runs, as in JAX), and a lossy codec's
error-feedback residual of such a client stays as it was.  A round in
which every client failed is a no-op server step: nothing runs, params,
opt, ctrl and comm stay as they were, the counter advances,
``client_loss``, ``grad_norm`` and ``meta_loss`` read 0 and, under
``through_aggregation``, ``ctrl_w_gnorm`` NaN, as JAX's round reports
them.

A model that draws dropout masks (``model.dropout``: the paper CNN)
takes them from ``draws.dropout`` (:mod:`repro_torch.core.dropout`): the
round draws them on the host before any client runs, hands client k its
masks wherever its update runs and the FedMeta step the round's meta
masks, as JAX splits its round key into client and meta keys.

An async engine (``engine='buffered_async'``) replaces the round's shape:
``make_federated_round`` returns the buffered-async tick of
:mod:`repro_torch.core.async_round`, which has ``one_round``'s signature,
and the server state gains the delta pool, ``state["async"]``.  Its draws
keep the fault profile's garble, which a synchronous round zeroes
(:func:`round_faults`).

``sanitize=True`` plants :func:`repro_torch.core.sanitize.
check_flat_groups` on the post-round server parameters (an async tick:
on the decoded deltas it writes into its pool); the probes' counts stay
on the device until :class:`RoundFnCache`'s sanitized call reads them
back, once, after the call.

``rounds_per_call=K`` makes the function run K rounds (or async ticks)
back to back over K-stacked inputs (:func:`stack_round_inputs`: cohort
batches ``(K, cohort, ...)``, meta batches ``(K, ...)``, weights ``(K,
cohort)`` and a list of K draws, all sampled on the host before the
call), and return metrics stacked with a leading K axis, each where it
was computed: nothing is read back to the host during the call, under
participation and faults too (whether any client arrived is a host test
of the host weights and draws).  K = 1 is the one-round function
itself.  :class:`RoundFnCache` keeps one function per K, for drivers
that mix full chunks with a tail.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.comm import (comm_bytes_per_client, init_comm_state,
                              resolve_codec)
from repro_torch.configs.base import FedConfig
from repro_torch.core.algorithms import get_algorithm
from repro_torch.core.dropout import HostDropout, round_masks
from repro_torch.core.engines import resolve_engine, tree_global_norm
from repro_torch.core.executors import resolve_executor
from repro_torch.core.flat import make_flat_spec
from repro_torch.core.meta import meta_update, meta_update_through_cohort
from repro_torch.core.rngtags import PARTICIPATION_FOLD
from repro_torch.core.sanitize import check_flat_groups, sanitize_round
from repro_torch.models.model import Model, param_shapes
from repro_torch.sharding.specs import model_size
from repro_torch.sharding.tensor_parallel import check_supported, model_axis
from repro_torch.sim.faults import (FaultConfig, FaultStreams,
                                    client_failed_mask, fault_streams,
                                    resolve_faults, timed_out)

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
                      params: Optional[Dict[str, torch.Tensor]] = None,
                      engine: Optional[str] = None) -> State:
    """Server state from given ``params`` (e.g. bridged from the JAX
    package) or from ``model.init(generator)``; ``engine`` overrides the
    engine ``fed`` selects, as in :func:`make_federated_round`."""
    if params is None:
        if generator is None:
            raise ValueError("init_server_state needs params= or "
                             "generator=")
        params = model.init(generator)
    eng = resolve_engine(fed, engine=engine)
    state = {"params": params, "opt": eng.init_state(params), "round": 0}
    if fed.meta and fed.meta_mode == "through_aggregation":
        # controllable aggregation: per-client log weight multipliers and
        # a log server step size, meta-learned through the engine's VJP
        device = next(iter(params.values())).device
        state["ctrl"] = {
            "w_logits": torch.zeros((fed.cohort,), dtype=torch.float32,
                                    device=device),
            "log_lr": torch.log(torch.tensor(resolve_server_lr(fed),
                                             dtype=torch.float32,
                                             device=device))}
    if fed.error_feedback and resolve_codec(fed).lossy:
        # per-client compression residuals: zero EF memory per cohort slot
        state["comm"] = init_comm_state(
            fed, make_flat_spec(params), next(iter(params.values())).device)
    if eng.is_async:
        # the buffered-async delta pool and its staleness counters
        from repro_torch.core.async_round import init_async_state
        state["async"] = init_async_state(
            fed, make_flat_spec(params), next(iter(params.values())).device)
    return state


# the pre-registry name of the tree norm
grad_global_norm = tree_global_norm


def decayed_lr(base: float, decay: float, round_idx: int) -> float:
    """``base * decay ** round`` in fp32, as the JAX round traces it."""
    return float(np.float32(base)
                 * np.power(np.float32(decay), np.float32(round_idx)))


def host_weights(client_weights) -> np.ndarray:
    """A round's client weights as a host fp32 array: a numpy array (or a
    sequence) as it is, a tensor read back (on the card a device sync: the
    trainer hands the round host arrays, so its rounds read nothing)."""
    if isinstance(client_weights, torch.Tensor):
        client_weights = client_weights.detach().cpu().numpy()
    return np.asarray(client_weights, np.float32)


def participation_mask(seed: int, round_idx: int, cohort: int,
                       rate: float) -> np.ndarray:
    """Round ``round_idx``'s straggler mask: keep each client with
    probability ``rate`` (``uniform < rate``), f32 0/1, from the generator
    keyed by ``(seed, PARTICIPATION_FOLD, round_idx)``.  An all-zero draw
    is legal: that round is a no-op server step."""
    rng = np.random.default_rng((seed, PARTICIPATION_FOLD, round_idx))
    return (rng.random(cohort) < rate).astype(np.float32)


class RoundDraws(NamedTuple):
    """One round's host-side draws: the participation keep mask ((cohort,)
    f32 0/1, None at participation 1), the fault streams (None without an
    active fault config) and the source of the dropout masks (None for a
    model without dropout)."""
    participation: Optional[np.ndarray] = None
    faults: Optional[FaultStreams] = None
    dropout: Any = None


def sync_faults(fed: FedConfig) -> FaultConfig:
    """The fault config a synchronous round runs: ``resolve_faults`` with a
    profile's garble zeroed (a sync barrier cannot observe payload
    corruption); an explicit ``fault_garble`` is an error."""
    faults = resolve_faults(fed)
    if faults.garble > 0:
        if fed.fault_garble >= 0:
            raise ValueError(
                f"fault_garble={fed.fault_garble} needs "
                "engine='buffered_async': payload corruption acts on the "
                "pooled per-client deltas, which only the async runtime "
                "models — "
                "synchronous engines see faults at the aggregation-weight "
                "level (drop/crash/timeout). Drop fault_garble or select "
                "engine='buffered_async'.")
        faults = dataclasses.replace(faults, garble=0.0)
    return faults


def round_faults(fed: FedConfig) -> FaultConfig:
    """The fault config a round of ``fed`` draws with: the profile's
    garble kept under an async engine (it scales pooled deltas), zeroed
    by :func:`sync_faults` otherwise."""
    if resolve_engine(fed).is_async:
        return resolve_faults(fed)
    return sync_faults(fed)


def draw_round(fed: FedConfig, seed: int, round_idx: int,
               cohort: int, *, dropout: bool = False) -> RoundDraws:
    """The draws round (or async tick) ``round_idx`` of a run seeded
    ``seed`` takes; ``dropout``: the model draws dropout masks."""
    faults = round_faults(fed)
    return RoundDraws(
        participation=(participation_mask(seed, round_idx, cohort,
                                          fed.participation)
                       if fed.participation < 1.0 else None),
        faults=(fault_streams(seed, round_idx, cohort, faults)
                if faults.active else None),
        dropout=HostDropout(seed, round_idx) if dropout else None)


def dropout_rngs(model: Model, fed: FedConfig, draws, cohort_batch,
                 meta_batch):
    """(per-client masks, meta masks) of a round, or (None, None) for a
    model without dropout."""
    if model.dropout is None:
        return None, None
    masks = round_masks(model.dropout,
                        None if draws is None else draws.dropout, fed=fed,
                        cohort_batch=cohort_batch, meta_batch=meta_batch)
    return masks.clients(), masks.meta


def refuse_async_on_mesh(engine) -> None:
    """The JAX package's refusal (``repro/core/round.py``,
    ``make_federated_round``): its sharded executor always sets
    ``grad_shardings``, and an async engine refuses them, so JAX runs the
    buffered-async runtime on no mesh; neither does the port, at any
    model-axis size."""
    raise ValueError(
        f"engine={engine.name!r} keeps a replicated delta pool (per-client "
        "staleness slots), so the sharded executor's per-leaf "
        "grad_shardings cannot apply; drop the mesh (--executor sharded) "
        "or use a synchronous engine")


def make_federated_round(model: Model, fed: FedConfig, *,
                         executor: Optional[str] = None, mesh=None,
                         engine: Optional[str] = None,
                         rounds_per_call: int = 1, sanitize: bool = False):
    eng = resolve_engine(fed, engine=engine)
    tensor_parallel = model_size(mesh) > 1
    if eng.is_async:
        if mesh is not None:
            refuse_async_on_mesh(eng)
        if executor is not None:
            raise ValueError(
                "engine='buffered_async' runs its own cohort stage (the "
                "buffered_async executor over a vmap or scan base); drop "
                "executor=")
        from repro_torch.core.async_round import make_async_tick
        return _chunk_rounds(make_async_tick(model, fed, engine=engine,
                                             sanitize=sanitize),
                             rounds_per_call)
    if tensor_parallel:
        check_supported(model)
    alg = get_algorithm(fed.algorithm)
    loss_fn = model.loss
    if tensor_parallel:
        # the loss over this process's parameter shards; the (sharded)
        # executor is told which axis they split over
        axis = model_axis(mesh, param_shapes(model))
        loss_fn = partial(model.loss, tp=axis)
    client_update = alg.build(loss_fn, local_steps=fed.local_steps,
                              local_epochs=fed.local_epochs,
                              prox_mu=fed.prox_mu)
    exe = resolve_executor(fed, executor=executor, mesh=mesh)
    if tensor_parallel:
        exe.bind_model_axis(axis)
    kinds = exe.produces & eng.accepts
    if not kinds:
        raise ValueError(
            f"cohort executor {exe.name!r} produces {sorted(exe.produces)} "
            f"but server engine {eng.name!r} accepts {sorted(eng.accepts)}: "
            "no common aggregate-handle kind")
    kind = eng.preferred if eng.preferred in kinds else sorted(kinds)[0]
    server_lr = resolve_server_lr(fed)
    through_agg = fed.meta and fed.meta_mode == "through_aggregation"
    if through_agg and "through_aggregation" not in eng.meta_capabilities:
        # FedConfig checks this too; re-check against the resolved engine
        # for configs that went round __post_init__
        raise ValueError(
            f"meta_mode='through_aggregation' needs a server engine "
            f"declaring the 'through_aggregation' capability, but "
            f"{eng.name!r} declares {sorted(eng.meta_capabilities)}: the "
            "hypergradients flow through the fused engine's custom VJP. "
            "Set FedConfig(fused_update=True) (the fused_flat engine) or "
            "use meta_mode='post'.")
    if through_agg and not exe.supports_reweight:
        raise ValueError(
            f"meta_mode='through_aggregation' needs a cohort executor that "
            f"supports reweightable aggregation, but {exe.name!r} does "
            "not. Use the vmap, scan, chunked or sharded executor or "
            "meta_mode='post'.")
    codec = resolve_codec(fed)
    if codec.lossy:
        # FedConfig checks these too; re-check against the resolved plugins
        # so a lossy codec never runs a path that drops the compression or
        # differentiates through it
        if through_agg:
            raise ValueError(
                f"codec={fed.codec!r} with "
                "meta_mode='through_aggregation' would differentiate "
                "through a non-differentiable quantizer (the hypergradient "
                "would silently treat the decoded gradients as exact). "
                "Lossy codecs are meta_mode='post' only for now — a "
                "straight-through codec VJP is a ROADMAP follow-up. Use "
                "meta_mode='post' or codec='none'.")
        if "lossy" not in exe.codec_capabilities:
            raise ValueError(
                f"codec={fed.codec!r} needs a cohort executor declaring "
                f"the 'lossy' codec capability, but {exe.name!r} declares "
                f"{sorted(exe.codec_capabilities)}. Use the vmap, scan, "
                "chunked or sharded executor or codec='none'.")
        if "lossy" not in eng.codec_capabilities:
            raise ValueError(
                f"codec={fed.codec!r} needs a server engine declaring the "
                f"'lossy' codec capability, but {eng.name!r} declares "
                f"{sorted(eng.codec_capabilities)}: lossy codecs decode "
                "into the flat dtype-group buffers the fused engine "
                "consumes. Set FedConfig(fused_update=True) (the fused_flat "
                "engine) or use codec='none'.")
    use_ef = codec.lossy and fed.error_feedback
    faults = sync_faults(fed)
    needs_draws = fed.participation < 1.0 or faults.active

    def apply_draws(w: np.ndarray, draws: RoundDraws):
        """Zero the host weights of the clients masked out or failed;
        returns (weights, the participation and fault metrics), JAX's
        keys.  The products are by 0 or 1, exact in fp32."""
        if draws is None:
            raise ValueError(
                "participation < 1 or an active fault config: the round "
                "needs this round's draws (draws=RoundDraws(...), e.g. "
                "from draw_round)")
        metrics = {}
        if fed.participation < 1.0:
            mask = np.asarray(draws.participation, np.float32)
            w = w * mask
            metrics["participants"] = np.sum(mask, dtype=np.float32)
        if faults.active:
            fs = draws.faults
            w = w * (~client_failed_mask(fs, faults)).astype(np.float32)
            metrics["arrivals"] = np.sum(w > 0, dtype=np.float32)
            metrics["fault_crashed"] = np.sum(fs.crashed, dtype=np.float32)
            metrics["fault_dropped"] = np.sum(fs.dropped, dtype=np.float32)
            if faults.deadline > 0:
                metrics["fault_timeout"] = np.sum(timed_out(fs, faults),
                                                  dtype=np.float32)
        return w, metrics

    def one_round(state: State, cohort_batch, meta_batch,
                  client_weights, draws: Optional[RoundDraws] = None
                  ) -> Tuple[State, Dict[str, torch.Tensor]]:
        params = state["params"]
        r = state["round"]
        lr_c = decayed_lr(fed.client_lr, fed.lr_decay, r)
        rngs, rng_m = dropout_rngs(model, fed, draws, cohort_batch,
                                   meta_batch)
        part_metrics = {}
        stepped = True
        if needs_draws:
            # JAX's sum(w * mask) > 0, on the host weights: a zero base
            # weight beside the survivors counts, which the draws alone
            # would miss
            w, part_metrics = apply_draws(host_weights(client_weights),
                                          draws)
            stepped = np.sum(w, dtype=np.float32) > 0
            client_weights = w
        # uplink bytes: one client's payload times the clients that
        # reported (participants; the whole cohort at participation 1), in
        # fp32 as the JAX round computes them
        comm_metrics = ({"comm_bytes": np.float32(comm_bytes_per_client(
            codec, make_flat_spec(params))) * np.float32(
                part_metrics.get("participants", client_weights.shape[0]))}
            if codec.lossy else {})
        if not stepped:
            # every client failed: a no-op server step (JAX keeps the old
            # state by a select after the fact; here nothing runs, so no
            # kernel launches and no buffer is written)
            metrics = {"client_loss": 0.0, "grad_norm": 0.0,
                       **part_metrics, **comm_metrics}
            if through_agg:
                # no hypergradient exists: ctrl is not stepped, and
                # ctrl_w_gnorm reads NaN as JAX's does (its weight
                # normalization's 0/0 at all-zero weights)
                metrics.update(meta_loss=0.0,
                               ctrl_w_gnorm=np.float32(np.nan),
                               ctrl_lr_grad=0.0, server_lr_eff=torch.exp(
                                   state["ctrl"]["log_lr"]))
            elif fed.meta:
                metrics["meta_loss"] = 0.0
            return {**state, "round": r + 1}, metrics
        if not isinstance(client_weights, torch.Tensor):
            client_weights = torch.tensor(
                host_weights(client_weights),
                device=next(iter(params.values())).device)
        meta_metrics = {}
        if through_agg:
            rw = exe.reweightable(client_update, params, cohort_batch,
                                  client_weights, lr_c, rngs)
            (new_params, opt_state, gn_post, client_loss, new_ctrl,
             meta_metrics) = meta_update_through_cohort(
                model.loss, rw, client_weights, params, state["opt"],
                meta_batch, state["ctrl"], engine=eng, ctrl_lr=fed.ctrl_lr,
                rng=rng_m)
            del rw
        elif codec.lossy:
            handle, client_loss, new_comm = exe.run_coded(
                client_update, params, cohort_batch, client_weights, lr_c,
                codec=codec, comm=state.get("comm"), rngs=rngs)
            new_params, opt_state, gn_post = eng.apply(
                params, handle, state["opt"], lr=server_lr)
            del handle
        else:
            handle, client_loss = exe.run(client_update, params,
                                          cohort_batch, client_weights, lr_c,
                                          rngs, kind=kind)
            new_params, opt_state, gn_post = eng.apply(
                params, handle, state["opt"], lr=server_lr)
            del handle
        metrics = {"client_loss": client_loss, "grad_norm": gn_post,
                   **part_metrics, **meta_metrics, **comm_metrics}
        if fed.meta and not through_agg:
            lr_m = decayed_lr(fed.meta_lr, fed.lr_decay, r)
            new_params, meta_loss = meta_update(model.loss, new_params,
                                                meta_batch, lr_m, rng_m)
            metrics["meta_loss"] = meta_loss
        new_state = {"params": new_params, "opt": opt_state, "round": r + 1}
        if through_agg:
            new_state["ctrl"] = new_ctrl
        if use_ef:
            new_state["comm"] = new_comm
        return new_state, metrics

    if sanitize:
        step = one_round

        def one_round(state, *args, **kwargs):
            new_state, metrics = step(state, *args, **kwargs)
            # the post-round server params (an all-failed round's
            # unchanged ones too); a group's leaves stand for its flat
            # buffer (the zero pad is finite), so nothing is copied
            spec = make_flat_spec(new_state["params"])
            check_flat_groups(
                spec, [[new_state["params"][lf.name] for lf in g.leaves]
                       for g in spec.groups],
                "post-round server params (sync round)",
                round_idx=state["round"])
            return new_state, metrics

    return _chunk_rounds(one_round, rounds_per_call)


def _index(tree, j: int):
    return None if tree is None else {k: v[j] for k, v in tree.items()}


def _stack_metrics(per_round) -> Dict[str, torch.Tensor]:
    """K rounds' metrics -> each metric with a leading K axis, stacked
    where it was computed: on the device if any round computed it there
    (a host number beside it is copied up), else on the host.  Nothing is
    read back."""
    out = {}
    for name in per_round[0]:
        vals = [m[name] for m in per_round]
        dev = next((v for v in vals if isinstance(v, torch.Tensor)), None)
        if dev is None:
            out[name] = torch.from_numpy(np.stack([np.asarray(v)
                                                   for v in vals]))
        else:
            out[name] = torch.stack([
                v if isinstance(v, torch.Tensor) else torch.as_tensor(
                    v, dtype=dev.dtype, device=dev.device) for v in vals])
    return out


def _chunk_rounds(one_round, rounds_per_call: int):
    """The ``rounds_per_call`` wrapper shared by the synchronous round and
    the async tick: K rounds back to back over K-stacked inputs."""
    if rounds_per_call == 1:
        return one_round
    if rounds_per_call < 1:
        raise ValueError(f"rounds_per_call={rounds_per_call} must be >= 1")

    def round_fn(state: State, cohort_batches, meta_batches,
                 client_weights, draws=None):
        per_round = []
        for j in range(rounds_per_call):
            state, m = one_round(state, _index(cohort_batches, j),
                                 _index(meta_batches, j), client_weights[j],
                                 None if draws is None else draws[j])
            per_round.append(m)
        return state, _stack_metrics(per_round)

    return round_fn


class RoundFnCache:
    """Round functions keyed by ``rounds_per_call``, for drivers that mix
    full chunks of K rounds with a tail: ``cache(k)`` is
    ``make_federated_round(model, fed, rounds_per_call=k, **round_kwargs)``,
    built once.  The JAX package's ``donate`` has no torch meaning, so
    there is none: a K-round call's input state stays alive until the call
    returns (its caller holds it), one parameter set more than a K = 1
    call holds from its second round on.
    ``sanitize=True`` builds each function with the NaN/Inf probes and
    wraps it in :func:`repro_torch.core.sanitize.sanitize_round`: the
    call raises :class:`~repro_torch.core.sanitize.SanitizeError` after
    it returns, naming the flat group and the round."""

    def __init__(self, model: Model, fed: FedConfig, *,
                 sanitize: bool = False, **round_kwargs):
        def make(k):
            fn = make_federated_round(model, fed, rounds_per_call=k,
                                      sanitize=sanitize, **round_kwargs)
            return sanitize_round(fn) if sanitize else fn
        self._make = make
        self._fns: Dict[int, Any] = {}

    def __call__(self, k: int):
        if k not in self._fns:
            self._fns[k] = self._make(k)
        return self._fns[k]


def batch_to_device(tree, device):
    """Host batch -> device tensors; integer arrays (tokens, labels) become
    int64, the index type embedding lookups and gathers take."""
    if tree is None:
        return None
    out = {}
    for k, v in tree.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = (t if t.is_floating_point() else t.long()).to(device)
    return out


def stack_round_inputs(cohort_batches, meta_batches, client_weights,
                       draws=None, *, device=None, weights_device=None):
    """K per-round host samples -> the inputs of a ``rounds_per_call=K``
    round function: each batch leaf stacked on a leading K axis on the
    host and sent to ``device`` in one copy (integers as int64), the
    weights ``(K, cohort)`` fp32 on ``weights_device`` (default:
    ``device``), and the K draws as a list (None if there are none)."""
    def stack(trees):
        if trees[0] is None:
            return None
        return batch_to_device({k: np.stack([t[k] for t in trees])
                                for k in trees[0]}, device)

    w = torch.from_numpy(np.stack([np.asarray(x, np.float32)
                                   for x in client_weights]))
    draws = None if draws is None or all(d is None for d in draws) \
        else list(draws)
    return (stack(list(cohort_batches)), stack(list(meta_batches)),
            w.to(device if weights_device is None else weights_device),
            draws)
