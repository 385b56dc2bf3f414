"""Cohort executors (PyTorch port of the flat arms of
``repro/core/executors.py``): HOW a round runs its cohort.  Each yields the
uniform :class:`FlatAggregate` handle the fused engine consumes.

  * ``chunked`` — the chunked streaming core (``FedConfig.cohort_chunk``):
    ``torch.func.vmap`` over a chunk of clients, each client's flat
    gradient streamed into the accumulators by the accumulate kernel in
    global client order, so peak gradient memory is one chunk;
  * ``scan`` — the chunked core pinned at chunk = 1: one client alive at
    a time, run unbatched;
  * ``sharded`` — the two-tier topology over ``torch.distributed``: the
    cohort splits over the mesh's data axis, each process streams its
    clients through the chunked core into partial accumulators (tier 1),
    and one ``all_reduce`` per flat group and of the loss sums them
    (tier 2);
  * ``vmap`` — every client's flat gradient in a ``(cohort, rows, 128)``
    stack, reduced by the aggregate kernel, which also gives ||G||^2.  It
    stays apart from the chunked core (the JAX package subclasses it):
    its clients run one after another, unbatched, into the stack, and the
    core's vmap over a chunk would give them other bits.

All four run a lossy uplink codec too (``run_coded``,
``codec_capabilities`` ``{"none", "lossy"}``): vmap fills its stack and
runs each client's encode/decode over it in cohort order (no aggregate
kernel), the chunked core streams each client through the codec as its
gradient arrives (no accumulate kernel); the decode is the accumulation.

All four also give a :class:`ReweightableCohort` (``reweightable()``),
the differentiable form ``meta_mode='through_aggregation'`` takes its
hypergradients through: vmap runs the clients once and keeps the stack;
the chunked core keeps nothing and re-streams the clients under the new
weights.

``buffered_async`` is the buffered-async runtime's cohort stage: it runs
the clients on a vmap or scan base and hands each client's flat delta to
the delta pool instead of aggregating (``run_deltas``,
``run_deltas_coded``).

Every method takes ``rngs``, the cohort's per-slot dropout masks, or
None (:mod:`repro_torch.core.dropout`).  A factory takes ``(fed)``; the
mesh-aware ones (all the built-in executors) also ``mesh=``.

The tree handle of the ``legacy_tree`` engine is ROADMAP Queue 1 item 9;
the sharded executor's model axis (tensor-parallel client compute) is
item 7b.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Tuple

import torch

from repro_torch.comm.transport import (client_coded_decode,
                                        coded_decode_stacked)
from repro_torch.core.aggregate import (CohortPart,
                                        chunked_cohort_gradient_coded,
                                        chunked_cohort_gradient_flat,
                                        cohort_gradient_stacked,
                                        cohort_gradient_stacked_coded,
                                        scan_cohort_deltas_flat)
from repro_torch.core.flat import FlatSpec, make_flat_spec
from repro_torch.core.registry import Registry
from repro_torch.kernels.fused_update.ops import flat_weighted_aggregate

__all__ = ["FlatAggregate", "ReweightableCohort", "CohortExecutor",
           "ChunkedExecutor", "ShardedExecutor", "BufferedAsyncExecutor",
           "register_executor", "get_executor", "available_executors",
           "resolve_executor"]


@dataclasses.dataclass
class FlatAggregate:
    """Eq. (14) weighted mean in the fused engine's flat layout."""
    groups: List[torch.Tensor]         # per-dtype-group (rows, 128) fp32
    spec: FlatSpec
    sq_norm: Optional[torch.Tensor] = None   # ||G||^2 if pass 1 reduced it


@dataclasses.dataclass
class ReweightableCohort:
    """A cohort whose aggregation can be re-run under other weights.

    ``aggregate(weights)`` is differentiable w.r.t. ``weights`` and returns
    ``(handle, client_loss)``; the loss is weighted by the raw n_k the
    cohort was made with, so it reports the same number whatever weights
    the controllable state chose."""
    aggregate: Callable      # (weights,) -> (handle, client_loss)


class CohortExecutor:
    """Protocol.  Subclass and register a factory ``factory(fed)``."""
    name: str = "?"
    supports_reweight: bool = False
    # the codecs this executor runs: {"none"} is the plain path only;
    # {"none", "lossy"} adds run_coded, a per-client uplink (repro_torch.comm)
    codec_capabilities: frozenset = frozenset({"none"})

    def run(self, client_update: Callable, params, cohort_batch,
            client_weights: torch.Tensor, lr, rngs=None
            ) -> Tuple[FlatAggregate, torch.Tensor]:
        """Run every client and aggregate; returns (handle, client_loss).
        By default the reweightable form aggregated under the n_k."""
        return self.reweightable(client_update, params, cohort_batch,
                                 client_weights, lr, rngs
                                 ).aggregate(client_weights)

    def run_coded(self, client_update: Callable, params, cohort_batch,
                  client_weights: torch.Tensor, lr, *, codec, comm,
                  rngs=None
                  ) -> Tuple[FlatAggregate, torch.Tensor, Optional[dict]]:
        """Run every client, pass each gradient through ``codec``'s encode
        and decode (the uplink) and aggregate the decoded gradients.
        ``comm`` is the error-feedback state (``state["comm"]``, updated in
        place) or None.  Returns (handle, client_loss, new_comm)."""
        if "lossy" not in self.codec_capabilities:
            raise NotImplementedError(
                f"cohort executor {self.name!r} does not support lossy "
                "gradient codecs (declares codec_capabilities="
                f"{sorted(self.codec_capabilities)})")
        spec = make_flat_spec(params)
        Gs, loss, res = self._coded(
            client_update, params, cohort_batch, client_weights, lr,
            spec=spec, codec=codec,
            residuals=None if comm is None else comm["residual"], rngs=rngs)
        return (FlatAggregate(Gs, spec, sq_norm=None), loss,
                None if comm is None else {"residual": res})

    def _coded(self, client_update, params, cohort_batch, client_weights,
               lr, *, spec, codec, residuals, rngs):
        """The coded cohort ``run_coded`` streams through -> (G_groups,
        client_loss, residuals); an executor declaring ``lossy``
        implements it."""
        raise NotImplementedError

    def reweightable(self, client_update: Callable, params, cohort_batch,
                     client_weights: torch.Tensor, lr, rngs=None
                     ) -> ReweightableCohort:
        """Run (or prepare) the cohort so its aggregation can be repeated
        under other weights; ``client_weights`` (n_k) weight the loss."""
        raise NotImplementedError(
            f"cohort executor {self.name!r} has no reweightable form")


_EXECUTORS = Registry("cohort executor",
                      "repro_torch.core.executors.register_executor")


def register_executor(name: str):
    def deco(factory: Callable) -> Callable:
        _EXECUTORS.register(name, factory)
        return factory
    return deco


def get_executor(name: str) -> Callable:
    return _EXECUTORS.get(name)


def available_executors() -> tuple:
    return _EXECUTORS.names()


def resolve_executor(fed, *, executor: Optional[str] = None,
                     mesh=None) -> CohortExecutor:
    """Pick the executor for a round, in the JAX package's order: an
    explicit registry ``executor`` name wins; otherwise a ``mesh``
    (:mod:`repro_torch.launch.mesh`) selects the two-tier sharded
    executor, ``fed.cohort_chunk`` the chunked streaming executor, and
    ``fed.cohort_strategy`` vmap / scan / chunked."""
    if executor is None:
        if mesh is not None:
            executor = "sharded"
        elif fed.cohort_chunk is not None:
            executor = "chunked"
        else:
            executor = fed.cohort_strategy
    elif mesh is not None and executor != "sharded":
        # an explicit override would silently drop the mesh: only the
        # 'sharded' executor splits the cohort over the mesh's data axis
        # and reduces the partial accumulators; any other executor would
        # run the whole cohort on every process.  Fail loudly instead
        raise ValueError(
            f"a mesh is set but executor={executor!r} was explicitly "
            "requested; only the 'sharded' executor honors the mesh "
            "(two-tier aggregation over torch.distributed). Drop the "
            "executor override (the mesh selects it automatically) or "
            "drop the mesh.")
    factory = get_executor(executor)
    # a factory takes (fed); only the mesh-aware ones take mesh= too
    return factory(fed) if mesh is None else factory(fed, mesh=mesh)


@register_executor("vmap")
class VmapExecutor(CohortExecutor):
    """Client-parallel: the whole cohort's gradients stacked, then one
    aggregate-kernel sweep that also reduces ||G||^2 for the clip."""
    name = "vmap"
    supports_reweight = True
    codec_capabilities = frozenset({"none", "lossy"})

    def __init__(self, fed: Any, *, mesh=None):
        del fed, mesh

    def _coded(self, client_update, params, cohort_batch, client_weights,
               lr, *, spec, codec, residuals, rngs):
        return cohort_gradient_stacked_coded(
            client_update, params, cohort_batch, client_weights, lr,
            spec=spec, codec=codec, residuals=residuals, rngs=rngs)

    def reweightable(self, client_update, params, cohort_batch,
                     client_weights, lr, rngs=None):
        # the clients run once here (the loss is already n_k-weighted);
        # aggregate() only re-reduces the kept stack under new weights,
        # differentiably through the aggregate kernel's backward
        spec = make_flat_spec(params)
        stacks, loss = cohort_gradient_stacked(
            client_update, params, cohort_batch, client_weights, lr,
            spec=spec, rngs=rngs)

        def aggregate(weights):
            Gs, ssq = flat_weighted_aggregate(spec, stacks, weights)
            return FlatAggregate(Gs, spec, sq_norm=ssq), loss

        return ReweightableCohort(aggregate=aggregate)


@register_executor("chunked")
class ChunkedExecutor(CohortExecutor):
    """The chunked streaming core: ``cohort_chunk`` clients vmap per chunk,
    each client's flat gradient streamed into the group accumulators by
    the accumulate kernel in global client order, so peak gradient memory
    is one chunk and the accumulation order does not depend on the chunk
    size.  Nothing is kept for reweighting: each ``aggregate()``
    re-streams the chunks, and its backward re-runs them once more, one
    chunk at a time.  scan and sharded subclass it."""
    name = "chunked"
    supports_reweight = True
    codec_capabilities = frozenset({"none", "lossy"})

    def __init__(self, fed: Any, *, mesh=None):
        del mesh
        self._chunk = (None if fed.cohort_chunk is None
                       else int(fed.cohort_chunk))

    def _chunk_for(self, cohort: int) -> int:
        return cohort if self._chunk is None else self._chunk

    # -- the streaming primitives subclasses override ----------------------
    def _flat(self, client_update, params, cohort_batch, client_weights,
              lr, *, spec, loss_weights=None, rngs=None):
        return chunked_cohort_gradient_flat(
            client_update, params, cohort_batch, client_weights, lr,
            spec=spec, chunk=self._chunk_for(client_weights.shape[0]),
            loss_weights=loss_weights, rngs=rngs)

    def _coded(self, client_update, params, cohort_batch, client_weights,
               lr, *, spec, codec, residuals, rngs):
        return chunked_cohort_gradient_coded(
            client_update, params, cohort_batch, client_weights, lr,
            spec=spec, chunk=self._chunk_for(client_weights.shape[0]),
            codec=codec, residuals=residuals, rngs=rngs)

    def run(self, client_update, params, cohort_batch, client_weights, lr,
            rngs=None):
        spec = make_flat_spec(params)
        Gs, loss = self._flat(client_update, params, cohort_batch,
                              client_weights, lr, spec=spec, rngs=rngs)
        return FlatAggregate(Gs, spec, sq_norm=None), loss

    def reweightable(self, client_update, params, cohort_batch,
                     client_weights, lr, rngs=None):
        spec = make_flat_spec(params)

        def aggregate(weights):
            Gs, loss = self._flat(client_update, params, cohort_batch,
                                  weights, lr, spec=spec,
                                  loss_weights=client_weights, rngs=rngs)
            return FlatAggregate(Gs, spec, sq_norm=None), loss

        return ReweightableCohort(aggregate=aggregate)


@register_executor("scan")
class ScanExecutor(ChunkedExecutor):
    """Client-sequential: the chunked core pinned at chunk = 1, each
    client run unbatched, one trajectory alive at a time."""
    name = "scan"

    def __init__(self, fed: Any, *, mesh=None):
        super().__init__(fed, mesh=mesh)
        self._chunk = 1


@register_executor("sharded")
class ShardedExecutor(ChunkedExecutor):
    """Two-tier aggregation over the processes of a
    :class:`repro_torch.sharding.specs.Mesh` (``torch.distributed``, one
    device a process).

    The cohort is padded to a multiple of the data axis with weight-0
    replicas of client 0 and split into contiguous slices
    (:func:`repro_torch.sharding.specs.cohort_split`).  Tier 1: each
    process streams its slice through the chunked core into partial flat
    accumulators, the weights normalized over the WHOLE cohort first, so
    the partials sum to Eq. (14) exactly.  Tier 2: one ``all_reduce(SUM)``
    of each flat group and of the loss over the data axis.

    Because tier 1 is the chunked core, the topology supports what the
    chunked executor does: ``through_aggregation`` (G is replicated after
    tier 2, so is dG; each process re-runs its own clients for their
    ``dw_k`` and an ``all_gather`` returns the cohort's in client order)
    and lossy codecs (a client's error-feedback residual is updated on
    the process that runs it, then broadcast from there, so every process
    holds the cohort's residual state in cohort order for the server
    state and checkpoints).

    A model axis of more than one process (tensor-parallel client
    compute) is ROADMAP Queue 1 item 7b and raises.  Without a mesh the
    executor is the chunked core of one process, as in the JAX package."""
    name = "sharded"

    def __init__(self, fed: Any, *, mesh=None):
        super().__init__(fed)
        self._mesh = mesh
        if mesh is not None and mesh.shape.get("model", 1) > 1:
            raise NotImplementedError(
                f"--executor sharded on a mesh with model axis "
                f"{mesh.shape['model']}: tensor-parallel client compute "
                "(param_spec, set_activation_spec, set_expert_axis, "
                "constrain_groups, with_pspecs) is not yet ported to "
                "repro_torch (ROADMAP Queue 1 item 7b); use --mesh-model 1")

    def _part(self, cohort: int):
        """(n_slots, CohortPart) of this process's data coordinate."""
        from repro_torch.sharding.specs import cohort_split
        mesh = self._mesh
        per_shard, n_slots = cohort_split(cohort, mesh)
        start = mesh.coords["data"] * per_shard
        group = mesh.groups["data"]

        def reduce(tensors):
            for t in tensors:
                torch.distributed.all_reduce(
                    t, op=torch.distributed.ReduceOp.SUM, group=group)

        def gather(dw):
            parts = [torch.empty_like(dw) for _ in range(mesh.shape["data"])]
            torch.distributed.all_gather(parts, dw.contiguous(), group=group)
            return torch.cat(parts)

        return n_slots, CohortPart(start, start + per_shard, reduce, gather)

    def _flat(self, client_update, params, cohort_batch, client_weights,
              lr, *, spec, loss_weights=None, rngs=None):
        if self._mesh is None:
            return super()._flat(client_update, params, cohort_batch,
                                 client_weights, lr, spec=spec,
                                 loss_weights=loss_weights, rngs=rngs)
        cohort = client_weights.shape[0]
        n_slots, part = self._part(cohort)
        return chunked_cohort_gradient_flat(
            client_update, params, cohort_batch, client_weights, lr,
            spec=spec, chunk=self._chunk_for(cohort),
            loss_weights=loss_weights, rngs=rngs, n_slots=n_slots,
            part=part)

    def _coded(self, client_update, params, cohort_batch, client_weights,
               lr, *, spec, codec, residuals, rngs):
        if self._mesh is None:
            return super()._coded(client_update, params, cohort_batch,
                                  client_weights, lr, spec=spec, codec=codec,
                                  residuals=residuals, rngs=rngs)
        cohort = client_weights.shape[0]
        n_slots, part = self._part(cohort)
        Gs, loss, res = chunked_cohort_gradient_coded(
            client_update, params, cohort_batch, client_weights, lr,
            spec=spec, chunk=self._chunk_for(cohort), codec=codec,
            residuals=residuals, rngs=rngs, n_slots=n_slots, part=part)
        if res is not None:
            # each client's row from the process that coded it, in place
            mesh, per_shard = self._mesh, part.stop - part.start
            for k in range(cohort):
                src = mesh.rank_of(data=k // per_shard)
                for stack in res:
                    torch.distributed.broadcast(stack[k], src=src,
                                                group=mesh.groups["data"])
        return Gs, loss, res


@register_executor("buffered_async")
class BufferedAsyncExecutor(CohortExecutor):
    """The buffered-async runtime's cohort stage: the local updates run on
    the base strategy ``fed.cohort_strategy`` (vmap or scan), and each
    client's flat delta goes to the delta pool
    (:mod:`repro_torch.core.async_round`) instead of into an aggregate.
    Not a synchronous executor: :meth:`run` raises.

    ``out(k)`` names where client k's delta goes: per-group ``(rows, 128)``
    buffers (a pool slot), or None for a delta the pool does not keep.
    The vmap base fills its ``(cohort, rows, 128)`` stack as the
    synchronous vmap cohort does and copies each kept delta into its
    slot; the scan base writes each delta straight into its slot as the
    client finishes."""
    name = "buffered_async"
    supports_reweight = False
    codec_capabilities = frozenset({"none", "lossy"})

    def __init__(self, fed: Any, *, mesh=None, grad_shardings=None):
        if mesh is not None:
            raise ValueError(
                "the buffered_async executor keeps a replicated delta pool "
                "(per-client staleness slots); it does not split the "
                "cohort over a mesh. Drop the mesh or use a synchronous "
                "engine")
        if grad_shardings is not None:
            raise ValueError(
                "the buffered_async executor keeps a replicated delta pool "
                "(per-client staleness slots), so per-leaf grad_shardings "
                "cannot apply; drop grad_shardings or use a synchronous "
                "engine")
        if getattr(fed, "cohort_chunk", None) is not None:
            raise ValueError(
                "cohort_chunk streams clients through an aggregate "
                "accumulator, but the buffered_async executor must keep "
                "every client's delta individually for the staleness pool "
                "— there is nothing to chunk. Drop cohort_chunk or use a "
                "synchronous engine.")
        if fed.cohort_strategy not in ("vmap", "scan"):
            raise ValueError(
                "the buffered_async executor wraps a base cohort_strategy "
                f"of 'vmap' or 'scan', got {fed.cohort_strategy!r}")
        self._base = fed.cohort_strategy

    def run(self, *args, **kwargs):
        raise NotImplementedError(
            "the buffered_async executor produces per-client deltas for the "
            "async tick (repro_torch.core.async_round), not a synchronous "
            "aggregate; select engine='buffered_async' so the round "
            "builder routes through it")

    def run_deltas(self, client_update, params, cohort_batch,
                   client_weights, lr, *, spec, out: Callable, rngs=None
                   ) -> torch.Tensor:
        """Run every client, each delta to ``out(k)``; returns the client
        loss weighted by ``client_weights`` (aggregation weights are the
        pool's, at flush time)."""
        if self._base == "scan":
            return scan_cohort_deltas_flat(
                client_update, params, cohort_batch, client_weights, lr,
                spec=spec, out=out, rngs=rngs)
        stacks, loss = cohort_gradient_stacked(
            client_update, params, cohort_batch, client_weights, lr,
            spec=spec, rngs=rngs)
        _deliver(stacks, out)
        return loss

    def run_deltas_coded(self, client_update, params, cohort_batch,
                         client_weights, lr, *, spec, codec, comm,
                         out: Callable, rngs=None
                         ) -> Tuple[torch.Tensor, Optional[dict]]:
        """:meth:`run_deltas` with the lossy uplink: each delta is encoded
        (against its ``state["comm"]`` residual, updated in place) and
        decoded before it is pooled — the pool keeps what the server
        received.  Returns (client loss, new comm state)."""
        res = None if comm is None else comm["residual"]
        new_comm = None if comm is None else {"residual": tuple(res)}
        if self._base == "vmap":
            stacks, loss = cohort_gradient_stacked(
                client_update, params, cohort_batch, client_weights, lr,
                spec=spec, rngs=rngs)
            coded_decode_stacked(codec, spec, stacks, client_weights, res)
            _deliver(stacks, out)
            return loss, new_comm
        w32 = client_weights.to(torch.float32)

        def finish(k, bufs):
            client_coded_decode(codec, spec, bufs, w32[k],
                                None if res is None else [r[k] for r in res])

        loss = scan_cohort_deltas_flat(
            client_update, params, cohort_batch, client_weights, lr,
            spec=spec, out=out, finish=finish, rngs=rngs)
        return loss, new_comm


def _deliver(stacks, out: Callable) -> None:
    """Copy client k's slot of the ``(cohort, rows, 128)`` stacks into
    ``out(k)`` where the pool keeps it."""
    for k in range(stacks[0].shape[0]):
        dest = out(k)
        if dest is not None:
            for d, st in zip(dest, stacks):
                d.copy_(st[k])
