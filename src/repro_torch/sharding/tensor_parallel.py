"""Tensor-parallel client compute over the mesh's model axis (it has no
JAX counterpart: there GSPMD partitions the client update from the
placements of :mod:`repro_torch.sharding.specs`).

A process of a model group holds, of each parameter, the part its
model-axis placement gives it (:func:`shard_params`): the column-split
``wq``/``wk``/``wv``/``w_gate``/``w_up``, the row-split ``wo``/``w_down``,
the vocab-split embedding, whole norm scales, and whole any leaf whose dim
the axis does not divide.  The dense layer runs on those shards
(``models/layers.py``, ``models/attention.py``, ``models/transformer.py``
take a :class:`ModelAxis` as ``tp``) with the collectives as
``torch.autograd.Function``s, so ``torch.func.grad``, ``jvp`` (the UGA
client's Hessian-vector products are jvp over grad) and ``vmap`` (the
chunked cohort) all pass through them:

  * :class:`CopyToModel` — identity forward, all-reduce backward (a
    replicated input entering split compute);
  * :class:`ReduceFromModel` — all-reduce forward, identity backward (the
    partial sums of a row-split product);
  * :class:`GatherFromModel` — all-gather along a dim forward, this
    process's part of the cotangent backward (split parts becoming
    replicated compute);
  * :class:`SplitToModel` — this process's part forward, all-gather
    backward (replicated compute entering a row-split product).

Each ``backward`` calls its conjugate Function's ``apply`` (never a raw
collective), so a backward is itself forward-differentiable; each
``jvp`` runs the same collective on the tangent; each ``vmap`` rule runs
the collective on the batched tensor, which is valid because every
process of a model group runs the same clients.  The collective acts on
a copy, never on its input.  Replicated tensors carry complete
cotangents on every process, split ones the complete cotangent of their
part.

The vocab-split pieces: :func:`vocab_embed` (the lookup, masked to this
process's rows, then summed), :func:`vocab_xent` (the logsumexp as an
all-reduce MAX of the detached max, then a SUM; the gold logit summed
from its owner; the argmax behind ``acc`` with ``torch.argmax``'s
first-index rule across processes: all-reduce MAX of the value, then MIN
of the index among the processes that hold it).

:class:`ModelAxis` also carries weights across (:func:`shard_params`,
:func:`gather_params`, bitwise) and writes a client's gradient shards
into the global flat layout, each element by its owner only
(:meth:`ModelAxis.flatten_into`): a replicated leaf by model coordinate
0, so the sum over the model axis is exact (x + 0 = x).

Every layer kind of the LM stack runs on the axis (the models' docstrings
say how): GQA attention on each process's heads where the axis divides
them, else q/k/v gathered to whole heads; MLA on each process's heads;
the MoE experts split, the routing replicated from the gathered router
weight; the Mamba2 mixer on each process's heads, its projection and
conv weight gathered whole; the encoder and the cross layers; the GELU
MLP split.  A leaf the axis leaves whole (a dim it does not divide, as
JAX's ``_maybe`` leaves it) runs whole.  One rule keeps the gradients of
whole leaves exact: replicated compute that feeds a process's own part
of the work (its heads, its experts) enters it through ``copy`` (or, a
whole leaf sliced to that part, ``split``), so its cotangent, and every
whole leaf's gradient upstream of it, is whole on every process.

Every synchronous mode runs on the axis: ``meta_mode='post'`` and
``'through_aggregation'`` (the server step on each process's rows is
differentiable: :func:`repro_torch.core.flat.constrain_groups` is a
``split``, :func:`~repro_torch.core.flat.gather_groups` a ``gather``, and
the step's scalars enter the split rows through ``copy``, so their
cotangents, partial over a process's rows, are summed over the axis), the
lossy uplink codecs with and without error feedback (each group's
statistic reduced over the axis, the decode and the residual kept only
where the process owns the element: :meth:`ModelAxis.ownership`), and
both engines, ``fused_flat`` and ``legacy_tree``.  The buffered-async
runtime runs on no mesh, as in the JAX package, whose
``make_federated_round`` refuses it beside the sharded executor's
``grad_shardings`` (:func:`repro_torch.core.round.refuse_async_on_mesh`).
A model that is not a transformer config raises, naming ROADMAP Queue 1
item 7d (:func:`check_supported`).

Serving runs on the axis too (the prefill and the decode step of
``models/transformer.py``, given a :class:`ModelAxis` built by
:func:`serve_axis`): the prefill on each process's shards, as training
runs, returning this process's part of the decode cache as
:func:`repro_torch.sharding.specs.cache_shardings` places it; the decode
step against that part.  :class:`Serving` holds what the placement needs
(the mesh, the request's global batch, the cache's whole length), and
:class:`SeqSplit` a cache's sequence axis split over processes: the
owner of a slot, and the group over which the online-softmax partials
of a split sequence merge (``model``, or ``data`` at B = 1).

On two processes sharing a card (the mesh's shared-card rule) the group
is gloo, which carries CUDA tensors through host memory itself: every
collective the slice needs has its CUDA form there
(``tools/tp_collectives.py`` checks them on the card), and staging them
by hand was no faster (``PERF.md`` §7), so the collectives take the
tensors as they are.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.sharding.specs import (Mesh, Placement, cache_shardings,
                                        local_slices, model_axis_placement,
                                        model_size, param_spec,
                                        simple_batch_shardings, tree_paths)

ITEM_7D = "ROADMAP Queue 1 item 7d"


# ---------------------------------------------------------------------------
# The collectives on plain tensors
# ---------------------------------------------------------------------------
def all_reduce_copy(x: torch.Tensor, group, op=dist.ReduceOp.SUM
                    ) -> torch.Tensor:
    """A new tensor: ``x`` reduced over ``group``."""
    y = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=op, group=group)
    return y


def all_gather_cat(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every process's ``x`` concatenated along ``dim``, in group rank
    (model coordinate) order."""
    n = dist.get_world_size(group)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim)


def _part(x: torch.Tensor, dim: int, coord: int, n: int) -> torch.Tensor:
    per = x.shape[dim] // n
    return x.narrow(dim, coord * per, per).contiguous()


# ---------------------------------------------------------------------------
# The collectives as autograd Functions
# ---------------------------------------------------------------------------
def _bdim_front(x, bdim):
    return x if bdim is None else x.movedim(bdim, 0)


def _shifted(dim: int, ndim_logical: int, bdim) -> int:
    """A logical dim's index in the physical tensor with its batch dim
    moved to the front."""
    d = dim % ndim_logical
    return d if bdim is None else d + 1


class CopyToModel(torch.autograd.Function):
    """Identity forward, all-reduce backward."""

    @staticmethod
    def forward(x, axis):
        return x.view_as(x)         # no copy: the identity

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.axis = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return ReduceFromModel.apply(g, ctx.axis), None

    @staticmethod
    def jvp(ctx, x_t, _):
        return CopyToModel.apply(x_t, ctx.axis)

    @staticmethod
    def vmap(info, in_dims, x, axis):
        return CopyToModel.apply(x, axis), in_dims[0]


class ReduceFromModel(torch.autograd.Function):
    """All-reduce (sum) forward, identity backward."""

    @staticmethod
    def forward(x, axis):
        return all_reduce_copy(x, axis.group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.axis = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return CopyToModel.apply(g, ctx.axis), None

    @staticmethod
    def jvp(ctx, x_t, _):
        return ReduceFromModel.apply(x_t, ctx.axis)

    @staticmethod
    def vmap(info, in_dims, x, axis):
        return ReduceFromModel.apply(x, axis), in_dims[0]


class GatherFromModel(torch.autograd.Function):
    """All-gather along ``dim`` forward; this process's part of the
    cotangent backward."""

    @staticmethod
    def forward(x, dim, axis):
        return all_gather_cat(x, dim, axis.group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.dim, ctx.axis = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        return SplitToModel.apply(g, ctx.dim, ctx.axis), None, None

    @staticmethod
    def jvp(ctx, x_t, _, __):
        return GatherFromModel.apply(x_t, ctx.dim, ctx.axis)

    @staticmethod
    def vmap(info, in_dims, x, dim, axis):
        bdim = in_dims[0]
        d = _shifted(dim, x.dim() - (bdim is not None), bdim)
        out = GatherFromModel.apply(_bdim_front(x, bdim), d, axis)
        return out, (None if bdim is None else 0)


class SplitToModel(torch.autograd.Function):
    """This process's part along ``dim`` forward; all-gather backward."""

    @staticmethod
    def forward(x, dim, axis):
        return _part(x, dim, axis.coord, axis.size)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.dim, ctx.axis = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        return GatherFromModel.apply(g, ctx.dim, ctx.axis), None, None

    @staticmethod
    def jvp(ctx, x_t, _, __):
        return SplitToModel.apply(x_t, ctx.dim, ctx.axis)

    @staticmethod
    def vmap(info, in_dims, x, dim, axis):
        bdim = in_dims[0]
        d = _shifted(dim, x.dim() - (bdim is not None), bdim)
        out = SplitToModel.apply(_bdim_front(x, bdim), d, axis)
        return out, (None if bdim is None else 0)


# The row split of a client's residual stream (the eager meaning of JAX's
# ``set_activation_spec``): dim 0 (the client's batch rows) of ``b`` rows
# in ``size`` parts of ``r = ceil(b / size)`` rows, this process's part
# rows [coord r, coord r + r); the last parts pad with zero rows past b.
def _rows_of(b: int, n: int) -> int:
    return -(-b // n)


def _pad_rows(x: torch.Tensor, dim: int, rows: int) -> torch.Tensor:
    extra = rows - x.shape[dim]
    if extra == 0:
        return x
    pad = [0, 0] * (x.dim() - 1 - dim) + [0, extra]
    return F.pad(x, pad)


def _own_rows(x: torch.Tensor, dim: int, b: int, axis) -> torch.Tensor:
    r = _rows_of(b, axis.size)
    return _pad_rows(x, dim, r * axis.size).narrow(
        dim, axis.coord * r, r).contiguous()


def _gather_rows(x: torch.Tensor, dim: int, b: int, axis) -> torch.Tensor:
    return all_gather_cat(x, dim, axis.group).narrow(dim, 0, b)


def _reduce_scatter_rows(x: torch.Tensor, dim: int, b: int, axis
                         ) -> torch.Tensor:
    r = _rows_of(b, axis.size)
    full = _pad_rows(x, dim, r * axis.size).movedim(dim, 0).contiguous()
    out = full.new_empty((r,) + tuple(full.shape[1:]))
    dist.reduce_scatter(out, list(full.split(r)), group=axis.group)
    return out.movedim(0, dim)


class GatherRows(torch.autograd.Function):
    """A row-split tensor (this process's ``r`` rows along ``dim``, of
    ``b`` in all) whole on every process: all-gather forward; this
    process's rows of the (complete) cotangent backward.  A row-split
    sublayer's entry."""

    @staticmethod
    def forward(x, dim, b, axis):
        return _gather_rows(x, dim, b, axis)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.dim, ctx.b, ctx.axis = inputs[1], inputs[2], inputs[3]

    @staticmethod
    def backward(ctx, g):
        return SplitRows.apply(g, ctx.dim, ctx.b, ctx.axis), None, None, None

    @staticmethod
    def jvp(ctx, x_t, *_):
        return GatherRows.apply(x_t, ctx.dim, ctx.b, ctx.axis)

    @staticmethod
    def vmap(info, in_dims, x, dim, b, axis):
        bdim = in_dims[0]
        d = _shifted(dim, x.dim() - (bdim is not None), bdim)
        out = GatherRows.apply(_bdim_front(x, bdim), d, b, axis)
        return out, (None if bdim is None else 0)


class SplitRows(torch.autograd.Function):
    """A whole tensor's rows of this process (zero rows past ``b``):
    this process's part forward; all-gather backward."""

    @staticmethod
    def forward(x, dim, b, axis):
        return _own_rows(x, dim, b, axis)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.dim, ctx.b, ctx.axis = inputs[1], inputs[2], inputs[3]

    @staticmethod
    def backward(ctx, g):
        return GatherRows.apply(g, ctx.dim, ctx.b, ctx.axis), None, None, None

    @staticmethod
    def jvp(ctx, x_t, *_):
        return SplitRows.apply(x_t, ctx.dim, ctx.b, ctx.axis)

    @staticmethod
    def vmap(info, in_dims, x, dim, b, axis):
        bdim = in_dims[0]
        d = _shifted(dim, x.dim() - (bdim is not None), bdim)
        out = SplitRows.apply(_bdim_front(x, bdim), d, b, axis)
        return out, (None if bdim is None else 0)


class ReduceScatterRows(torch.autograd.Function):
    """Partial sums of a whole tensor summed over the axis, this
    process's rows of the sum kept: reduce-scatter forward; all-gather of
    the rows' cotangents backward (the complete cotangent of every
    process's partial sum).  A row-split sublayer's exit."""

    @staticmethod
    def forward(x, dim, b, axis):
        return _reduce_scatter_rows(x, dim, b, axis)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.dim, ctx.b, ctx.axis = inputs[1], inputs[2], inputs[3]

    @staticmethod
    def backward(ctx, g):
        return GatherRows.apply(g, ctx.dim, ctx.b, ctx.axis), None, None, None

    @staticmethod
    def jvp(ctx, x_t, *_):
        return ReduceScatterRows.apply(x_t, ctx.dim, ctx.b, ctx.axis)

    @staticmethod
    def vmap(info, in_dims, x, dim, b, axis):
        bdim = in_dims[0]
        d = _shifted(dim, x.dim() - (bdim is not None), bdim)
        out = ReduceScatterRows.apply(_bdim_front(x, bdim), d, b, axis)
        return out, (None if bdim is None else 0)


class _ReduceConstant(torch.autograd.Function):
    """All-reduce by ``op`` (MAX, MIN) of a value with no derivative
    (the logsumexp's shift, the argmax)."""

    @staticmethod
    def forward(x, op, axis):
        return all_reduce_copy(x, axis.group, op)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output)

    @staticmethod
    def backward(ctx, g):
        return None, None, None

    @staticmethod
    def jvp(ctx, x_t, _, __):
        return torch.zeros_like(x_t)

    @staticmethod
    def vmap(info, in_dims, x, op, axis):
        return _ReduceConstant.apply(x, op, axis), in_dims[0]


# ---------------------------------------------------------------------------
# The model axis of one process
# ---------------------------------------------------------------------------
@dataclasses.dataclass(eq=False)
class ModelAxis:
    """This process's place on the model axis: its group, size and
    coordinate, and each parameter's model-axis placement (its
    :func:`repro_torch.sharding.specs.param_spec`'s model entries)."""
    group: Any
    size: int
    coord: int
    placements: Dict[str, tuple] = dataclasses.field(default_factory=dict)
    serving: Optional["Serving"] = None      # set by :func:`serve_axis`
    # the residual stream of a client held as this process's rows between
    # sublayers (set_activation_spec; the module docstring)
    act_rows: bool = False
    _rows_b: Optional[int] = dataclasses.field(default=None, repr=False)
    _left: bool = dataclasses.field(default=False, repr=False)

    # -- collectives (differentiable) -----------------------------------
    def copy(self, x):
        return CopyToModel.apply(x, self)

    def reduce(self, x):
        return ReduceFromModel.apply(x, self)

    def gather(self, x, dim: int):
        return GatherFromModel.apply(x, dim, self)

    def split(self, x, dim: int):
        return SplitToModel.apply(x, dim, self)

    def max(self, x):
        return _ReduceConstant.apply(x, dist.ReduceOp.MAX, self)

    # -- the row split of the residual stream (act_rows) ------------------
    def rows(self, x, b: int):
        """This process's rows of the whole (b, ...) ``x``."""
        return SplitRows.apply(x, 0, b, self)

    def gather_rows(self, x, b: int):
        """The whole (b, ...) tensor from every process's rows."""
        return GatherRows.apply(x, 0, b, self)

    def leave(self, x):
        """A sublayer's partial output summed over the axis: all-reduced
        (the replicated residual stream), or inside :meth:`row_sublayer`
        reduce-scattered to this process's rows."""
        if self._rows_b is None:
            return self.reduce(x)
        self._left = True
        return ReduceScatterRows.apply(x, 0, self._rows_b, self)

    def row_sublayer(self, x_rows, b: int, sublayer):
        """``sublayer(x)`` of a row-split residual stream: its input
        gathered whole (the entry), its output this process's rows (the
        exit): reduce-scattered where the sublayer ends in :meth:`leave`,
        else (an output computed whole) its rows taken."""
        self._rows_b, self._left = b, False
        try:
            y = sublayer(self.gather_rows(x_rows, b))
        finally:
            self._rows_b = None
        out = y if self._left else self.rows(y, b)
        self._left = False
        return out

    def min(self, x):
        return _ReduceConstant.apply(x, dist.ReduceOp.MIN, self)

    def is_split(self, local: int, full: int) -> bool:
        """Whether a dim of ``full`` elements that this process holds
        ``local`` of is split over the axis (else whole)."""
        if local == full:
            return False
        assert local * self.size == full, (local, full, self.size)
        return True

    # -- weights ----------------------------------------------------------
    def slices(self, name: str, shape) -> Tuple[slice, ...]:
        pl = self.placements[name]
        return local_slices(pl, shape, _axis_mesh(self))

    def shard(self, params: Dict[str, torch.Tensor]
              ) -> Dict[str, torch.Tensor]:
        """This process's part of each parameter (a copy of it)."""
        return {n: p[self.slices(n, p.shape)].contiguous()
                for n, p in params.items()}

    def gather_params(self, shards: Dict[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
        """The whole parameters from every process's shards (bitwise)."""
        out = {}
        for n, s in shards.items():
            dims = [d for d, e in enumerate(self.placements[n])
                    if e is not None]
            out[n] = (all_gather_cat(s, dims[0], self.group) if dims
                      else s.clone())
        return out

    def _owned(self, leaf, flat: torch.Tensor) -> Optional[torch.Tensor]:
        """The elements of ``leaf`` this process owns, a view into its
        group's flat buffer ``flat``: its part of a split leaf, a
        replicated leaf on model coordinate 0; None elsewhere."""
        whole = flat[leaf.offset:leaf.offset + leaf.size].view(leaf.shape)
        if any(e is not None for e in self.placements[leaf.name]):
            return whole[self.slices(leaf.name, leaf.shape)]
        return whole if self.coord == 0 else None

    def flatten_into(self, spec, shards: Dict[str, torch.Tensor],
                     out: Sequence[torch.Tensor]) -> list:
        """A client's gradient shards into the GLOBAL flat layout ``out``
        (``(rows, 128)`` per group, :mod:`repro_torch.core.flat`): each
        element this process owns at its place, every other one (the
        other processes' parts, a replicated leaf off model coordinate 0,
        the pad) zero."""
        for g, buf in zip(spec.groups, out):
            buf.zero_()
            flat = buf.view(-1)
            for leaf in g.leaves:
                dst = self._owned(leaf, flat)
                if dst is not None:
                    dst.copy_(shards[leaf.name])
        return list(out)

    def ownership(self, spec, device=None) -> list:
        """One ``(rows, 128)`` fp32 buffer per flat group of ``spec``: 1
        where :meth:`flatten_into` writes this process's elements, 0
        elsewhere (the pad too).  The masks of the processes of a model
        group sum to 1 at every element but the pad: what the codecs'
        decode and residual are masked by, taken from the placement,
        never from the values."""
        out = []
        for g in spec.groups:
            buf = torch.zeros((g.rows, 128), dtype=torch.float32,
                              device=device)
            flat = buf.view(-1)
            for leaf in g.leaves:
                dst = self._owned(leaf, flat)
                if dst is not None:
                    dst.fill_(1.0)
            out.append(buf)
        return out

    def all_reduce_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Sum each tensor over the model axis, in place."""
        for t in tensors:
            t.copy_(all_reduce_copy(t, self.group))


def row_axis(mesh: Mesh) -> ModelAxis:
    """``mesh``'s model axis without parameter placements: what the flat
    buffers' row split over it (the server step's rows) needs."""
    return ModelAxis(mesh.groups["model"], mesh.shape["model"],
                     mesh.coords["model"])


def _axis_mesh(axis: ModelAxis) -> Mesh:
    return Mesh(("model",), {"model": axis.size}, {"model": axis.coord},
                {"model": axis.group}, torch.device("cpu"))


# JAX's ``set_activation_spec`` hint, a property of the launch: whether a
# client's residual stream is split over the model axis (True: this
# process's batch rows between sublayers) or replicated on it
ACT_ROWS = False


def set_activation_spec(on: bool) -> None:
    """The model axis's activation placement for the axes
    :func:`model_axis` builds from now on (the dry run's ``--act-spec``)."""
    global ACT_ROWS
    ACT_ROWS = bool(on)


def model_axis(mesh: Optional[Mesh], params_shape) -> Optional[ModelAxis]:
    """The :class:`ModelAxis` of this process on ``mesh`` for parameters
    shaped as ``params_shape`` (a name -> tensor dict), or None without a
    model axis above 1.  The cohort strategy moves only the FSDP entries
    of a placement, which the model axis drops.  Its ``act_rows`` is the
    :func:`set_activation_spec` hint's."""
    if model_size(mesh) <= 1:
        return None
    return ModelAxis(mesh.groups["model"], mesh.shape["model"],
                     mesh.coords["model"], _placements(mesh, params_shape),
                     act_rows=ACT_ROWS)


def _placements(mesh: Mesh, params_shape) -> Dict[str, Placement]:
    """Each parameter's model-axis placement, by the port's name."""
    names = {n.replace(".", "/"): n for n in params_shape}
    return {names[path]: model_axis_placement(
        param_spec(path, tuple(leaf.shape), mesh))
        for path, leaf in tree_paths(params_shape)}


def shard_params(params: Dict[str, torch.Tensor], mesh: Mesh
                 ) -> Dict[str, torch.Tensor]:
    """The port's whole parameters (e.g. ``bridge.to_torch`` of JAX's) ->
    this process's model-axis shards."""
    return model_axis(mesh, params).shard(params)


def gather_params(shards: Dict[str, torch.Tensor], mesh: Mesh,
                  params_shape) -> Dict[str, torch.Tensor]:
    """:func:`shard_params`'s inverse over the model axis, bitwise;
    ``params_shape`` (the whole parameters, or ``meta`` stand-ins) names
    each leaf's placement, which a shard's shape alone does not."""
    return model_axis(mesh, params_shape).gather_params(shards)


# ---------------------------------------------------------------------------
# The vocab-split pieces
# ---------------------------------------------------------------------------
def vocab_embed(tokens: torch.Tensor, embed: torch.Tensor,
                axis: ModelAxis) -> torch.Tensor:
    """The embedding lookup over this process's rows of the vocab-split
    table (rows ``[coord * V_loc, (coord + 1) * V_loc)``), zero for the
    tokens another process holds, summed over the axis."""
    v_loc = embed.shape[0]
    lo = axis.coord * v_loc
    mine = (tokens >= lo) & (tokens < lo + v_loc)
    h = F.embedding(torch.where(mine, tokens - lo, 0), embed)
    return axis.reduce(h * mine[..., None].to(h.dtype))


def vocab_xent(h: torch.Tensor, head: torch.Tensor, labels: torch.Tensor,
               mask: torch.Tensor, axis: ModelAxis):
    """Over one chunk of positions: h (B, C, d) replicated, head (d,
    V_loc) this process's vocab columns, labels (B, C), mask (B, C) ->
    (the masked sum of the token NLLs, the masked count of argmax hits),
    both replicated.  The logsumexp, gold logit and argmax are those of
    the whole vocab."""
    v_loc = head.shape[-1]
    lo = axis.coord * v_loc
    logits = (axis.copy(h) @ head).to(torch.float32)
    top = torch.amax(logits.detach(), dim=-1)
    m = axis.max(top)
    s = axis.reduce(torch.sum(torch.exp(logits - m[..., None]), dim=-1))
    logz = m + torch.log(s)
    mine = (labels >= lo) & (labels < lo + v_loc)
    gold_loc = torch.gather(logits, -1, torch.where(
        mine, labels - lo, 0)[..., None])[..., 0]
    gold = axis.reduce(gold_loc * mine.to(torch.float32))
    nll = torch.sum((logz - gold) * mask)
    # argmax: the first index of the largest logit over the whole vocab
    arg = torch.argmax(logits.detach(), dim=-1) + lo
    big = torch.full_like(arg, torch.iinfo(arg.dtype).max)
    first = axis.min(torch.where(top == m, arg, big))
    hit = torch.sum((first == labels).to(torch.float32) * mask)
    return nll, hit


# ---------------------------------------------------------------------------
# Serving on a mesh: the decode cache's placement
# ---------------------------------------------------------------------------
def axis_group(mesh: Mesh, axes):
    """The process group of ``axes`` (a name, or a tuple of names whose
    group :func:`repro_torch.launch.mesh._grid_mesh` builds: the batch
    axes)."""
    if isinstance(axes, str) or len(axes) == 1:
        return mesh.groups[axes if isinstance(axes, str) else axes[0]]
    return mesh.groups[tuple(axes)]


@dataclasses.dataclass(frozen=True, eq=False)
class SeqSplit:
    """A cache's sequence axis in ``size`` contiguous parts over the
    processes of ``group``; this process holds part ``coord``, the
    ``local`` positions from ``offset``.  ``size`` 1: the sequence is
    whole here (``group`` None)."""
    group: Any
    size: int
    coord: int
    local: int

    @property
    def offset(self) -> int:
        return self.coord * self.local

    def slot(self, pos: torch.Tensor):
        """(this process's slot for the global position ``pos``, a 0-d
        int tensor, clamped into its part; whether it owns ``pos``), both
        on the device: the caller writes ``where(owned, new, old)``, so
        no host read decides the owner."""
        rel = pos - self.offset
        owned = (rel >= 0) & (rel < self.local)
        return torch.clamp(rel, 0, self.local - 1), owned


@dataclasses.dataclass(frozen=True)
class _Leaf:
    """A shape, as the placement rules read a leaf (no tensor: inside a
    traced call a tensor of a whole cache's shape would count as
    memory)."""
    shape: Tuple[int, ...]


@dataclasses.dataclass(frozen=True, eq=False)
class Serving:
    """What a process serving on ``mesh`` needs besides its parameter
    shards: the request's global ``batch`` (the cache's placement turns
    on it: at B = 1 the sequence goes over ``data``) and the decode
    cache's whole self-attention length ``cache_len`` (the window under a
    sliding-window decode).  The batch is split as
    :func:`~repro_torch.sharding.specs.simple_batch_shardings` splits it;
    each cache leaf as :func:`~repro_torch.sharding.specs.cache_shardings`
    places it, its batch dim being this process's rows."""
    mesh: Mesh
    batch: int
    cache_len: int

    def batch_rows(self) -> slice:
        """This process's rows of the global batch."""
        pl = simple_batch_shardings({"t": _Leaf((self.batch,))},
                                    self.mesh)["t"]
        return local_slices(pl, (self.batch,), self.mesh)[0]

    def batch_split(self):
        """(the process group the batch's rows split over, its size, this
        process's coordinate on it), in row order; None where this
        process holds the whole batch."""
        pl = simple_batch_shardings({"t": _Leaf((self.batch,))},
                                    self.mesh)["t"]
        if pl[0] is None:
            return None
        rows = self.batch_rows()
        local = rows.stop - rows.start
        return (axis_group(self.mesh, pl[0]), self.batch // local,
                rows.start // local)

    def placement(self, key: str, shape) -> Placement:
        """The placement of a cache leaf ``key`` (``k``, ``v``, ``ckv``,
        ``krope``, ``ssm``, ``conv``, ``enc_out``) of the whole (global)
        ``shape``."""
        return cache_shardings({key: _Leaf(tuple(shape))}, self.mesh)[key]

    def local_shape(self, key: str, shape) -> Tuple[int, ...]:
        sl = local_slices(self.placement(key, shape), shape, self.mesh)
        return tuple(s.stop - s.start for s in sl)

    def place(self, key: str, t: torch.Tensor, shape, *,
              stacked: bool = True) -> torch.Tensor:
        """This process's part of a cache tensor ``t`` whose global shape
        is ``shape`` and whose batch dim (the first) holds this process's
        rows already: one layer's entry of a leaf stacked over periods
        (``stacked``: ``shape`` without the stack dim), or ``enc_out``.
        A dim the placement splits is sliced where ``t`` holds it whole
        and kept where ``t`` holds this process's part already (a head
        split that matches the placement); every other dim must be
        whole."""
        shape = tuple(shape)
        pl = (self.placement(key, (1,) + shape)[1:] if stacked
              else self.placement(key, shape))
        sl = list(local_slices(pl, shape, self.mesh))
        sl[0] = slice(None)                  # this process's rows already
        for d in range(1, len(shape)):
            if t.shape[d] == shape[d]:
                continue
            if pl[d] is None or t.shape[d] != sl[d].stop - sl[d].start:
                raise ValueError(f"cache leaf {key!r}: dim {d} of "
                                 f"{tuple(t.shape)} against {shape} placed "
                                 f"{pl}")
            sl[d] = slice(None)
        return t[tuple(sl)].contiguous()

    def seq_split(self, key: str, shape) -> SeqSplit:
        """The split of a KV-like leaf's sequence dim (dim 2 of the whole
        ``shape``, stack dim first)."""
        pl = self.placement(key, shape)
        if pl[2] is None:
            return SeqSplit(None, 1, 0, shape[2])
        part = local_slices(pl, shape, self.mesh)[2]
        local = part.stop - part.start
        return SeqSplit(axis_group(self.mesh, pl[2]), shape[2] // local,
                        part.start // local, local)


def serve_axis(mesh: Mesh, params_shape, *, batch: int, cache_len: int
               ) -> ModelAxis:
    """The :class:`ModelAxis` a process serves a request of ``batch``
    sequences with, on ``mesh``, into a decode cache of ``cache_len``
    (:class:`Serving`); a model axis of 1 too (a mesh ``Dx1``, whose
    processes split the batch, or the sequence at B = 1)."""
    return ModelAxis(mesh.groups["model"], mesh.shape["model"],
                     mesh.coords["model"], _placements(mesh, params_shape),
                     Serving(mesh, int(batch), int(cache_len)))


# ---------------------------------------------------------------------------
# What the model axis runs
# ---------------------------------------------------------------------------
def check_supported(model) -> None:
    """Raise, naming ROADMAP Queue 1 item 7d, for a model the axis does
    not split: one that is not a transformer config."""
    from repro_torch.configs.base import ArchConfig
    if not isinstance(getattr(model, "cfg", None), ArchConfig):
        raise NotImplementedError(
            f"a model axis above 1 (tensor-parallel client compute) with "
            f"model {model.name!r} (not a transformer config) is not yet "
            f"ported to repro_torch ({ITEM_7D})")
