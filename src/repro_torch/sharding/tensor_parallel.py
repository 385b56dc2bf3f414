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
Supported under ``meta_mode='post'`` with no codec on the synchronous
``fused_flat`` engine; ``through_aggregation``, codecs, ``legacy_tree``,
the buffered-async runtime and the prefill over the axis raise
(:func:`check_supported`, ``transformer._apply_layer``), naming ROADMAP
Queue 1 item 7c.

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

from repro_torch.sharding.specs import (Mesh, local_slices,
                                        model_axis_placement, model_size,
                                        param_spec, tree_paths)

ITEM_7C = "ROADMAP Queue 1 item 7c"


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
                whole = flat[leaf.offset:leaf.offset + leaf.size].view(
                    leaf.shape)
                if any(e is not None for e in self.placements[leaf.name]):
                    whole[self.slices(leaf.name, leaf.shape)].copy_(
                        shards[leaf.name])
                elif self.coord == 0:
                    whole.copy_(shards[leaf.name])
        return list(out)

    def all_reduce_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Sum each tensor over the model axis, in place."""
        for t in tensors:
            t.copy_(all_reduce_copy(t, self.group))


def _axis_mesh(axis: ModelAxis) -> Mesh:
    return Mesh(("model",), {"model": axis.size}, {"model": axis.coord},
                {"model": axis.group}, torch.device("cpu"))


def model_axis(mesh: Optional[Mesh], params_shape) -> Optional[ModelAxis]:
    """The :class:`ModelAxis` of this process on ``mesh`` for parameters
    shaped as ``params_shape`` (a name -> tensor dict), or None without a
    model axis above 1.  The cohort strategy moves only the FSDP entries
    of a placement, which the model axis drops."""
    if model_size(mesh) <= 1:
        return None
    names = {n.replace(".", "/"): n for n in params_shape}
    placements = {}
    for path, leaf in tree_paths(params_shape):
        placements[names[path]] = model_axis_placement(
            param_spec(path, tuple(leaf.shape), mesh))
    return ModelAxis(mesh.groups["model"], mesh.shape["model"],
                     mesh.coords["model"], placements)


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
# What the model axis runs
# ---------------------------------------------------------------------------
def check_supported(model, fed, *, engine, codec) -> None:
    """Raise, naming ROADMAP Queue 1 item 7c, for what tensor-parallel
    client compute does not run yet."""
    from repro_torch.configs.base import ArchConfig
    cfg = getattr(model, "cfg", None)
    what = None
    if not isinstance(cfg, ArchConfig):
        what = f"model {model.name!r} (not a transformer config)"
    elif fed.meta and fed.meta_mode != "post":
        what = f"meta_mode={fed.meta_mode!r} (post runs)"
    elif codec.lossy:
        what = f"codec={fed.codec!r} (codec='none' runs)"
    elif engine.is_async or engine.name != "fused_flat":
        what = f"engine {engine.name!r} (fused_flat runs)"
    if what is not None:
        raise NotImplementedError(
            f"a model axis above 1 (tensor-parallel client compute) with "
            f"{what} is not yet ported to repro_torch ({ITEM_7C})")
