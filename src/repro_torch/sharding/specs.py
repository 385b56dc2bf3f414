"""The (data, model) process mesh and the placement rules over it
(PyTorch port of ``repro/sharding/specs.py``).

JAX places arrays on a device mesh with ``PartitionSpec``s and lets GSPMD
insert the collectives.  The port runs one process per mesh coordinate
under ``torch.distributed`` instead, so a :class:`Mesh` names which
process holds what: its axis names and shape, this process's coordinate
on each axis, and the process group of each axis (the processes that
share this one's other coordinates).  Ranks are laid out row-major,
``rank = data * model_size + model``, as JAX reshapes its device list
into the mesh.

A *placement* is what JAX's ``PartitionSpec`` holds, as a tuple with one
entry per dim: the axis name, a tuple of axis names, or None (the dim is
whole on every process).  :func:`local_slices` turns a placement, a shape
and a mesh into this process's index slices.  The rules are JAX's, with
JAX's names and ``_maybe``'s degradation (a dim the axis does not divide
is replicated):

  * :func:`fsdp_axes`, :func:`param_spec`, :func:`param_shardings`,
    :func:`cohort_grad_shardings`, :func:`state_shardings` — parameters
    and server state;
  * :func:`cohort_batch_shardings`, :func:`simple_batch_shardings`,
    :func:`cache_shardings`, :func:`replicated` — batches and caches;
  * :func:`flat_group_shardings` — the flat ``(rows, 128)`` group
    buffers' placements, and :func:`flat_group_pspecs` the rows of each
    this process holds;
  * :func:`tree_paths` — a port tree's leaves with JAX's ``/``-joined
    paths in JAX's flatten order: the port's dotted parameter names
    (``blocks.0.attn.wq``, stacked ``(L, ...)``) are JAX's nested keys
    (``blocks/0/attn/wq``), so a name's rule is the JAX leaf's;
  * :func:`batch_axes`, :func:`axis_size`, :func:`cohort_split`,
    :func:`batch_coord`, :func:`batch_rank` — the sharded executor's
    cohort split over the batch axes.

A "sharding" here is a placement: torch has no ``NamedSharding``, and
the functions that return JAX's shardings return placements in the same
tree.  The model axis is tensor-parallel client compute
(:mod:`repro_torch.sharding.tensor_parallel`): a process holds the
model-axis part of each parameter's placement.  The FSDP entries (the
input dim over ``data``) are JAX's memory placement of one replicated
program; the port's data-axis processes run different clients and each
holds the replicated server state, so they keep those dims whole
(:func:`model_axis_placement`).
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch


class Placement(tuple):
    """What JAX's ``PartitionSpec`` holds, one entry per dim: an axis
    name, a tuple of axis names, or None.  A tuple, so it compares equal
    to a plain one; a leaf, not a container, to :func:`tree_paths`."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"Placement{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A grid of ``torch.distributed`` processes, one device each."""
    axis_names: Tuple[str, ...]            # ("data", "model")
    shape: Dict[str, int]                  # axis -> size
    coords: Dict[str, int]                 # this process's coordinate
    groups: Dict[str, Any]                 # axis -> its process group
    device: torch.device                   # this process's device

    @property
    def size(self) -> int:
        return math.prod(self.shape[a] for a in self.axis_names)

    @property
    def rank(self) -> int:
        """This process's global rank."""
        return self.rank_of()

    def rank_of(self, **coords: int) -> int:
        """The global rank at ``coords``, this process's coordinate on
        every axis not given."""
        rank = 0
        for a in self.axis_names:
            rank = rank * self.shape[a] + coords.get(a, self.coords[a])
        return rank


def axis_size(mesh: Mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    return int(math.prod(mesh.shape[a] for a in axes))


def _maybe(mesh: Mesh, axes, dim: int):
    """Use ``axes`` for a dim only if it divides evenly, else replicate
    (None).  A one-name tuple collapses to the bare name."""
    if not (axes and dim % axis_size(mesh, axes) == 0):
        return None
    if isinstance(axes, tuple) and len(axes) == 1:
        return axes[0]
    return axes


def model_size(mesh: Optional[Mesh]) -> int:
    """The model axis's size (1 without a mesh or without the axis)."""
    return 1 if mesh is None else int(mesh.shape.get("model", 1))


def fsdp_axes(mesh: Mesh, strategy: str):
    """The FSDP axes for a parameter's input dim: the pod axis joins
    under the client-sequential (scan) strategy; under client-parallel
    (vmap) the pods are data-parallel replicas."""
    if "pod" in mesh.axis_names and strategy == "scan":
        return ("pod", "data")
    return ("data",)


def local_slices(placement: Placement, shape, mesh: Mesh
                 ) -> Tuple[slice, ...]:
    """This process's index slices of an array of ``shape`` placed by
    ``placement``: a dim placed over axes (a, b, ...) splits into
    ``size(a) * size(b) * ...`` even parts, and this process holds part
    ``coord(a) * size(b) * ... + coord(b) * ...`` (the first axis the
    major one, as JAX orders a dim's shards); a dim placed None is
    whole."""
    out = []
    for entry, n in zip(tuple(placement) + (None,) * len(shape), shape):
        if entry is None:
            out.append(slice(0, n))
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx, parts = 0, 1
        for a in axes:
            idx = idx * mesh.shape[a] + mesh.coords[a]
            parts *= mesh.shape[a]
        if n % parts:
            raise ValueError(f"dim {n} does not split into {parts} parts "
                             f"over {axes}")
        per = n // parts
        out.append(slice(idx * per, (idx + 1) * per))
    return tuple(out)


# ---------------------------------------------------------------------------
# Tree paths
# ---------------------------------------------------------------------------
def _path_key(parts):
    return tuple((0, int(c), "") if c.isdigit() else (1, 0, c)
                 for c in parts)


def _walk(tree, parts: tuple, out: list) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _walk(v, parts + tuple(str(k).split(".")), out)
    elif isinstance(tree, (tuple, list)) and not isinstance(tree, Placement):
        for i, v in enumerate(tree):
            _walk(v, parts + (str(i),), out)
    else:
        out.append((parts, tree))


def tree_paths(tree) -> List[Tuple[str, Any]]:
    """Every leaf of a port tree (dicts, tuples, lists; a dotted key is
    a nested path) as ``(path, leaf)`` with JAX's ``/``-joined path, in
    ``jax.tree_util.tree_flatten_with_path`` order of the nested JAX
    tree: keys sorted at every level, sequence entries by index."""
    out: list = []
    _walk(tree, (), out)
    out.sort(key=lambda pl: _path_key(pl[0]))
    return [("/".join(parts), leaf) for parts, leaf in out]


def _map_paths(fn: Callable, tree, parts: tuple = ()):
    """``tree`` with every leaf replaced by ``fn(path, leaf)``."""
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, parts + tuple(str(k).split(".")))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)) and not isinstance(tree, Placement):
        return type(tree)(_map_paths(fn, v, parts + (str(i),))
                          for i, v in enumerate(tree))
    return fn("/".join(parts), tree)


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(getattr(leaf, "shape", ()))


# ---------------------------------------------------------------------------
# Parameter placements
# ---------------------------------------------------------------------------
_IN_OUT = {"wq", "wk", "wv", "w_gate", "w_up", "in_proj", "w_dkv", "w_kr",
           "router", "proj", "w_in", "wx", "wh", "out_w"}       # (d_in, d_out)
_OUT_IN = {"wo", "w_down", "out_proj", "w_out"}                 # (d_out, d_in)
_REPL = {"dt_bias", "A_log", "D", "b", "b_in", "b_out", "out_b",
         "ln1_s", "ln1_b", "ln2_s", "ln2_b", "ln_f_s", "ln_f_b"}


def param_spec(path: str, shape: Tuple[int, ...], mesh: Mesh,
               strategy: str = "vmap") -> Placement:
    """The placement of one parameter leaf; ``path`` is JAX's '/'-joined
    key names (:func:`tree_paths` gives them for the port's names)."""
    fs = fsdp_axes(mesh, strategy)
    parts = path.split("/")
    name = parts[-1]
    # stacked leading axes: blocks/<i>/... (n_periods) and encoder/layers/...
    n_stack = 0
    if "blocks" in parts or ("layers" in parts and "encoder" in parts):
        n_stack = 1
    core = tuple(shape[n_stack:])
    lead = (None,) * n_stack

    def spec(*axes):
        return Placement(*(lead + axes))

    if name in _REPL or len(core) <= 1:
        if not (name == "embed" and len(core) == 2):
            return Placement(*((None,) * len(shape)))
    if name == "embed":
        return spec(_maybe(mesh, "model", core[0]), _maybe(mesh, fs, core[1]))
    if name == "head":
        return spec(_maybe(mesh, fs, core[0]), _maybe(mesh, "model", core[1]))
    if name == "conv_w":
        return spec(None, _maybe(mesh, "model", core[1]))
    if name in ("w_uk", "w_uv"):  # (r, H, hd)
        return spec(_maybe(mesh, fs, core[0]),
                    _maybe(mesh, "model", core[1]), None)
    if len(core) == 3:            # MoE experts (E, a, b)
        e = _maybe(mesh, "model", core[0])
        if name in _OUT_IN:       # (E, de, d)
            return spec(e, None, _maybe(mesh, fs, core[2]))
        return spec(e, _maybe(mesh, fs, core[1]), None)
    if name in _OUT_IN:
        return spec(_maybe(mesh, "model", core[0]), _maybe(mesh, fs, core[1]))
    if name in _IN_OUT:
        return spec(_maybe(mesh, fs, core[0]), _maybe(mesh, "model", core[1]))
    # fallback: the largest divisible dim over model, the next over fsdp
    axes: list = [None] * len(core)
    order = sorted(range(len(core)), key=lambda i: -core[i])
    if order and _maybe(mesh, "model", core[order[0]]):
        axes[order[0]] = "model"
    if len(order) > 1 and _maybe(mesh, fs, core[order[1]]):
        axes[order[1]] = fs
    return spec(*axes)


def param_shardings(params_shape, mesh: Mesh, strategy: str = "vmap"):
    """The placement of every leaf of a parameter(-like) tree, in the
    tree's structure.  Also the optimizer state's (its leaf paths mirror
    the parameters')."""
    return _map_paths(lambda p, leaf: param_spec(p, _shape(leaf), mesh,
                                                 strategy), params_shape)


def cohort_grad_shardings(params_shape, mesh: Mesh, strategy: str = "vmap"):
    """The placements of the stacked per-client gradients (cohort,
    *param_dims): the cohort over the batch axes, the other dims per
    :func:`param_spec` with the batch axes taken out (the cohort axis
    owns them)."""
    ba = batch_axes(mesh)

    def strip(e):
        if e is None:
            return None
        es = (e,) if isinstance(e, str) else tuple(e)
        es = tuple(a for a in es if a not in ba)
        return es if es else None

    return _map_paths(lambda p, leaf: Placement(ba, *(
        strip(e) for e in param_spec(p, _shape(leaf), mesh, strategy))),
        params_shape)


def model_axis_placement(placement: Placement) -> Placement:
    """``placement`` with every axis but ``model`` taken out: what a
    process of the port's tensor-parallel client compute holds (the data
    axis's processes run different clients, each on the whole replicated
    state)."""
    def keep(e):
        if e is None:
            return None
        es = (e,) if isinstance(e, str) else tuple(e)
        return "model" if "model" in es else None
    return Placement(*(keep(e) for e in placement))


def flat_group_shardings(spec, mesh: Mesh) -> Tuple[Placement, ...]:
    """One placement per flat dtype-group buffer (``(rows, 128)`` fp32,
    :mod:`repro_torch.core.flat`): the rows over the model axis where it
    divides them, the lanes whole (128 is the hardware lane tile).  The
    batch axes are not used: tier 2 of the sharded executor already
    reduced the cohort away."""
    ax = "model" if "model" in mesh.axis_names else None
    return tuple(Placement(_maybe(mesh, ax, g.rows), None)
                 for g in spec.groups)


def flat_group_pspecs(spec, mesh: Mesh) -> Tuple[slice, ...]:
    """One row slice per flat dtype-group buffer: the rows this process's
    model coordinate holds under :func:`flat_group_shardings` — an even
    split over the model axis where it divides the rows, all of them
    otherwise (replicated)."""
    return tuple(local_slices(p, (g.rows, 128), mesh)[0]
                 for p, g in zip(flat_group_shardings(spec, mesh),
                                 spec.groups))


def state_shardings(state_shape, mesh: Mesh, strategy: str = "vmap"):
    """The server state {params, opt, round, ...}: the round counter and
    0-d leaves replicated, the optimizer moments as their parameters."""
    def one(pstr, leaf):
        shape = _shape(leaf)
        if pstr == "round" or pstr.endswith("/t") or len(shape) == 0:
            return Placement()
        core = re.sub(r"^(params|opt/m|opt/v)/", "", pstr)
        return param_spec(core, shape, mesh, strategy)
    return _map_paths(one, state_shape)


# ---------------------------------------------------------------------------
# Batch / cache placements
# ---------------------------------------------------------------------------
def batch_axes(mesh: Mesh):
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def cohort_batch_shardings(batch_shape, mesh: Mesh, strategy: str = "vmap"):
    """cohort_batch leaves (cohort, b, ...).  vmap: the cohort over the
    batch axes and each client's example axis b over model; scan: the
    cohort is the sequential axis and b goes over (data, model)."""
    ba = batch_axes(mesh)

    def one(_, leaf):
        shape = _shape(leaf)
        if strategy == "vmap":
            return Placement(_maybe(mesh, ba, shape[0]),
                             _maybe(mesh, "model", shape[1]),
                             *(None,) * (len(shape) - 2))
        b_ax = _maybe(mesh, ("data", "model"), shape[1]) or \
            _maybe(mesh, "data", shape[1])
        return Placement(None, b_ax, *(None,) * (len(shape) - 2))

    return _map_paths(one, batch_shape)


def simple_batch_shardings(batch_shape, mesh: Mesh):
    """Batches with a leading example axis (meta batch, prefill batch)."""
    ba = batch_axes(mesh)
    return _map_paths(lambda _, leaf: Placement(
        _maybe(mesh, ba, _shape(leaf)[0]), *(None,) * (len(_shape(leaf)) - 1)),
        batch_shape)


def cache_shardings(cache_shape, mesh: Mesh, *, seq_axes_for_b1=("data",)):
    """The decode cache: KV-like leaves (n_periods, B, S, ...) put B over
    the batch axes and S over model; SSM state (n_periods, B, H, N, P) H
    over model; conv (n_periods, B, k, C) C over model.  At B == 1 the
    KV sequence axis takes ``seq_axes_for_b1`` instead."""
    ba = batch_axes(mesh)

    def one(path_str, leaf):
        shape = _shape(leaf)
        if len(shape) == 0:
            return Placement()
        B = shape[1]
        b_ax = _maybe(mesh, ba, B)
        if "ssm" in path_str:                       # (np, B, H, N, P)
            return Placement(None, b_ax, _maybe(mesh, "model", shape[2]),
                             None, None)
        if "conv" in path_str:                      # (np, B, k, C)
            return Placement(None, b_ax, None,
                             _maybe(mesh, "model", shape[3]))
        rest = (None,) * (len(shape) - 3)
        if B == 1:
            return Placement(None, None,
                             _maybe(mesh, seq_axes_for_b1, shape[2]), *rest)
        return Placement(None, b_ax, _maybe(mesh, "model", shape[2]), *rest)

    return _map_paths(one, cache_shape)


def replicated(tree, mesh: Mesh):
    return _map_paths(lambda _, leaf: Placement(), tree)


def batch_coord(mesh: Mesh) -> int:
    """This process's coordinate over the batch axes (pod major)."""
    c = 0
    for a in batch_axes(mesh):
        c = c * mesh.shape[a] + mesh.coords[a]
    return c


def batch_rank(mesh: Mesh, b: int) -> int:
    """The global rank at batch coordinate ``b`` and this process's
    model coordinate."""
    coords = {}
    for a in reversed(batch_axes(mesh)):
        coords[a] = b % mesh.shape[a]
        b //= mesh.shape[a]
    return mesh.rank_of(**coords)


def cohort_split(cohort: int, mesh: Mesh) -> Tuple[int, int]:
    """(slots per data-axis process, padded cohort): the cohort padded to
    a multiple of the batch axes; process d runs slots ``[d * per,
    (d + 1) * per)``, a slot past the cohort being a weight-0 replica of
    client 0."""
    n = axis_size(mesh, batch_axes(mesh))
    per = -(-cohort // n)
    return per, per * n
