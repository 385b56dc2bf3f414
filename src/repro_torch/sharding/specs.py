"""The (data, model) process mesh and the splits the sharded executor
makes over it (PyTorch port of the parts of ``repro/sharding/specs.py``
with a torch meaning).

JAX places arrays on a device mesh with ``PartitionSpec``s and lets GSPMD
insert the collectives.  The port runs one process per device under
``torch.distributed`` instead, so a :class:`Mesh` names which process
holds what: its axis names and shape, this process's coordinate on each
axis, and the process group of each axis (the processes that share this
one's other coordinates).  Ranks are laid out row-major, ``rank = data *
model_size + model``, as JAX reshapes its device list into the mesh.

  * :func:`batch_axes`, :func:`axis_size` — as in JAX;
  * :func:`cohort_split` — which cohort slots each data-axis process runs:
    contiguous slices of a cohort padded to a multiple of the axis with
    weight-0 replicas of client 0 (the JAX sharded executor's
    ``_two_tier``);
  * :func:`flat_group_pspecs` — the rows of each flat dtype-group buffer
    a model-axis process would hold: every row at model 1, an even split
    where the axis divides the rows, the whole buffer (replicated)
    otherwise, as JAX's ``_maybe`` degrades.

The parameter, state, batch and cache specs (``param_spec``,
``state_shardings``, ``cache_shardings``, ...) place tensor-parallel
client compute over the model axis: ROADMAP Queue 1 item 7b.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch


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


def batch_axes(mesh: Mesh):
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def cohort_split(cohort: int, mesh: Mesh) -> Tuple[int, int]:
    """(slots per data-axis process, padded cohort): the cohort padded to
    a multiple of the batch axes; process d runs slots ``[d * per,
    (d + 1) * per)``, a slot past the cohort being a weight-0 replica of
    client 0."""
    n = axis_size(mesh, batch_axes(mesh))
    per = -(-cohort // n)
    return per, per * n


def flat_group_pspecs(spec, mesh: Mesh) -> Tuple[slice, ...]:
    """One row slice per flat dtype-group buffer (``(rows, 128)`` fp32,
    :mod:`repro_torch.core.flat`): the rows this process's model
    coordinate would hold — split evenly over the model axis where it
    divides the rows, all of them otherwise (replicated).  The cohort
    axis is not used: tier 2 of the sharded executor already reduced it
    away."""
    m = mesh.shape.get("model", 1)
    c = mesh.coords.get("model", 0)
    out = []
    for g in spec.groups:
        if g.rows % m:
            out.append(slice(0, g.rows))
        else:
            per = g.rows // m
            out.append(slice(c * per, (c + 1) * per))
    return tuple(out)
