"""Flat-buffer view of parameter/gradient trees for the fused server engine.

The layout is the JAX package's (``repro/core/flat.py``), element for
element: leaves are grouped by dtype in first-appearance order, raveled,
cast to fp32 and packed into one contiguous ``(rows, 128)`` fp32 buffer
per group, ``rows`` padded to a multiple of ``row_align`` with a zero pad.
Flat aggregates and optimizer slots of the two packages therefore compare
element for element.

Parameters in the port are a flat dict ``{"blocks.0.attn.wq": tensor,
...}`` (the names :func:`torch.func.functional_call` takes).  Leaf order is
``jax.tree.flatten``'s over the nested JAX tree: dict keys sorted at every
level, tuple entries in index order — :func:`leaf_order` sorts the dotted
names component by component, numeric components as integers.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

LANES = 128           # last axis of every flat buffer
Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    index: int                     # position in leaf order
    name: str
    shape: Tuple[int, ...]
    dtype: torch.dtype             # original dtype (cast-back target)
    offset: int                    # element offset inside the group buffer
    size: int


@dataclasses.dataclass(frozen=True)
class GroupSpec:
    dtype: torch.dtype
    leaves: Tuple[LeafSpec, ...]
    size: int                      # total elements (before padding)
    rows: int                      # padded row count: rows * LANES >= size


@dataclasses.dataclass(frozen=True)
class FlatSpec:
    names: Tuple[str, ...]         # every leaf name, in leaf order
    groups: Tuple[GroupSpec, ...]

    @property
    def num_leaves(self) -> int:
        return len(self.names)


def _path_key(name: str):
    return tuple((0, int(c), "") if c.isdigit() else (1, 0, c)
                 for c in name.split("."))


def leaf_order(names) -> List[str]:
    """Dotted names in ``jax.tree.flatten`` order of the nested tree."""
    return sorted(names, key=_path_key)


def make_flat_spec(tree: Params, *, row_align: int = 8) -> FlatSpec:
    """Static layout of ``tree`` (tensors or anything with shape/dtype)."""
    names = leaf_order(tree)
    by_dtype: dict = {}
    for i, name in enumerate(names):
        by_dtype.setdefault(tree[name].dtype, []).append((i, name))
    groups = []
    for dt, members in by_dtype.items():
        specs, off = [], 0
        for i, name in members:
            shape = tuple(tree[name].shape)
            size = 1
            for s in shape:
                size *= s
            specs.append(LeafSpec(index=i, name=name, shape=shape, dtype=dt,
                                  offset=off, size=size))
            off += size
        rows = -(-off // LANES)
        rows = -(-rows // row_align) * row_align
        groups.append(GroupSpec(dtype=dt, leaves=tuple(specs), size=off,
                                rows=rows))
    return FlatSpec(names=tuple(names), groups=tuple(groups))


def zeros_flat(spec: FlatSpec, device=None) -> List[torch.Tensor]:
    """Zero fp32 buffers in the spec's layout."""
    return [torch.zeros((g.rows, LANES), dtype=torch.float32, device=device)
            for g in spec.groups]


def flatten_tree(spec: FlatSpec, tree: Params,
                 out: Optional[Sequence[torch.Tensor]] = None
                 ) -> List[torch.Tensor]:
    """tree -> one (rows, LANES) fp32 buffer per dtype group.

    ``out`` gives the buffers to fill (a slot of a preallocated cohort
    stack, or a scratch buffer reused across clients), so no concatenated
    temporary is made; the pad is written as zeros."""
    if out is None:
        device = tree[spec.names[0]].device
        out = [torch.empty((g.rows, LANES), dtype=torch.float32,
                           device=device) for g in spec.groups]
    for g, buf in zip(spec.groups, out):
        assert buf.shape == (g.rows, LANES) and buf.dtype == torch.float32
        flat = buf.view(-1)
        for leaf in g.leaves:
            flat[leaf.offset:leaf.offset + leaf.size].copy_(
                tree[leaf.name].reshape(-1))
        flat[g.size:].zero_()
    return list(out)


def flatten_stacked(spec: FlatSpec, tree: Params) -> List[torch.Tensor]:
    """tree with a leading cohort axis on every leaf -> one
    (cohort, rows, LANES) fp32 buffer per dtype group."""
    first = tree[spec.names[0]]
    cohort = first.shape[0]
    out = [torch.empty((cohort, g.rows, LANES), dtype=torch.float32,
                       device=first.device) for g in spec.groups]
    for k in range(cohort):
        flatten_tree(spec, {n: tree[n][k] for n in spec.names},
                     out=[buf[k] for buf in out])
    return out


def unflatten_tree(spec: FlatSpec, bufs: Sequence[torch.Tensor]) -> Params:
    """Inverse of :func:`flatten_tree`: original names, shapes and dtypes.
    fp32 leaves are views of the buffers, not copies."""
    out: Params = {}
    for g, buf in zip(spec.groups, bufs):
        flat = buf.reshape(-1)
        for leaf in g.leaves:
            x = flat[leaf.offset:leaf.offset + leaf.size].view(leaf.shape)
            out[leaf.name] = x.to(leaf.dtype)
    return {name: out[name] for name in spec.names}


def flat_sq_norm(bufs: Sequence[torch.Tensor]) -> torch.Tensor:
    """||tree||^2 over flat group buffers (the zero pad adds nothing)."""
    ssq = None
    for b in bufs:
        s = torch.sum(b * b)
        ssq = s if ssq is None else ssq + s
    return ssq
