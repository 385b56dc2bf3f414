"""Parameter bridge between the JAX package's layout and the port's.

The JAX parameters of the dense LM are a nested dict/tuple tree (``blocks``
is a tuple of one dict whose leaves are stacked over layers); the port's
are a flat dict keyed by the dotted path (``"blocks.0.attn.wq"``).  The
arrays are the same in both, so converting is a copy through numpy and
the flat buffers of both packages compare element for element."""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core.flat import leaf_order


def _walk(tree: Any, prefix: str, out: Dict[str, Any]) -> None:
    if isinstance(tree, dict):
        for k in tree:
            _walk(tree[k], f"{prefix}{k}.", out)
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            _walk(v, f"{prefix}{i}.", out)
    else:
        out[prefix[:-1]] = tree


def to_torch(tree: Any, device=None) -> Dict[str, torch.Tensor]:
    """Nested dict/tuple of arrays (numpy, or anything ``np.asarray``
    takes) -> the port's flat dict of tensors, in leaf order."""
    flat: Dict[str, Any] = {}
    _walk(tree, "", flat)
    return {k: torch.from_numpy(np.array(flat[k], copy=True)).to(device)
            for k in leaf_order(flat)}


def to_numpy(params: Dict[str, torch.Tensor]) -> Any:
    """The port's flat dict -> the JAX nested tree of numpy arrays; an
    all-numeric level becomes a tuple, as ``blocks`` is in JAX."""
    root: Dict[str, Any] = {}
    for name, t in params.items():
        node = root
        *parents, last = name.split(".")
        for part in parents:
            node = node.setdefault(part, {})
        node[last] = t.detach().cpu().numpy()

    def fix(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return tuple(fix(node[str(i)]) for i in range(len(node)))
        return {k: fix(v) for k, v in node.items()}

    return fix(root)
