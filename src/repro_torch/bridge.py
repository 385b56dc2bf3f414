"""State bridge between the JAX package's layout and the port's.

The JAX parameters of the LM are a nested dict/tuple tree (``blocks`` is a
tuple of one dict per position in the layer period, whose leaves are
stacked over periods); the port's are a flat dict keyed by the dotted
path (``"blocks.0.attn.wq"``, the MoE's ``"blocks.0.mlp.router"`` and
``"blocks.0.mlp.shared.w_gate"``, MLA's ``"blocks.0.attn.w_uk"``).  The
arrays are the same in both, so converting is a copy through numpy and
the flat buffers of both packages compare element for element.  The rest
of the server state — the flat optimizer slots, the step counter and the
controllable ``ctrl`` slot — has the same structure in both packages and
crosses with :func:`server_state_to_torch`.  An encoder's parameters
are the subtree ``encoder`` (``encoder.layers.attn.wq``, stacked over its
layers, ``encoder.proj``); an encoder with no layers at the model's width
has none, and its JAX subtree is an empty dict, which has no leaves either:
``to_torch`` drops it, and JAX's functions take the tree without it.  The
serving decode cache has the same tree in both packages too (``{"layers":
(entry, ...), "index": int32}``, each entry a dict of arrays stacked over
periods: ``k`` / ``v`` (a cross layer's over the encoder's positions),
MLA's latent ``ckv`` / ``krope``, or mamba's ``ssm`` / ``conv``; with an
encoder also ``"enc_out"``) and crosses with :func:`cache_to_torch` /
:func:`cache_to_numpy`."""
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


def server_state_to_torch(opt: Dict[str, Any], ctrl: Dict[str, Any] = None,
                          comm: Dict[str, Any] = None,
                          device=None) -> Dict[str, Any]:
    """The JAX server state beside the parameters -> the port's.

    ``opt`` is the flat optimizer state (``{}``, ``{"m": (buf, ...)}`` or
    ``{"m": ..., "v": ..., "t": step}``, one ``(rows, 128)`` buffer per
    dtype group), ``ctrl`` the through-aggregation slot (``{"w_logits":
    (cohort,), "log_lr": ()}``), as numpy or anything ``np.asarray``
    takes; ``comm`` the error-feedback slot (``{"residual": (stack, ...)}``,
    one ``(cohort, rows, 128)`` stack per dtype group).  Returns ``{"opt":
    ..., "ctrl": ..., "comm": ...}`` (``ctrl`` and ``comm`` only when
    given), ready to assign into a port trainer's ``state``."""
    def tensor(x, dtype):
        return torch.from_numpy(np.array(x, dtype=dtype, copy=True)).to(
            device)

    out: Dict[str, Any] = {"opt": {}}
    for slot in ("m", "v"):
        if slot in opt:
            out["opt"][slot] = tuple(tensor(b, np.float32)
                                     for b in opt[slot])
    if "t" in opt:
        out["opt"]["t"] = tensor(opt["t"], np.int32)
    if ctrl is not None:
        out["ctrl"] = {k: tensor(ctrl[k], np.float32)
                       for k in ("w_logits", "log_lr")}
    if comm is not None:
        out["comm"] = {"residual": tuple(tensor(b, np.float32)
                                         for b in comm["residual"])}
    return out


def cache_to_torch(cache: Dict[str, Any], device=None) -> Dict[str, Any]:
    """A JAX decode cache (numpy, or anything ``np.asarray`` takes) -> the
    port's: ``{"layers": tuple of dicts of tensors, "index": 0-d int32}``
    and ``"enc_out"`` where the cache has it.  The arrays are copied, so
    the port's in-place decode never writes into the caller's arrays."""
    def tensor(x):
        return torch.from_numpy(np.array(x, copy=True)).to(device)

    out = {"layers": tuple({k: tensor(v) for k, v in entry.items()}
                           for entry in cache["layers"]),
           "index": tensor(np.asarray(cache["index"], np.int32))}
    if "enc_out" in cache:
        out["enc_out"] = tensor(cache["enc_out"])
    return out


def cache_to_numpy(cache: Dict[str, Any]) -> Dict[str, Any]:
    """The port's decode cache -> the JAX tree of numpy arrays."""
    def array(t):
        return t.detach().cpu().numpy()

    out = {"layers": tuple({k: array(t) for k, t in entry.items()}
                           for entry in cache["layers"]),
           "index": array(cache["index"])}
    if "enc_out" in cache:
        out["enc_out"] = array(cache["enc_out"])
    return out
