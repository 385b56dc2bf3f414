"""Checkpoint blobs in the JAX package's format (PyTorch port of
``repro/checkpoint/ckpt.py``), so that a blob either package writes the
other restores.

A blob is one msgpack map ``{"leaves": {path: {"dtype", "shape",
"data"}}, "extra": {...}}``: every leaf of the tree as its numpy dtype
name, its shape and its raw bytes, under JAX's path for it, in the order
``jax.tree_util`` flattens the JAX tree.  The port's trees map onto JAX's:
a dict's keys are path components, and a dotted key (the port's parameter
names, ``"blocks.0.attn.wq"``) is the path of the JAX nested tree
(``blocks/0/attn/wq``, where ``blocks`` is a tuple); a dict level whose
keys are all digits is a tuple and orders by index; tuple slots key by
index (``opt/m/0``); a Python int is an int32 scalar (the round counter).

The machine the port runs on need not have the ``msgpack`` package, so the
port writes and reads the subset of msgpack a blob uses itself (nil,
bool, int, float64, str, bin, array and map), byte for byte what
``msgpack.packb(payload, use_bin_type=True)`` gives.  One leaf is one
msgpack bin, which holds at most 2**32 - 1 bytes; a larger leaf cannot be
saved in this format (in either package), and :func:`save` says which.

Writes are crash-safe: the blob goes to a temp file in the target
directory, is fsynced and renamed over ``path``, and the temp file is
removed on any failure, so a writer killed at any point leaves the old
blob or the new one.  Leaves stream to the file one at a time from a host
copy of that leaf; :func:`restore` reads the file once and copies each
leaf to the device of the tree it restores into.
"""
from __future__ import annotations

import os
import struct
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

__all__ = ["save", "restore", "check_leaf_bytes", "tree_leaves", "tree_map",
           "packb", "unpackb"]

_SEP = "/"
BIN_MAX = 2**32 - 1          # msgpack bin32's length field


# ---------------------------------------------------------------------------
# trees: JAX's leaf paths and order
# ---------------------------------------------------------------------------
def _nest(d: dict) -> dict:
    """A dict whose keys may be dotted paths -> the nested dict."""
    root: dict = {}
    for k, v in d.items():
        node = root
        *parents, last = str(k).split(".")
        for part in parents:
            node = node.setdefault(part, {})
        node[last] = v
    return root


def _children(tree: dict):
    keys = list(tree)
    if keys and all(k.isdigit() for k in keys):
        return sorted(keys, key=int)          # a tuple in the JAX tree
    return sorted(keys)


def tree_leaves(tree: Any, prefix: Tuple[str, ...] = ()
                ) -> List[Tuple[str, Any]]:
    """``(path, leaf)`` pairs in ``jax.tree_util`` flatten order of the JAX
    tree ``tree`` stands for; an empty dict or tuple has no leaves."""
    if isinstance(tree, dict):
        nested = _nest(tree)
        out = []
        for k in _children(nested):
            out += tree_leaves(nested[k], prefix + (k,))
        return out
    if isinstance(tree, (tuple, list)):
        out = []
        for i, v in enumerate(tree):
            out += tree_leaves(v, prefix + (str(i),))
        return out
    return [(_SEP.join(prefix), tree)]


def tree_map(tree: Any, fn: Callable, prefix: Tuple[str, ...] = ()):
    """``tree`` with each leaf replaced by ``fn(path, leaf)``, its own
    structure (dotted keys, tuples) kept."""
    if isinstance(tree, dict):
        return {k: tree_map(v, fn, prefix + tuple(str(k).split(".")))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(v, fn, prefix + (str(i),))
                          for i, v in enumerate(tree))
    return fn(_SEP.join(prefix), tree)


def _meta(leaf) -> Tuple[str, tuple, int]:
    """(numpy dtype name, shape, bytes) of a leaf, without copying it."""
    if isinstance(leaf, torch.Tensor):
        dt = torch.empty((), dtype=leaf.dtype).numpy().dtype
        return str(dt), tuple(leaf.shape), leaf.numel() * dt.itemsize
    if isinstance(leaf, bool) or not isinstance(leaf, (int, float,
                                                       np.ndarray,
                                                       np.generic)):
        raise TypeError(f"checkpoint leaf of type {type(leaf).__name__} is "
                        "not an array")
    a = _host(leaf)
    return str(a.dtype), a.shape, a.nbytes


def _host(leaf) -> np.ndarray:
    """A leaf as a C-contiguous host array (a view where it can be)."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu().numpy()
    elif isinstance(leaf, int):
        return np.asarray(leaf, np.int32)
    elif isinstance(leaf, float):
        return np.asarray(leaf, np.float32)
    return np.asarray(leaf, order="C")


def check_leaf_bytes(path: str, nbytes: int) -> None:
    """Raise unless a leaf of ``nbytes`` fits one msgpack bin."""
    if nbytes > BIN_MAX:
        raise ValueError(
            f"checkpoint leaf {path!r} is {nbytes:,} bytes, and one "
            f"msgpack bin holds at most {BIN_MAX:,}: the blob format (the "
            "JAX package's repro.checkpoint, which stores each leaf as one "
            "bin) cannot hold it, so no blob is written. Save a smaller "
            "state (e.g. a buffered_async pool of fewer slots).")


# ---------------------------------------------------------------------------
# the msgpack subset
# ---------------------------------------------------------------------------
def _int(x: int) -> bytes:
    if 0 <= x < 0x80:
        return bytes((x,))
    if -0x20 <= x < 0:
        return bytes((x & 0xFF,))
    if 0 < x <= 0xFF:
        return b"\xcc" + struct.pack(">B", x)
    if 0 < x <= 0xFFFF:
        return b"\xcd" + struct.pack(">H", x)
    if 0 < x <= 0xFFFFFFFF:
        return b"\xce" + struct.pack(">I", x)
    if 0 < x <= 0xFFFFFFFFFFFFFFFF:
        return b"\xcf" + struct.pack(">Q", x)
    if -0x80 <= x:
        return b"\xd0" + struct.pack(">b", x)
    if -0x8000 <= x:
        return b"\xd1" + struct.pack(">h", x)
    if -0x80000000 <= x:
        return b"\xd2" + struct.pack(">i", x)
    if -0x8000000000000000 <= x:
        return b"\xd3" + struct.pack(">q", x)
    raise OverflowError(f"integer {x} does not fit msgpack's 64 bits")


def _sized(n: int, fix, fix_max: int, codes: bytes) -> bytes:
    """A length header: the fix form ``fix | n`` below ``fix_max`` (``fix``
    None: there is none), else the first of the 8/16/32-bit forms in
    ``codes`` that holds ``n`` (a code 0: msgpack has no such form)."""
    if fix is not None and n < fix_max:
        return bytes((fix | n,))
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"),
                                (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code and n <= limit:
            return bytes((code,)) + struct.pack(fmt, n)
    raise ValueError(f"msgpack object of length {n:,} exceeds 2**32 - 1")


def _bin_header(n: int) -> bytes:
    return _sized(n, None, 0, bytes((0xC4, 0xC5, 0xC6)))


def _map_header(n: int) -> bytes:
    return _sized(n, 0x80, 16, bytes((0, 0xDE, 0xDF)))


def _pack(obj, write: Callable[[bytes], Any]) -> None:
    if obj is None:
        write(b"\xc0")
    elif obj is True or obj is False:
        write(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        write(_int(obj))
    elif isinstance(obj, float):
        write(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        write(_sized(len(b), 0xA0, 32, bytes((0xD9, 0xDA, 0xDB))) + b)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        write(_bin_header(memoryview(obj).nbytes))
        write(obj)
    elif isinstance(obj, (list, tuple)):
        write(_sized(len(obj), 0x90, 16, bytes((0, 0xDC, 0xDD))))
        for v in obj:
            _pack(v, write)
    elif isinstance(obj, dict):
        write(_map_header(len(obj)))
        for k, v in obj.items():
            _pack(k, write)
            _pack(v, write)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj) -> bytes:
    """``msgpack.packb(obj, use_bin_type=True)`` for the subset."""
    parts: List[bytes] = []
    _pack(obj, lambda b: parts.append(bytes(b)))
    return b"".join(parts)


class _Reader:
    def __init__(self, buf: memoryview):
        self.buf, self.pos = buf, 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError(f"truncated: {n} bytes wanted at offset "
                             f"{self.pos} of {len(self.buf)}")
        out, self.pos = self.buf[self.pos:end], end
        return out

    def num(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self):
        c = self.num(">B")
        if c < 0x80:
            return c
        if c >= 0xE0:
            return c - 0x100
        if 0x80 <= c <= 0x8F:
            return self.map(c & 0x0F)
        if 0x90 <= c <= 0x9F:
            return self.array(c & 0x0F)
        if 0xA0 <= c <= 0xBF:
            return self.str(c & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if c in simple:
            return simple[c]
        sizes = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if c in sizes:
            return self.take(self.num(sizes[c]))
        nums = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if c in nums:
            return self.num(nums[c])
        strs = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if c in strs:
            return self.str(self.num(strs[c]))
        if c in (0xDC, 0xDD):
            return self.array(self.num(">H" if c == 0xDC else ">I"))
        if c in (0xDE, 0xDF):
            return self.map(self.num(">H" if c == 0xDE else ">I"))
        raise ValueError(f"msgpack type byte 0x{c:02x} at offset "
                         f"{self.pos - 1} is not one a checkpoint uses")

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            if not isinstance(k, (str, memoryview)):
                raise ValueError(f"map key of type {type(k).__name__} "
                                 "(msgpack's strict_map_key)")
            out[bytes(k) if isinstance(k, memoryview) else k] = self.obj()
        return out


def unpackb(buf) -> Any:
    """``msgpack.unpackb(buf, raw=False)`` for the subset; bins come back
    as memoryviews into ``buf`` (no copy).  Raises ValueError on a
    truncated, malformed or overlong buffer."""
    r = _Reader(memoryview(buf).cast("B"))
    obj = r.obj()
    if r.pos != len(r.buf):
        raise ValueError(f"extra data: {len(r.buf) - r.pos} bytes after "
                         "the first object")
    return obj


def _plain(obj):
    """Bins (memoryviews) in ``extra`` -> bytes, as msgpack gives them."""
    if isinstance(obj, memoryview):
        return bytes(obj)
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_plain(v) for v in obj]
    return obj


# ---------------------------------------------------------------------------
# save / restore
# ---------------------------------------------------------------------------
def _write_payload(f, leaves: List[Tuple[str, Any]], metas, extra) -> None:
    """Stream ``{"leaves": ..., "extra": extra}`` to ``f``: headers
    through :func:`packb`, each leaf's bytes from a host copy of it."""
    f.write(_map_header(2) + packb("leaves") + _map_header(len(leaves)))
    for (path, leaf), (dtype, shape, nbytes) in zip(leaves, metas):
        f.write(packb(path) + _map_header(3) + packb("dtype") + packb(dtype)
                + packb("shape") + packb(list(shape)) + packb("data")
                + _bin_header(nbytes))
        f.write(memoryview(_host(leaf).reshape(-1).view(np.uint8)))
    f.write(packb("extra") + packb(extra))


def save(path: str, tree: Any, *, extra: Dict[str, Any] | None = None
         ) -> None:
    """Write ``tree`` (nested dicts, tuples and lists of tensors, numpy
    arrays and Python ints; see the module docstring for the paths) and
    ``extra`` to ``path``, crash-safe.  Raises before writing anything if
    a leaf is too large for the format."""
    leaves = tree_leaves(tree)
    metas = [_meta(leaf) for _, leaf in leaves]
    for (p, _), (_, _, nbytes) in zip(leaves, metas):
        check_leaf_bytes(p, nbytes)
    tmp = f"{path}.tmp.{os.getpid()}"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    try:
        with open(tmp, "wb") as f:
            _write_payload(f, leaves, metas, extra or {})
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _read(path: str) -> dict:
    size = os.path.getsize(path)
    buf = bytearray(size)
    with open(path, "rb") as f:
        got = f.readinto(buf)
    try:
        if got != size:
            raise ValueError(f"read {got} of {size} bytes")
        payload = unpackb(buf)
    except Exception as e:
        raise ValueError(
            f"checkpoint {path!r} is not a readable msgpack blob "
            f"({type(e).__name__}: {e}) — truncated or corrupted on disk. "
            "Writers rename atomically, so the PREVIOUS checkpoint (if this "
            "path was ever written successfully) was replaced whole; this "
            "file was damaged after the fact. Re-save or restore an older "
            "copy.") from e
    if not isinstance(payload, dict) or "leaves" not in payload \
            or "extra" not in payload:
        raise ValueError(
            f"checkpoint {path!r} decoded but is not a checkpoint payload: "
            f"expected a dict with 'leaves' and 'extra' keys, got "
            f"{type(payload).__name__} with keys "
            f"{sorted(payload)[:8] if isinstance(payload, dict) else '?'} — "
            "was this file written by repro_torch.checkpoint.save (or the "
            "JAX package's repro.checkpoint.save)?")
    return payload


def restore(path: str, like: Any) -> Tuple[Any, Dict[str, Any]]:
    """Restore into the structure of ``like``: each leaf is read under
    its path, checked against ``like``'s shape and made like it — a tensor
    of its dtype on its device, a numpy array of its dtype, or a Python
    int.  Returns (tree, extra)."""
    payload = _read(path)
    leaves = payload["leaves"]

    def load(key, leaf):
        if key not in leaves:
            raise KeyError(
                f"checkpoint {path!r} has no leaf {key!r} — it was saved "
                f"from a different structure (saved leaves: "
                f"{sorted(leaves)[:8]}...).  Params-only checkpoints cannot "
                "resume a full server state; restore them into bare params "
                "instead.")
        rec = leaves[key]
        try:
            arr = np.frombuffer(rec["data"], dtype=np.dtype(rec["dtype"])
                                ).reshape(rec["shape"])
        except Exception as e:
            raise ValueError(
                f"checkpoint {path!r} leaf {key!r} is corrupt: "
                f"{len(rec.get('data', b''))} payload bytes do not decode "
                f"as dtype={rec.get('dtype')!r} shape={rec.get('shape')!r} "
                f"({type(e).__name__}: {e})") from e
        want = tuple(leaf.shape) if hasattr(leaf, "shape") else ()
        if tuple(arr.shape) != want:
            raise ValueError(
                f"checkpoint {path!r} leaf {key!r} has shape "
                f"{tuple(arr.shape)}, the tree restored into expects {want}")
        if isinstance(leaf, torch.Tensor):
            return torch.from_numpy(arr).to(device=leaf.device,
                                             dtype=leaf.dtype, copy=True)
        if isinstance(leaf, np.ndarray):
            return arr.astype(leaf.dtype, copy=True)
        return type(leaf)(arr.item())

    return tree_map(like, load), _plain(payload["extra"])
