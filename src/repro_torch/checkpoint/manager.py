"""Managed checkpoint store: background saves, retention, a manifest
(PyTorch port of ``repro/checkpoint/manager.py``; the same directory
layout, so either package reads the other's store):

    run_dir/checkpoints/
      manifest.json            {"steps": [...], "latest": N, ...}
      step_00000040.msgpack    one crash-safe ckpt.save blob per step

:meth:`CheckpointManager.save` copies the state to the host at once — a
copy of every leaf, since the round writes parameters and residuals in
place and a CPU tensor's ``.cpu()`` is the same storage — and deep-copies
``extra``, then hands the blob, the manifest and the pruning to one
daemon writer thread, so writes land in submission order.  A failed write
is raised on the next :meth:`save`, :meth:`wait` or :meth:`close`, and its
step is dropped from the index so ``latest()`` never names a blob that was
not written.

Retention: the newest ``keep_last`` saves survive; steps divisible by
``keep_every`` (when > 0) are kept for good.  The manifest is rewritten
(temp file and ``os.replace``) with the survivors before the dropped blobs
are unlinked.
"""
from __future__ import annotations

import copy
import json
import os
import queue
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.ckpt import tree_map
from repro_torch.checkpoint.ckpt import restore as ckpt_restore
from repro_torch.checkpoint.ckpt import save as ckpt_save

__all__ = ["CheckpointManager"]

_MANIFEST = "manifest.json"


def _blob_name(step: int) -> str:
    return f"step_{step:08d}.msgpack"


def host_copy(tree: Any) -> Any:
    """Every leaf of ``tree`` copied to the host: tensors to CPU tensors
    (a copy even of a CPU tensor), numpy arrays copied, ints kept."""
    def leaf(_, x):
        if isinstance(x, torch.Tensor):
            return x.detach().to("cpu", copy=True)
        if isinstance(x, np.ndarray):
            return np.array(x, copy=True)
        return x
    return tree_map(tree, leaf)


class CheckpointManager:
    """Background-thread checkpoint store with retention over one
    directory.  ``keep_last`` newest saves survive pruning; steps
    divisible by ``keep_every`` (when > 0) are kept for good."""

    def __init__(self, directory: str, *, keep_last: int = 3,
                 keep_every: int = 0):
        if keep_last < 1:
            raise ValueError(
                f"keep_last={keep_last} must be >= 1: retention always "
                "preserves the newest save (otherwise latest()/resume "
                "would race the pruner)")
        if keep_every < 0:
            raise ValueError(f"keep_every={keep_every} must be >= 0 "
                             "(0 disables milestone retention)")
        self.directory = directory
        self.keep_last = int(keep_last)
        self.keep_every = int(keep_every)
        os.makedirs(directory, exist_ok=True)
        self._manifest = self._read_manifest()
        self._queue: "queue.Queue" = queue.Queue()
        self._error: Optional[Tuple[int, Exception]] = None
        self._closed = False
        self._worker: Optional[threading.Thread] = threading.Thread(
            target=self._drain, name="ckpt-manager", daemon=True)
        self._worker.start()

    # ---- public API -------------------------------------------------------
    def save(self, step: int, tree: Any,
             extra: Optional[Dict[str, Any]] = None) -> None:
        """Copy ``tree`` to the host now and schedule the blob write.
        ``step`` must be strictly increasing across saves."""
        self._raise_pending()
        if self._closed:
            raise RuntimeError("CheckpointManager is closed; create a new "
                               "one to keep saving")
        steps = self._manifest["steps"]
        if steps and step <= steps[-1]:
            raise ValueError(
                f"checkpoint step {step} is not after the last saved step "
                f"{steps[-1]}; the manager orders blobs by step — resuming "
                "into an earlier round needs a fresh directory")
        host = host_copy(tree)
        # a deep copy: the trainer keeps appending to the history it passes
        snapshot = copy.deepcopy(extra) if extra else {}
        self._queue.put((step, host, snapshot))
        # latest() reflects pending saves; the manifest on disk follows
        # when the worker has written the blob
        steps.append(int(step))

    def latest(self) -> Optional[int]:
        """Newest saved (or save-pending) step, or None for an empty
        store.  A fresh process sees the manifest on disk."""
        steps = self._manifest["steps"]
        return steps[-1] if steps else None

    def path(self, step: int) -> str:
        return os.path.join(self.directory, _blob_name(step))

    def restore_latest(self, like: Any
                       ) -> Optional[Tuple[Any, Dict[str, Any], int]]:
        """``(tree, extra, step)`` of the newest blob, or None for an empty
        store.  Waits for pending writes first."""
        self.wait()
        step = self.latest()
        if step is None:
            return None
        tree, extra = ckpt_restore(self.path(step), like)
        return tree, extra, step

    def wait(self) -> None:
        """Block until every queued save is on disk; raise a writer
        failure."""
        self._queue.join()
        self._raise_pending()

    def close(self) -> None:
        """Drain and stop the writer (idempotent)."""
        if self._closed:
            return
        self.wait()
        self._closed = True
        if self._worker is not None:
            self._queue.put(None)
            self._worker.join()
            self._worker = None
        self._raise_pending()

    def saved_steps(self) -> List[int]:
        """Steps retained on disk (after pruning)."""
        return list(self._read_manifest()["steps"])

    def _raise_pending(self) -> None:
        if self._error is not None:
            (step, e), self._error = self._error, None
            raise RuntimeError(
                f"a background checkpoint write failed for step {step}; "
                "the round loop continued past it, and the step was dropped "
                "from the store (latest() now names the newest blob actually "
                "on disk) — save that step again, or treat the run as "
                f"unresumable from it ({type(e).__name__}: {e})") from e

    # ---- writer side ------------------------------------------------------
    def _drain(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                self._queue.task_done()
                return
            step, host, extra = item
            try:
                self._write(step, host, extra)
            except Exception as e:  # raised on the next save/wait/close
                self._error = (step, e)
                try:
                    self._manifest["steps"].remove(step)
                except ValueError:
                    pass
            finally:
                del host
                self._queue.task_done()

    def _write(self, step: int, host: Any, extra: Dict[str, Any]) -> None:
        ckpt_save(self.path(step), host, extra=extra)
        m = self._read_manifest()
        if step not in m["steps"]:
            m["steps"] = sorted(m["steps"] + [int(step)])
        m["latest"] = m["steps"][-1]
        # manifest first, unlink second: a reader between the two sees a
        # manifest whose every blob exists
        dropped = self._prune_manifest(m)
        self._write_manifest(m)
        for s in dropped:
            try:
                os.remove(self.path(s))
            except FileNotFoundError:
                pass

    def _prune_manifest(self, m: Dict[str, Any]) -> List[int]:
        steps = m["steps"]
        keep = set(steps[-self.keep_last:])
        if self.keep_every > 0:
            keep |= {s for s in steps if s % self.keep_every == 0}
        dropped = [s for s in steps if s not in keep]
        m["steps"] = sorted(keep)
        return dropped

    # ---- manifest ---------------------------------------------------------
    def _read_manifest(self) -> Dict[str, Any]:
        p = os.path.join(self.directory, _MANIFEST)
        if not os.path.exists(p):
            return {"version": 1, "steps": [], "latest": None,
                    "keep_last": self.keep_last,
                    "keep_every": self.keep_every}
        with open(p, "r", encoding="utf-8") as f:
            m = json.load(f)
        m.setdefault("steps", [])
        return m

    def _write_manifest(self, m: Dict[str, Any]) -> None:
        m["keep_last"] = self.keep_last
        m["keep_every"] = self.keep_every
        p = os.path.join(self.directory, _MANIFEST)
        tmp = f"{p}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(m, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, p)

    def __enter__(self) -> "CheckpointManager":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
