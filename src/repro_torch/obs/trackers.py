"""MetricsTracker — the fifth plugin registry: where round metrics go
(PyTorch port of ``repro/obs/trackers.py``; stdlib only, the same names,
file formats and error messages).

A :class:`MetricsTracker` is the one sink every entry point shares:

  * ``log_metrics(round_idx, metrics)`` — one per-round record (the
    trainer's history dict: plain floats / ints / lists, already on the
    host and JSON-serializable);
  * ``log_event(name, data)`` — out-of-band events: the trainer's
    ``run_start`` / ``run_finish``, the per-phase wall-clock spans
    (``phase`` events from :func:`span`: sample_stack, dispatch,
    device_sync, checkpoint), profiler start/stop, the trace summary,
    the method loop's ``method_start`` / ``method_finish``;
  * ``finish()`` — flush + close (idempotent).

Built-ins (registered through the shared
:class:`repro_torch.core.registry.Registry`):

  ============  =========================================================
  ``noop``      drops everything — the default; a noop-tracked run is
                bitwise an untracked one
  ``console``   the trainer's ``[train] round N k=v ...`` line every
                ``every`` rounds and on the final round
  ``jsonl``     one JSON object per line in ``<run_dir>/metrics.jsonl``
                (records AND events, distinguished by ``"kind"``)
  ``csv``       ``<run_dir>/metrics.csv`` with a header pinned to the
                first record's key set (the schema
                ``repro_torch.obs.schema.round_metric_keys`` states is
                stable per config); events go to ``<run_dir>/events.csv``
  ``composite`` fan-out to several trackers (``resolve_tracker`` builds
                one from a comma list: ``--tracker jsonl,console``)
  ============  =========================================================

``tensorboard`` is also registered, behind an optional-dependency gate:
it needs a ``SummaryWriter`` backend (``tensorboardX``, or
``torch.utils.tensorboard``, which needs the ``tensorboard`` package) and
raises an ImportError naming the install when neither imports.

Register alternatives with :func:`register_tracker`; any registered name
is selectable via ``FederatedTrainer(..., tracker="name")`` and
``train.py --tracker name``.
"""
from __future__ import annotations

import contextlib
import csv as _csv
import json
import os
import time
from typing import Any, Callable, Dict, Iterable, Optional, Sequence

from repro_torch.core.registry import Registry

__all__ = ["MetricsTracker", "NoopTracker", "ConsoleTracker",
           "JsonlTracker", "CsvTracker", "CompositeTracker",
           "TensorBoardTracker", "register_tracker", "get_tracker",
           "available_trackers", "resolve_tracker", "span"]


class MetricsTracker:
    """Protocol.  Trackers are constructed per-run via the registry
    factory ``factory(run_dir=None, **kw) -> MetricsTracker``; file-backed
    trackers put their artifacts under ``run_dir``."""
    name: str = "?"

    def log_metrics(self, round_idx: int, metrics: Dict[str, Any]) -> None:
        raise NotImplementedError

    def log_event(self, name: str, data: Optional[Dict[str, Any]] = None
                  ) -> None:
        raise NotImplementedError

    def finish(self) -> None:
        """Flush and close; must be safe to call more than once."""


_TRACKERS = Registry("metrics tracker", "repro_torch.obs.register_tracker")


def register_tracker(name: str):
    """Decorator registering a tracker factory
    ``factory(run_dir=None, **kw) -> MetricsTracker``."""
    def deco(factory: Callable) -> Callable:
        _TRACKERS.register(name, factory)
        return factory
    return deco


def get_tracker(name: str) -> Callable:
    return _TRACKERS.get(name)


def available_trackers() -> tuple:
    return _TRACKERS.names()


def resolve_tracker(spec, *, run_dir: Optional[str] = None,
                    owned: Optional[list] = None,
                    **kw) -> "MetricsTracker":
    """One resolution path for every entry point:

      * ``None`` -> the ``noop`` tracker;
      * a :class:`MetricsTracker` instance -> itself;
      * a registry name -> ``factory(run_dir=run_dir, **kw)``;
      * a comma list (``"jsonl,console"``) or a sequence of any of the
        above -> a :class:`CompositeTracker` over the resolved parts.

    ``owned`` (when given) collects the trackers this call CONSTRUCTED —
    registry-built leaves, not passed-through instances — so a scoped
    caller (e.g. a per-``run()`` override) can ``finish()`` exactly what
    it created and never close a tracker the user still holds.
    """
    if spec is None:
        return NoopTracker()
    if isinstance(spec, MetricsTracker):
        return spec
    if isinstance(spec, str):
        if "," in spec:
            spec = [s.strip() for s in spec.split(",") if s.strip()]
        else:
            t = get_tracker(spec)(run_dir=run_dir, **kw)
            if owned is not None:
                owned.append(t)
            return t
    if isinstance(spec, (list, tuple)):
        return CompositeTracker(
            [resolve_tracker(s, run_dir=run_dir, owned=owned, **kw)
             for s in spec])
    raise ValueError(
        f"cannot resolve a metrics tracker from {spec!r}; expected None, a "
        f"MetricsTracker, a registered name {available_trackers()}, a "
        "comma list of names, or a sequence of those")


def _require_run_dir(run_dir: Optional[str], tracker: str, artifact: str
                     ) -> str:
    if run_dir is None:
        raise ValueError(
            f"the {tracker!r} tracker writes {artifact} and needs a run "
            "directory; pass one (FederatedTrainer's run_dir argument / "
            "train.py --run-dir) or use the 'noop'/'console' tracker")
    os.makedirs(run_dir, exist_ok=True)
    return run_dir


@contextlib.contextmanager
def span(tracker: MetricsTracker, phase: str, **data):
    """Wall-clock span emitted as a ``phase`` tracker event — the
    round-phase profiler's host-side half.  The trainer wraps each chunk's
    sample/stack, dispatch (host issue time: the K-round call returns
    when the host has issued its work), device-sync
    (``torch.cuda.synchronize()``: the device's drain tail) and
    checkpoint stages, so a host-bound round shows a long ``dispatch``
    next to a short ``device_sync``.

    Yields a dict that carries ``dur_s`` after the block exits, so the
    caller can read the measured duration back without re-timing."""
    info = dict(data)
    t0 = time.perf_counter()
    try:
        yield info
    finally:
        info["dur_s"] = time.perf_counter() - t0
        tracker.log_event("phase", {"phase": phase, **info})


# ---------------------------------------------------------------------------
# built-in trackers
# ---------------------------------------------------------------------------
@register_tracker("noop")
class NoopTracker(MetricsTracker):
    """Drops everything.  The default: an untracked run and a noop-tracked
    run execute the same operations on the same streams, so they are
    bitwise equal."""
    name = "noop"

    def __init__(self, run_dir: Optional[str] = None):
        del run_dir

    def log_metrics(self, round_idx, metrics):
        pass

    def log_event(self, name, data=None):
        pass

    def finish(self):
        pass


@register_tracker("console")
class ConsoleTracker(MetricsTracker):
    """The classic trainer progress line, every ``every`` rounds (plus the
    final round, learned from the trainer's ``run_start`` event)."""
    name = "console"

    def __init__(self, run_dir: Optional[str] = None, *, every: int = 1,
                 log_fn: Callable = print):
        del run_dir
        self._every = max(int(every), 1)
        self._log = log_fn
        self._t0 = time.perf_counter()
        self._final_round: Optional[int] = None

    def log_metrics(self, round_idx, metrics):
        if round_idx % self._every and round_idx != self._final_round:
            return
        body = " ".join(f"{k}={v:.4f}" for k, v in metrics.items()
                        if k != "round" and isinstance(v, float))
        self._log(f"[train] round {round_idx:4d} {body} "
                  f"({time.perf_counter() - self._t0:.1f}s)")

    def log_event(self, name, data=None):
        if name == "run_start" and data and "final_round" in data:
            self._final_round = int(data["final_round"])

    def finish(self):
        pass


class _FileTracker(MetricsTracker):
    """Shared lazy-open / idempotent-close plumbing for file-backed
    trackers."""

    def __init__(self):
        self._closed = False

    def _check_open(self, what: str):
        if self._closed:
            raise RuntimeError(
                f"{self.name} tracker received {what} after finish(); "
                "trackers are closed once per run — build a new one (or "
                "delay finish()) for further logging")

    def finish(self):
        self._closed = True


@register_tracker("jsonl")
class JsonlTracker(_FileTracker):
    """One JSON object per line in ``<run_dir>/metrics.jsonl``:

        {"kind": "metrics", "round": 3, "client_loss": ..., ...}
        {"kind": "event", "event": "phase", "t": ..., "phase": "dispatch",
         "dur_s": ...}

    Append-mode, so a ``--resume`` run extends the same file; ``t`` is a
    host ``time.time()`` stamp on events.  Flushed on every ``run_finish``
    event and on :meth:`finish`."""
    name = "jsonl"

    def __init__(self, run_dir: Optional[str] = None,
                 filename: str = "metrics.jsonl"):
        super().__init__()
        run_dir = _require_run_dir(run_dir, self.name, "metrics.jsonl")
        self.path = os.path.join(run_dir, filename)
        self._fh = open(self.path, "a", encoding="utf-8")

    def log_metrics(self, round_idx, metrics):
        self._check_open("a metrics record")
        rec = {"kind": "metrics", "round": int(round_idx)}
        rec.update((k, v) for k, v in metrics.items() if k != "round")
        self._fh.write(json.dumps(rec) + "\n")

    def log_event(self, name, data=None):
        self._check_open("an event")
        rec = {"kind": "event", "event": name, "t": time.time()}
        rec.update(data or {})
        self._fh.write(json.dumps(rec) + "\n")
        if name == "run_finish":
            self._fh.flush()

    def finish(self):
        if not self._closed:
            self._fh.flush()
            self._fh.close()
        super().finish()


@register_tracker("csv")
class CsvTracker(_FileTracker):
    """``<run_dir>/metrics.csv`` — header pinned to the FIRST record's
    sorted key set.  A record with different keys raises (per-config the
    round metrics schema is stable — ``repro_torch.obs.schema`` states
    it — so drift here means a
    caller mixed configs into one file).  Vector metrics (e.g.
    ``staleness_hist``) are JSON-encoded in their cell.  Events land in
    ``<run_dir>/events.csv`` as ``(t, event, json_payload)``.

    Append-mode like jsonl, so a ``--resume`` run extends the same file
    instead of truncating the earlier rounds: an existing file's header
    row becomes the pinned header (resuming under a different config
    raises on the first record).  Flushed on every ``run_finish`` event
    and on :meth:`finish`."""
    name = "csv"

    def __init__(self, run_dir: Optional[str] = None,
                 filename: str = "metrics.csv"):
        super().__init__()
        run_dir = _require_run_dir(run_dir, self.name, "metrics.csv")
        self.path = os.path.join(run_dir, filename)
        self.events_path = os.path.join(run_dir, "events.csv")
        self._header: Optional[Sequence[str]] = self._existing_header(
            self.path)
        self._fh = open(self.path, "a", newline="", encoding="utf-8")
        self._writer = _csv.writer(self._fh)
        self._efh = None

    @staticmethod
    def _existing_header(path: str) -> Optional[Sequence[str]]:
        if not (os.path.exists(path) and os.path.getsize(path) > 0):
            return None
        with open(path, "r", newline="", encoding="utf-8") as f:
            return next(_csv.reader(f), None)

    def log_metrics(self, round_idx, metrics):
        self._check_open("a metrics record")
        rec = {"round": int(round_idx),
               **{k: v for k, v in metrics.items() if k != "round"}}
        if self._header is None:
            self._header = ["round"] + sorted(k for k in rec if k != "round")
            self._writer.writerow(self._header)
        missing = set(self._header) - set(rec)
        extra = set(rec) - set(self._header)
        if missing or extra:
            raise ValueError(
                f"csv tracker header is pinned to the first record's keys "
                f"{list(self._header)} but this record differs "
                f"(missing: {sorted(missing)}, new: {sorted(extra)}); "
                "per-config round metrics are schema-stable "
                "(repro_torch.obs.schema) — use one tracker per config, or the "
                "jsonl tracker for mixed streams")
        self._writer.writerow(
            [json.dumps(rec[k]) if isinstance(rec[k], (list, tuple))
             else rec[k] for k in self._header])

    def log_event(self, name, data=None):
        self._check_open("an event")
        if self._efh is None:
            fresh = self._existing_header(self.events_path) is None
            self._efh = open(self.events_path, "a", newline="",
                             encoding="utf-8")
            self._ewriter = _csv.writer(self._efh)
            if fresh:
                self._ewriter.writerow(["t", "event", "data"])
        self._ewriter.writerow([time.time(), name, json.dumps(data or {})])
        if name == "run_finish":
            self._fh.flush()
            self._efh.flush()

    def finish(self):
        if not self._closed:
            self._fh.flush()
            self._fh.close()
            if self._efh is not None:
                self._efh.flush()
                self._efh.close()
        super().finish()


@register_tracker("composite")
class CompositeTracker(MetricsTracker):
    """Fan-out to several trackers (``resolve_tracker("jsonl,console")``).
    ``finish`` closes every child; children added by the trainer's
    ``log_every`` back-compat path are owned by the run that built them."""
    name = "composite"

    def __init__(self, trackers: Iterable[MetricsTracker] = (),
                 run_dir: Optional[str] = None):
        del run_dir
        self.trackers = list(trackers)

    def log_metrics(self, round_idx, metrics):
        for t in self.trackers:
            t.log_metrics(round_idx, metrics)

    def log_event(self, name, data=None):
        for t in self.trackers:
            t.log_event(name, data)

    def finish(self):
        for t in self.trackers:
            t.finish()


def _summary_writer_cls():
    """The optional-dependency gate for the tensorboard tracker: prefer
    ``tensorboardX`` (pure-python, no TF), fall back to torch's bundled
    writer, and otherwise raise an ImportError that names the install —
    the registry factory stays importable either way, so
    ``available_trackers()`` always lists the name."""
    try:
        from tensorboardX import SummaryWriter
        return SummaryWriter
    except ImportError:
        pass
    try:
        from torch.utils.tensorboard import SummaryWriter
        return SummaryWriter
    except ImportError as e:
        raise ImportError(
            "the 'tensorboard' tracker needs a SummaryWriter backend and "
            "neither 'tensorboardX' nor torch.utils.tensorboard (which "
            "needs the 'tensorboard' package) is importable; pip install "
            "tensorboardX (the lightweight extra) — or use the built-in "
            "jsonl/csv trackers, which need nothing") from e


@register_tracker("tensorboard")
class TensorBoardTracker(_FileTracker):
    """TensorBoard event files under ``<run_dir>/tb/`` — scalars from
    every round record (vector metrics like ``staleness_hist`` become
    histograms when the backend supports them, and are skipped
    otherwise), plus per-phase ``span`` durations on their round step.
    Other events are counted, not plotted — the jsonl stream stays the
    full-fidelity record; this is the dashboard view."""
    name = "tensorboard"

    def __init__(self, run_dir: Optional[str] = None,
                 subdir: str = "tb"):
        super().__init__()
        cls = _summary_writer_cls()
        run_dir = _require_run_dir(run_dir, self.name,
                                   "tensorboard event files")
        self.log_dir = os.path.join(run_dir, subdir)
        self._writer = cls(self.log_dir)

    def log_metrics(self, round_idx, metrics):
        self._check_open("a metrics record")
        for k, v in metrics.items():
            if k == "round":
                continue
            if isinstance(v, (list, tuple)):
                try:
                    self._writer.add_histogram(f"round/{k}", list(v),
                                               int(round_idx))
                except Exception:  # noqa: BLE001 — backend-optional
                    pass
            elif isinstance(v, (int, float)):
                self._writer.add_scalar(f"round/{k}", float(v),
                                        int(round_idx))

    def log_event(self, name, data=None):
        self._check_open("an event")
        data = data or {}
        if name == "phase" and "dur_s" in data:
            self._writer.add_scalar(f"phase/{data.get('phase', '?')}_s",
                                    float(data["dur_s"]),
                                    int(data.get("round", 0)))
        elif name == "roofline":
            for k in ("predicted_rounds_per_s", "measured_rounds_per_s"):
                v = data.get(k)
                if isinstance(v, (int, float)):
                    self._writer.add_scalar(f"roofline/{k}", float(v),
                                            int(data.get("rounds_per_call",
                                                         0)))

    def finish(self):
        if not self._closed:
            self._writer.flush()
            self._writer.close()
        super().finish()
