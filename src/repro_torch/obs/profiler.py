"""Round-window profiler — the device-side half of ``--profile N``
(PyTorch port of ``repro/obs/profiler.py``, on ``torch.profiler``).

:class:`RoundProfiler` captures a ``torch.profiler`` trace of the round
window ``[start, start + rounds)`` into ``<run_dir>/profile/``.  The
trainer calls :meth:`maybe_start` before dispatching a chunk and
:meth:`maybe_stop` after the chunk's device sync; because a chunk spans
``rounds_per_call`` rounds, the window is widened to chunk boundaries
(you get at least the rounds you asked for, never fewer).  Start/stop are
emitted as ``profile_start`` / ``profile_stop`` tracker events so the
trace window is locatable in the metrics stream.

The capture records the host's operators always and the device's
kernels, copies and fills when the trainer runs on a card (CUPTI), and
is written by ``export_chrome_trace`` as
``<run_dir>/profile/round_<first>.pt.trace.json`` — Chrome-trace JSON,
viewable in Perfetto and read by :mod:`repro_torch.obs.trace_analysis`.
Shapes, memory and stacks are not recorded: a full-width smollm-360m
round issues over half a million operator calls, so the trace is large
as it stands.  Host-side phase timings (sample_stack, dispatch,
device_sync, checkpoint) come from the tracker ``phase`` events instead
— :func:`repro_torch.obs.span` — so the two views line up by round index.
"""
from __future__ import annotations

import os
from typing import Optional

import torch

from repro_torch.obs.trackers import MetricsTracker, NoopTracker

__all__ = ["RoundProfiler"]


class RoundProfiler:
    """One capture window per run.  Inert when ``rounds <= 0``.
    ``device``: the trainer's device; a CUDA device adds the device's
    activity to the capture."""

    def __init__(self, run_dir: Optional[str], *, start: int = 0,
                 rounds: int = 0,
                 tracker: Optional[MetricsTracker] = None, device=None):
        if rounds > 0 and run_dir is None:
            raise ValueError(
                "profiling writes a trace directory and needs a run "
                "directory; pass one (FederatedTrainer's run_dir argument "
                "/ train.py --run-dir)")
        self.start = int(start)
        self.rounds = int(rounds)
        self.trace_dir = (os.path.join(run_dir, "profile")
                          if run_dir is not None else None)
        self._tracker = tracker if tracker is not None else NoopTracker()
        self._cuda = torch.device(device or "cpu").type == "cuda"
        self._prof = None
        self._first = None
        self._done = rounds <= 0

    @property
    def active(self) -> bool:
        return self._prof is not None

    @property
    def trace_path(self) -> Optional[str]:
        """Where the current (or last) window's trace is written."""
        if self._first is None:
            return None
        return os.path.join(self.trace_dir,
                            f"round_{self._first}.pt.trace.json")

    def maybe_start(self, round_idx: int, k: int = 1) -> bool:
        """Open the capture if the chunk ``[round_idx, round_idx + k)``
        overlaps the window — ``k`` is the chunk length, so a window
        starting mid-chunk still opens on the chunk that contains it.
        Returns True iff the trace is running."""
        if not self._done and self._prof is None \
                and round_idx + k > self.start:
            from torch.profiler import ProfilerActivity, profile
            os.makedirs(self.trace_dir, exist_ok=True)
            acts = [ProfilerActivity.CPU]
            if self._cuda:
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
            self._first = round_idx
            self._tracker.log_event("profile_start",
                                    {"round": round_idx,
                                     "trace_dir": self.trace_dir})
        return self.active

    def maybe_stop(self, next_round: int) -> None:
        """Close the capture once the window is fully covered
        (``next_round`` = first round of the NEXT chunk).  Call after the
        chunk's device sync so the captured kernels have run."""
        if self.active and next_round >= self.start + self.rounds:
            self._stop(next_round - 1)

    def close(self) -> None:
        """Abort an open capture (run ended inside the window); its trace
        is still written."""
        if self.active:
            self._stop(-1)

    def _stop(self, last_round: int) -> None:
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(self.trace_path)
        self._done = True
        self._tracker.log_event("profile_stop",
                                {"round": last_round,
                                 "trace_dir": self.trace_dir})
