"""Runtime sanitizer: NaN/Inf probes on the flat buffers of a round
(PyTorch port of ``repro/core/sanitize.py``).

``--sanitize`` (``repro_torch.launch.train``) builds the round with
:func:`check_flat_groups` probes at two sites — the post-round server
parameters of a synchronous round, and the decoded (possibly garbled)
client deltas an async tick writes into its pool — so a NaN/Inf payload
(a garbled uplink, an exploding local step, a bad codec decode) is caught
the round it happens, with an error that names the offending flat dtype
group and the round, instead of surfacing rounds later as a poisoned
parameter tree.

Where the JAX package re-jits the round under ``checkify``, the port
counts on the device: each probe leaves one int64 count per flat group
on the device, in the :class:`ProbeLog` that :func:`sanitize_round` opens
around the round function, and the log is read back once, after the
call, K rounds' probes together — a K-round call still reads nothing
back while it runs.  The first group with a non-finite count raises
:class:`SanitizeError`.

The sanitizer is strictly additive: a probe only reads, and with
``sanitize=False`` (the default) no probe runs and the round is the
unsanitized one, bit for bit.

The JAX launcher's ``--sanitize`` also turns on ``jax_debug_nans``, which
re-runs a jitted function op by op when it returns a NaN.  Its torch
counterpart is ``torch.autograd.detect_anomaly(check_nan=True)``: it
raises naming the backward function that first returned a NaN, and it
does so inside the port's ``torch.func`` client update (a NaN planted in
one client's data raises in ``LogSoftmaxBackward0``, vmap and scan
cohorts alike, on the CPU).  So the launcher's ``--sanitize`` runs the
training under it.  It records a traceback for every autograd node,
about 5x the host time of a smoke round on the CPU, so ``sanitize=True``
of :class:`~repro_torch.core.trainer.FederatedTrainer` and of
``run_training`` plants only the probes.  When both are on and a
probe saw a non-finite payload before anomaly mode raised on it
downstream, the probe's error wins (:func:`probe_log`).
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
from typing import List, Optional, Sequence, Union

import torch

__all__ = ["SanitizeError", "ProbeLog", "check_flat_groups", "probe_log",
           "sanitize_round"]


class SanitizeError(RuntimeError):
    """A sanitizer probe found non-finite elements in a flat buffer."""


@dataclasses.dataclass
class _Probe:
    counts: torch.Tensor          # (groups,) int64, on the probed device
    spec: object                  # the FlatSpec the buffers follow
    where: str
    round_idx: Optional[int]


class ProbeLog:
    """The probes of one call, kept on the device until :meth:`check`."""

    def __init__(self):
        self.probes: List[_Probe] = []

    def check(self) -> None:
        """Read every probe's counts back in one copy and raise
        :class:`SanitizeError` for the first non-zero count, in probe
        order (the earliest round first)."""
        if not self.probes:
            return
        dev = self.probes[0].counts.device
        counts = torch.cat([p.counts.to(dev) for p in self.probes]).tolist()
        at = 0
        for p in self.probes:
            for i, g in enumerate(p.spec.groups):
                n = counts[at + i]
                if n:
                    raise SanitizeError(_message(p, i, g, n))
            at += len(p.spec.groups)


_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_sanitize_log", default=None)


def _message(p: _Probe, i: int, g, n: int) -> str:
    dtype = str(g.dtype).replace("torch.", "")
    at = p.where if p.round_idx is None \
        else f"{p.where}, round {p.round_idx}"
    return (f"sanitize: {n} non-finite element(s) in flat group {i} "
            f"(dtype {dtype}, {g.rows}x128 fp32 buffer) at {at}; map "
            "elements back to parameter leaves with "
            "repro_torch.core.flat.unflatten_tree")


def _nonfinite(buf: Union[torch.Tensor, Sequence[torch.Tensor]]
               ) -> torch.Tensor:
    if isinstance(buf, torch.Tensor):
        return torch.isfinite(buf).logical_not_().sum()
    return torch.stack([_nonfinite(b) for b in buf]).sum()


@torch.no_grad()
def check_flat_groups(spec, bufs, where: str, *,
                      round_idx: Optional[int] = None) -> None:
    """Probe every flat dtype-group buffer for non-finite values.

    ``spec`` is the :class:`repro_torch.core.flat.FlatSpec` describing
    ``bufs``: one fp32 ``(rows, 128)`` buffer per dtype group (or with
    leading batch axes), or per group a sequence of such buffers (the
    pool slots an async tick wrote).  The counts stay on the device in
    the active :class:`ProbeLog` (inside :func:`sanitize_round`); outside
    one they are read back and checked at once.  The error names the
    flat group, the probe site and ``round_idx``."""
    probe = _Probe(torch.stack([_nonfinite(b) for b in bufs]), spec, where,
                   round_idx)
    log = _ACTIVE.get()
    if log is not None:
        log.probes.append(probe)
        return
    log = ProbeLog()
    log.probes.append(probe)
    log.check()


@contextlib.contextmanager
def probe_log():
    """Collect the probes run inside the block and check them on exit.
    If the block raised after a probe saw a non-finite value (anomaly
    mode failing on the NaN a garbled payload spread), the probe's
    :class:`SanitizeError`, which names where the NaN entered, is raised
    from that error."""
    log = ProbeLog()
    token = _ACTIVE.set(log)
    try:
        yield log
    except Exception as e:
        _ACTIVE.reset(token)
        try:
            log.check()
        except SanitizeError as found:
            raise found from e
        raise
    _ACTIVE.reset(token)
    log.check()


def sanitize_round(fn):
    """Wrap a round function so the probes its rounds plant are read back
    once, after the call, and raise :class:`SanitizeError` there.  Inside
    an open :func:`probe_log` (the trainer opens one around a chunk's
    dispatch and device sync) the probes join that log instead, and are
    read when it closes."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        if _ACTIVE.get() is not None:
            return fn(*args, **kwargs)
        with probe_log():
            return fn(*args, **kwargs)
    # the roofline trace skips it: the probes are read on the host
    wrapped.sanitized = True
    return wrapped
