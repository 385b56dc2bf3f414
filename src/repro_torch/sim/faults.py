"""Seeded client fault injection (PyTorch port of ``repro/sim/faults.py``):
the traffic model of the buffered-async runtime
(``core/async_round.py``) and of the synchronous round's participation and
fault policy.

Fault taxonomy (per client, per round):

  * **crash** — the client dies mid-round: no local result exists at all;
  * **drop**  — local compute finishes but the uplink report is lost;
  * **delay** — the report arrives ``1..max_delay`` rounds late (the async
    pool delivers it that many ticks later; a sync barrier waits, unless
    ``round_deadline`` times it out);
  * **garble** — the payload arrives corrupted (scaled by
    ``U(-garble_scale, garble_scale)``).  Only the buffered-async delta
    pool models it; a synchronous round sees faults at the weight level,
    so a profile's garble is zeroed there and an explicit
    ``fault_garble`` is a config error (``core/round.py``).

Latency model (the sync deadline): client k completes at ``Exp(stagger) +
LogNormal(0, speed_tail)`` round-units, any delay fault added on top in
whole rounds.

The draws.  The JAX package folds the streams out of the round key with
threefry, which PyTorch cannot reproduce.  The port draws its own, once a
round, on the host, from a numpy generator keyed by ``(seed, FAULT_FOLD,
round_idx)``: deterministic under the run seed, and never touched by a
fault-free config (``FaultConfig.active`` is False).  The round takes the
draws as an argument (``core/round.py::RoundDraws``), so a test can hand
it the JAX package's, and the trainer's retry policy reads the same
object.  :func:`heavy_tail_speeds` is numpy in both packages and gives the
same bytes.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np

from repro_torch.core.rngtags import FAULT_FOLD, SPEED_SEED


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Per-round client fault rates + the latency model."""
    drop: float = 0.0           # P(uplink report lost after local compute)
    crash: float = 0.0          # P(client dies mid-round, nothing reported)
    delay: float = 0.0          # P(report arrives late)
    max_delay: int = 0          # late reports arrive U{1..max_delay} rounds late
    garble: float = 0.0         # P(delivered payload corrupted) — async only
    garble_scale: float = 4.0   # corrupted payloads scale by U(-s, s)
    speed_tail: float = 0.5     # lognormal sigma of client compute time
    stagger: float = 0.1        # Exp(stagger) dispatch jitter
    deadline: float = 0.0       # sync barrier timeout in round-units (0:
                                # wait forever); FedConfig.round_deadline

    @property
    def active(self) -> bool:
        """True iff a round under this config must draw fault streams."""
        return (self.drop > 0 or self.crash > 0
                or (self.delay > 0 and self.max_delay > 0)
                or self.garble > 0 or self.deadline > 0)


# named profiles selectable via FedConfig.fault_profile / --fault-profile;
# individual fault_* fields override a profile's numbers
FAULT_PROFILES = {
    "none": dict(),
    # a generally unreliable fleet: some of everything
    "flaky": dict(drop=0.08, crash=0.05, delay=0.15, max_delay=3,
                  garble=0.02, garble_scale=4.0, speed_tail=0.5),
    # the benchmark's 20%-stragglers arm: no losses, only lateness
    "stragglers": dict(delay=0.20, max_delay=4, speed_tail=1.0),
}

# (FedConfig field, FaultConfig field) pairs an explicit >= 0 value of
# which overrides the profile default
_OVERRIDES = (("fault_drop", "drop"), ("fault_crash", "crash"),
              ("fault_delay", "delay"), ("fault_max_delay", "max_delay"),
              ("fault_garble", "garble"),
              ("fault_garble_scale", "garble_scale"),
              ("fault_speed_tail", "speed_tail"))


def resolve_faults(fed) -> FaultConfig:
    """``FedConfig -> FaultConfig``: profile defaults + explicit ``fault_*``
    overrides (a negative override means "use the profile's value"), with
    the rate/shape validation of the JAX package."""
    profile = getattr(fed, "fault_profile", "none")
    if profile not in FAULT_PROFILES:
        raise ValueError(
            f"unknown fault_profile {profile!r}; known profiles: "
            f"{sorted(FAULT_PROFILES)} (rates are overridable per-field "
            "via the fault_* knobs)")
    kw = dict(FAULT_PROFILES[profile])
    for fed_field, fc_field in _OVERRIDES:
        v = getattr(fed, fed_field, -1)
        if v is not None and v >= 0:
            kw[fc_field] = int(v) if fc_field == "max_delay" else float(v)
    kw["deadline"] = float(getattr(fed, "round_deadline", 0.0))
    fc = FaultConfig(**kw)
    for rate_field in ("drop", "crash", "delay", "garble"):
        rate = getattr(fc, rate_field)
        if not 0.0 <= rate <= 1.0:
            raise ValueError(
                f"fault_{rate_field}={rate} must be in [0, 1]: it is a "
                "per-client per-round probability")
    if fc.delay > 0 and fc.max_delay < 1:
        raise ValueError(
            f"fault_delay={fc.delay} > 0 needs fault_max_delay >= 1 "
            "(late reports arrive 1..max_delay rounds late), got "
            f"{fc.max_delay}")
    if fc.garble_scale <= 0 or fc.speed_tail < 0 or fc.stagger < 0:
        raise ValueError(
            f"fault_garble_scale={fc.garble_scale} must be > 0, "
            f"fault_speed_tail={fc.speed_tail} must be >= 0, and the "
            f"dispatch stagger ({fc.stagger}; FaultConfig-only, not a "
            "FedConfig knob) must be >= 0")
    if fc.deadline < 0:
        raise ValueError(
            f"round_deadline={fc.deadline} must be >= 0 (simulated "
            "round-units the sync barrier waits before timing a client "
            "out; 0 waits forever)")
    return fc


class FaultStreams(NamedTuple):
    """One round's fault draws over the cohort, numpy arrays of shape
    ``(cohort,)``, with the JAX package's fields.  ``alive``: float 0/1,
    neither crashed nor dropped; ``latency``: completion time in
    round-units without the delay fault (add ``delay`` for arrival)."""
    alive: np.ndarray           # f32 0/1
    crashed: np.ndarray         # bool
    dropped: np.ndarray         # bool (uplink lost; excludes crashed)
    delayed: np.ndarray         # bool (among alive)
    delay: np.ndarray           # int32 rounds late (0 for on-time/dead)
    garbled: np.ndarray         # bool (among alive)
    garble_mult: np.ndarray     # f32 payload multiplier (1.0 unless garbled)
    latency: np.ndarray         # f32 completion time (round-units)


def fault_streams(seed: int, round_idx: int, cohort: int, fc: FaultConfig
                  ) -> FaultStreams:
    """Draw round ``round_idx``'s fault streams from the generator keyed by
    ``(seed, FAULT_FOLD, round_idx)``, each Bernoulli as ``uniform < p``
    (as ``jax.random.bernoulli``), in the JAX package's order."""
    rng = np.random.default_rng((seed, FAULT_FOLD, round_idx))
    crashed = rng.random(cohort) < fc.crash
    dropped = (rng.random(cohort) < fc.drop) & ~crashed
    alive_b = ~(crashed | dropped)
    delayed = (rng.random(cohort) < fc.delay) & alive_b
    late = rng.integers(1, max(fc.max_delay, 1) + 1, cohort)
    delay = np.where(delayed, late, 0).astype(np.int32)
    garbled = (rng.random(cohort) < fc.garble) & alive_b
    scale = rng.uniform(-fc.garble_scale, fc.garble_scale,
                        cohort).astype(np.float32)
    garble_mult = np.where(garbled, scale, np.float32(1.0))
    compute = np.exp(np.float32(fc.speed_tail)
                     * rng.standard_normal(cohort, dtype=np.float32))
    start = np.float32(fc.stagger) * rng.standard_exponential(
        cohort, dtype=np.float32)
    return FaultStreams(alive=alive_b.astype(np.float32), crashed=crashed,
                        dropped=dropped, delayed=delayed, delay=delay,
                        garbled=garbled, garble_mult=garble_mult,
                        latency=start + compute)


def timed_out(fs: FaultStreams, fc: FaultConfig) -> np.ndarray:
    """Bool (cohort,): reports that arrive past the round deadline (every
    client, the crashed and dropped included, as JAX counts them)."""
    return (fs.latency + fs.delay.astype(np.float32)) > np.float32(
        fc.deadline)


def client_failed_mask(fs: FaultStreams, fc: FaultConfig) -> np.ndarray:
    """Bool (cohort,): clients whose report the server never observes this
    round — crashed, dropped, or past the deadline."""
    failed = ~(fs.alive > 0)
    if fc.deadline > 0:
        failed = failed | timed_out(fs, fc)
    return failed


def heavy_tail_speeds(seed: int, num_clients: int,
                      sigma: float = 0.5) -> np.ndarray:
    """Persistent per-client relative speeds, lognormal with median 1:
    attach as ``FederatedData.client_speeds`` and ``sample_round`` ships
    the selected cohort's slice."""
    rng = np.random.default_rng((seed, SPEED_SEED))
    return np.exp(sigma * rng.standard_normal(num_clients)).astype(np.float32)
