"""Live roofline attribution: the cost model on the round a trainer runs
(PyTorch port of ``repro/roofline/live.py``).

  * :func:`round_cost_summary` — the counterpart of
    ``compiled_cost_summary``: everything one trace of a call yields
    (:func:`repro_torch.roofline.cost.trace_cost`): FLOPs, bytes,
    collectives, kernel launches and ``memory_analysis``-style sizes.
  * :func:`round_roofline_event` — one ``roofline`` tracker-event payload
    per round function: per-round FLOPs, bytes and collective bytes, the
    predicted compute, memory and collective seconds and rounds/s under
    the H100 SXM hardware model (:mod:`repro_torch.roofline.analysis`).
    The trainer adds the measured rounds/s of its dispatch + device-sync
    spans, so prediction and measurement share a ``metrics.jsonl`` line
    (``repro_torch.obs.schema.ROOFLINE_EVENT_KEYS``).

Eager dispatch runs every iteration of every loop, so the trace has no
undercount of while bodies to correct: ``loop_ratio`` is 1.0 and
``xla_flops`` equals ``flops``.  The trace runs on the trainer's device:
fake ``cuda`` on the card, where each hand-written kernel charges its
declared cost; on the CPU it traces the kernels' plain versions, which
are what a CPU run executes.
"""
from __future__ import annotations

import time
from typing import Any, Dict, Optional

from repro_torch.roofline.analysis import roofline_terms
from repro_torch.roofline.cost import trace_cost

__all__ = ["round_cost_summary", "roofline_event", "round_roofline_event"]


def round_cost_summary(fn, args, *, device) -> Dict[str, Any]:
    """Cost-model summary of one call of ``fn(*args)``, traced on fake
    stand-ins on ``device``."""
    c, _ = trace_cost(fn, args, device=device)
    return {
        "flops": c.flops,
        "tc_flops": c.tc_flops,
        "bf16_flops": c.bf16_flops,
        "bytes_read": c.bytes_read,
        "bytes_written": c.bytes_written,
        "bytes": c.bytes,
        "collective_bytes": c.collective_bytes,
        "per_collective": dict(c.per_collective),
        "launches": dict(c.launches),
        "n_ops": c.n_ops,
        "loop_ratio": 1.0,
        "memory": dict(c.memory),
        "trace_s": c.trace_s,
    }


def roofline_event(s: Dict[str, Any], *, rounds_per_call: int,
                   analysis_s: float) -> Dict[str, Any]:
    """The ``roofline`` event payload of a K-round call's summary
    (:func:`round_cost_summary`): per-round costs and terms."""
    rl = roofline_terms(s["flops"], s["bytes"], s["collective_bytes"],
                        tc_flops_per_chip=s["tc_flops"],
                        bf16_flops_per_chip=s.get("bf16_flops", 0.0))
    k = max(int(rounds_per_call), 1)
    t_round = max(rl.compute_s, rl.memory_s, rl.collective_s) / k
    return {
        "rounds_per_call": k,
        "flops_per_round": s["flops"] / k,
        "bytes_per_round": s["bytes"] / k,
        "collective_bytes_per_round": s["collective_bytes"] / k,
        "per_collective": s["per_collective"],
        "compute_s_per_round": rl.compute_s / k,
        "memory_s_per_round": rl.memory_s / k,
        "collective_s_per_round": rl.collective_s / k,
        "bottleneck": rl.bottleneck,
        "predicted_rounds_per_s": (1.0 / t_round) if t_round > 0 else 0.0,
        "loop_ratio": s["loop_ratio"],
        "xla_flops": s["flops"],
        "memory": s["memory"],
        "analysis_s": round(analysis_s, 4),
    }


def round_roofline_event(fn, args, *, rounds_per_call: int = 1, device
                         ) -> Optional[Dict[str, Any]]:
    """Trace ``fn(*args)`` (a K-round call) and derive the per-round
    ``roofline`` event payload.  Returns None for a sanitized round
    (``fn.sanitized``): its probes' counts are read on the host, which a
    trace cannot do, as the JAX package skips its checkify closure."""
    if getattr(fn, "sanitized", False):
        return None
    t0 = time.perf_counter()
    s = round_cost_summary(fn, args, device=device)
    return roofline_event(s, rounds_per_call=rounds_per_call,
                          analysis_s=time.perf_counter() - t0)
