"""The dry run's scan-cohort shortcut (``repro_torch.launch.dryrun``):
a train pair on the scan strategy traced at cohorts 1 and 2, each count
at cohort C taken as ``c1 + (C - 1) (c2 - c1)``.

At smoke width on fake tensors (a ``cuda`` trace: the kernels charge
their declared costs), for smollm-360m-smoke at train_4k's shape and
jamba-1.5-large-398b-smoke (the hybrid stack: mamba chunk loops, MoE
routing, attention) at a 64-token sequence: the extrapolated cost at
cohort 4 equals the full trace at cohort 4, FLOPs and bytes to 1e-9
relative, launches, op counts and every memory size exactly.  Then
``run_one`` marks the records the shortcut made, and ``--no-extrapolate``
traces the cohort whole."""
import dataclasses

import pytest

import _torch_parity  # noqa: F401  (one torch thread)
from repro_torch.configs import get_arch, get_shape
from repro_torch.launch.dryrun import (extrapolate_cost, fed_for, run_one,
                                       train_cost)

REL = 1e-9


def _close(a, b):
    return abs(a - b) <= REL * max(abs(b), 1.0)


@pytest.mark.parametrize("arch,seq", [("smollm-360m-smoke", None),
                                      ("jamba-1.5-large-398b-smoke", 64)])
def test_shortcut_equals_the_full_trace_at_cohort_4(arch, seq):
    cfg = get_arch(arch)
    shape = get_shape("train_4k")
    if seq is not None:
        shape = dataclasses.replace(shape, seq_len=seq)
    fed = dataclasses.replace(fed_for(cfg, 1, strategy="scan"), cohort=4)
    per_client = shape.global_batch // 4
    c1, c2, c4 = (train_cost(cfg, shape, dataclasses.replace(fed, cohort=c),
                             per_client=per_client) for c in (1, 2, 4))
    got = extrapolate_cost(c1, c2, 4)
    for k in ("flops", "tc_flops", "bytes_read", "bytes_written",
              "collective_bytes"):
        assert _close(getattr(got, k), getattr(c4, k)), k
    assert got.launches == c4.launches
    # one pass a client for each of the model's two flat dtype groups at
    # bf16 (the bf16 leaves, the fp32 norms)
    assert c4.launches["accumulate_pass"] == 4 * 2
    assert got.n_ops == c4.n_ops
    assert got.memory == c4.memory
    # the per-client work is there to extrapolate: cohort 2 is not 1
    assert c2.flops > c1.flops and c2.memory != c1.memory


def test_run_one_marks_the_shortcut_and_can_trace_whole(monkeypatch):
    """``run_one`` on a scan pair (its cohort cut to 4 here, to keep the
    whole trace short) takes the shortcut and marks the record;
    ``extrapolate=False`` traces the cohort whole, to the same counts."""
    import repro_torch.launch.dryrun as D
    real = D.fed_for
    monkeypatch.setattr(D, "fed_for", lambda *a, **kw: dataclasses.replace(
        real(*a, **kw), cohort=4))
    short = run_one("smollm-360m-smoke", "train_4k", strategy="scan",
                    verbose=False)
    whole = run_one("smollm-360m-smoke", "train_4k", strategy="scan",
                    extrapolate=False, verbose=False)
    assert short["cohort"] == whole["cohort"] == 4
    assert short["extrapolated"] == {"from_cohorts": [1, 2],
                                     "rule": "c1 + (cohort - 1) * (c2 - c1)"}
    assert whole["extrapolated"] is False
    assert short["launches"] == whole["launches"] == {   # two dtype groups
        "accumulate_pass": 4 * 2, "update_pass": 2}
    assert short["memory"] == whole["memory"]
    for k in ("flops", "bytes accessed", "aten ops"):
        assert _close(short["cost"][k], whole["cost"][k]), k
    # a vmap pair and a serving pair are traced whole
    assert run_one("smollm-360m-smoke", "train_4k",
                   verbose=False)["extrapolated"] is False
    assert run_one("smollm-360m-smoke", "decode_32k",
                   verbose=False)["extrapolated"] is False
