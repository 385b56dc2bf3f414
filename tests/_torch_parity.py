"""Shared helpers of the PyTorch-port parity tests (``test_torch_*.py``).

Inputs are made once with numpy and handed to both packages; JAX runs on
the CPU as in the rest of the suite.  ``rel_err`` is the tolerance metric
the port's tests state: max |a - b| over max |b|, per array.  (The
element-wise form, dividing by |b| + 1e-6, is dominated by entries within
fp32 rounding of zero once a deep model sums in another order.)
"""
import numpy as np
import torch

# One intra-op thread in every port test process, set once at import (every
# ``test_torch_*.py`` file imports this module; so does the rank body of the
# spawned gloo jobs).  The test run puts several worker processes on the
# CPU's cores, and torch's default of one thread per core in each made them
# contend: six copies of one port file at once ran 4x slower than with one
# thread each, at the same results.  It also fixes the CPU's reductions to
# one order, which the port's bitwise comparisons within a process rely on.
torch.set_num_threads(1)

SMOKE = "smollm-360m-smoke"


def rel_err(a, b) -> float:
    a = np.asarray(a.detach().cpu() if isinstance(a, torch.Tensor) else a,
                   np.float64)
    b = np.asarray(b.detach().cpu() if isinstance(b, torch.Tensor) else b,
                   np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = np.max(np.abs(b)) if b.size else 0.0
    return float(np.max(np.abs(a - b)) / max(scale, 1e-30)) if b.size else 0.0


def max_tree_rel_err(port: dict, ref: dict) -> float:
    """Worst per-leaf ``rel_err`` between two flat dicts of arrays."""
    assert set(port) == set(ref), (sorted(port), sorted(ref))
    return max(rel_err(port[k], ref[k]) for k in ref)


def jax_params_to_torch(tree):
    import jax
    from repro_torch import bridge
    return bridge.to_torch(jax.tree.map(np.asarray, tree))


def routes_jax(fn):
    """Call ``fn`` with JAX's ``_route`` recording (expert_idx, keep) of
    every MoE layer, in layer order; returns (fn's result, records)."""
    import jax
    import repro.models.moe as JMOE
    recs, orig = [], JMOE._route

    def route(xg, p, cfg):
        out = orig(xg, p, cfg)
        jax.debug.callback(lambda e, k: recs.append(
            (np.asarray(e), np.asarray(k))), out[1], out[3], ordered=True)
        return out

    JMOE._route = route
    try:
        res = jax.block_until_ready(fn())
        jax.effects_barrier()
    finally:
        JMOE._route = orig
    return res, recs


def routes_port(fn, monkeypatch):
    """The same for the port's ``_route``."""
    from repro_torch.models import moe as TMOE
    recs, orig = [], TMOE._route

    def route(xg, p, cfg):
        out = orig(xg, p, cfg)
        recs.append((out[1].numpy().copy(), out[3].numpy().copy()))
        return out

    monkeypatch.setattr(TMOE, "_route", route)
    res = fn()
    monkeypatch.setattr(TMOE, "_route", orig)
    return res, recs


def assert_same_routing(jrecs, trecs):
    assert len(trecs) == len(jrecs) > 0
    for i, ((je, jk), (te, tk)) in enumerate(zip(jrecs, trecs)):
        flips = int((te != je).sum())
        assert flips == 0, f"layer {i}: {flips} routing decisions differ"
        assert np.array_equal(tk, jk), f"layer {i}: kept entries differ"


def jax_dropout_masks(key, widths, batch, rate):
    """The keep masks JAX's ``cnn_apply`` draws from ``key`` for the hidden
    fc layers of ``widths`` at batch ``batch``: one split per layer, then
    ``bernoulli(sub, 1 - rate, (batch, width))``."""
    import jax
    out = []
    for w in widths:
        key, sub = jax.random.split(key)
        out.append(np.array(jax.random.bernoulli(sub, 1 - rate,
                                                 (batch, w))))
    return out


def jax_round_dropout(round_key, *, widths, rate, cohort, n_steps,
                      step_batch, eval_batch, meta_batch):
    """A round's masks as JAX's key chain draws them, as an
    ``InjectedDropout``: the round key splits into client and meta keys,
    the client key into ``cohort`` rows, each row folds in its local step
    (or ``EVAL_FOLD``), and the meta step draws from the meta key."""
    import jax
    from repro.core.rngtags import EVAL_FOLD
    from repro_torch.core.dropout import InjectedDropout
    rng_c, rng_m = jax.random.split(round_key)
    cks = jax.random.split(rng_c, cohort)
    steps = [[[None] * n_steps for _ in range(cohort)] for _ in widths]
    evals = [[None] * cohort for _ in widths]
    for k in range(cohort):
        for i in range(n_steps):
            ms = jax_dropout_masks(jax.random.fold_in(cks[k], i), widths,
                                   step_batch, rate)
            for l, m in enumerate(ms):
                steps[l][k][i] = m
        ms = jax_dropout_masks(jax.random.fold_in(cks[k], EVAL_FOLD),
                               widths, eval_batch, rate)
        for l, m in enumerate(ms):
            evals[l][k] = m
    meta = (None if meta_batch is None
            else jax_dropout_masks(rng_m, widths, meta_batch, rate))
    return InjectedDropout([np.asarray(s) for s in steps],
                           [np.asarray(e) for e in evals], meta)
