"""MoE capacity groups in the batch's token order when serving splits the
batch over ``data``: a (2, 1) mesh, two gloo processes on the CPU, each
holding one of the two rows of a batch of 2 x 7 tokens.  With
``group_size`` 6 the batch's 14 tokens make JAX's groups [0, 6), [6, 12)
and [12, 14) plus 4 pad rows: rank 0's tokens 0-6 and rank 1's 7-13 both
touch the middle group, whose capacity slots count the entries of both
ranks' tokens.  Per-rank groups would be [0, 6) and [6, 7) plus 5 pad
rows on each rank, another routing (the test asserts that they differ,
so the case can see the fault).

deepseek-v2-lite-16b-smoke (MLA, 4 experts top-2 with a shared one):

  * each rank's kept/dropped mask and experts, bitwise JAX's ``_route`` of
    the whole batch's groups at its rows;
  * one MoE FFN on each rank's rows, both dispatch forms, against JAX's
    ``moe_ffn`` of the whole batch (1e-5), and the aux loss over JAX's
    groups (1e-6: a mean of sums taken in another order);
  * the prefill (logits, each rank's part of the cache) against JAX's
    prefill of the whole batch at the port's usual 1e-5, max |a-b| over
    max |b|.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_tp_serve_parity as SP
from _torch_parity import rel_err
import repro.models.moe as JMOE
from repro_torch.configs.base import MoEConfig
from repro_torch.models import moe as TMOE

ARCH = "deepseek-v2-lite-16b-smoke"
MESH = (2, 1)
B, PROMPT, CACHE, GROUP = 2, 7, 12, 6
TOL = 1e-5
AUX_TOL = 1e-6


def _small_groups(cfg):
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, group_size=GROUP))


def _moe_case(seed=3):
    """One MoE layer's tree and tokens, made with numpy."""
    rng = np.random.default_rng(seed)
    E, K, d, de = 4, 2, 16, 8
    f = lambda *s: (rng.standard_normal(s) / np.sqrt(s[-2])).astype(
        np.float32)
    p = {"router": f(d, E), "w_gate": f(E, d, de), "w_up": f(E, d, de),
         "w_down": f(E, de, d),
         "shared": {"w_gate": f(d, de), "w_up": f(d, de), "w_down": f(de, d)}}
    x = rng.standard_normal((B, PROMPT, d)).astype(np.float32)
    kw = dict(num_experts=E, top_k=K, num_shared=1, d_expert=de,
              group_size=GROUP)
    return p, x, kw


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    req = SP.request(ARCH, 31, batch=B, prompt=PROMPT, cache_len=CACHE,
                     steps=1, change=_small_groups)
    p, x, kw = _moe_case()
    tp_ = lambda t: jax.tree.map(torch.from_numpy, t)
    moe_job = dict(kind="moe", tag="moe", cfg=MoEConfig(**kw), p=tp_(p),
                   x=torch.from_numpy(x))
    job = SP.start(MESH, [SP.serve_job("serve", req), moe_job],
                   tmp_path_factory.mktemp("moe_groups"))
    jcfg = JMOE.MoEConfig(**kw)
    jp = jax.tree.map(jnp.asarray, p)
    xg, T, _ = JMOE._group(jnp.asarray(x), jcfg)
    route = JMOE._route(xg, jp, jcfg)
    jax_moe = {
        "expert_idx": np.asarray(route[1]).reshape(-1, kw["top_k"])[:T],
        "keep": np.asarray(route[3]).reshape(-1, kw["top_k"])[:T]}
    for impl in ("gather", "einsum"):
        fn = JMOE.moe_ffn_gather if impl == "gather" else JMOE.moe_ffn_einsum
        y, aux = fn(jnp.asarray(x), jp, jcfg)
        jax_moe[impl] = (np.asarray(y), float(aux))
    out = {"jax": SP.jax_serve(req), "jax_moe": jax_moe, "x": x, "p": p,
           "kw": kw}
    out["ranks"] = [(res["coords"], res) for res in SP.join(job)]
    return out


def test_per_rank_groups_would_route_otherwise(served):
    """The case's fault is visible: grouping each rank's rows alone keeps
    or drops other entries than JAX's groups of the whole batch."""
    kw, x = served["kw"], served["x"]
    p = jax.tree.map(torch.from_numpy, served["p"])
    cfg = MoEConfig(**kw)
    differ = False
    for r in range(MESH[0]):
        xg, T, _ = TMOE._group(torch.from_numpy(x[r:r + 1]), cfg)
        keep = TMOE._route(xg, p, cfg)[3].reshape(-1, cfg.top_k)[:T]
        want = served["jax_moe"]["keep"][r * PROMPT:(r + 1) * PROMPT]
        differ |= not np.array_equal(keep.numpy(), want)
    assert differ


def test_kept_mask_equals_jax_bitwise(served):
    jm = served["jax_moe"]
    for _, res in served["ranks"]:
        r0, r1 = res["moe"]["rows"]
        toks = slice(r0 * PROMPT, r1 * PROMPT)
        assert np.array_equal(res["moe"]["keep"].numpy(), jm["keep"][toks])
        assert np.array_equal(res["moe"]["expert_idx"].numpy(),
                              jm["expert_idx"][toks])
    # the middle group straddles the ranks and drops entries there
    assert not jm["keep"].all()


@pytest.mark.parametrize("impl", ["gather", "einsum"])
def test_moe_ffn_on_each_rank_matches_jax(served, impl):
    y_ref, aux_ref = served["jax_moe"][impl]
    for _, res in served["ranks"]:
        r0, r1 = res["moe"]["rows"]
        y, aux = res["moe"][impl]
        assert rel_err(y, y_ref[r0:r1]) <= TOL
        assert abs(float(aux) - aux_ref) <= AUX_TOL * abs(aux_ref)


def test_prefill_matches_jax_of_the_whole_batch(served):
    jax_out = served["jax"]
    for coords, res in served["ranks"]:
        r = res["serve"]
        rows = slice(*r["rows"])
        assert rel_err(r["prefill"], jax_out["prefill"][rows]) <= TOL
        got = SP.leaves({k: v for k, v in r["cache"].items()
                         if k != "index"})
        want = SP.leaves(SP.rank_part(jax_out["cache"], coords, MESH, rows))
        assert [p for p, _ in got] == [p for p, _ in want]
        for (path, a), (_, b) in zip(got, want):
            assert tuple(a.shape) == b.shape, (path, a.shape, b.shape)
            assert rel_err(a, b) <= TOL, path
