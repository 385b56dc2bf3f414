"""The decode step against a cache split along its sequence over
processes (gloo on the CPU), beside ``test_torch_tp_serve.py``'s (1, 2)
serving:

  * the empty shard: a token whose valid positions all lie in rank 0's
    half, so rank 1's partials hold no valid slot (its m is the mask
    value); the merge must weight them by exactly 0, no NaN;
  * B = 1 on a (2, 1) mesh: ``cache_shardings`` puts the sequence over
    ``data``, which the merge then runs over;
  * the sliding-window ring on the same mesh: window 16, the slot
    ``index % 16``, 12 steps from a prompt of 8, so the ring wraps;
  * a (2, 2) mesh: the batch over ``data``, the sequence over ``model``;
  * MLA's absorbed partial (``mla_decode_partial``) over one shard and
    over two merged, against ``mla_decode_absorbed`` (the port's and
    JAX's).

Each serving case against JAX's greedy serving on the same parameters and
the port's world of one fed JAX's tokens; tolerance 1e-5, max |a-b| over
max |b|.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_tp_serve_parity as SP
from _torch_parity import rel_err
from repro.models import attention as JA
from repro_torch.models import attention as TA

SMOKE = "smollm-360m-smoke"
TOL = 1e-5
# (tag, mesh, batch, prompt, cache, steps, window)
CASES = {
    "b1": ((2, 1), 1, 8, 20, 4, 0),
    "ring": ((2, 1), 1, 8, 16, 12, 16),
    "2x2": ((2, 2), 2, 8, 20, 4, 0),
}


def _partials_job():
    rng = np.random.default_rng(5)
    B, H, Hkv, S, D = 2, 4, 2, 16, 8
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((B, H, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    return dict(kind="partials", tag="partials", q=q, k=k, v=v,
                index=torch.tensor(3))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    reqs = {tag: SP.request(SMOKE, 21 + i, batch=b, prompt=p, cache_len=c,
                            steps=n, window=w)
            for i, (tag, (_, b, p, c, n, w)) in enumerate(CASES.items())}
    part = _partials_job()
    jobs = {
        (2, 1): SP.start((2, 1), [SP.serve_job(t, reqs[t])
                                  for t in ("b1", "ring")],
                         tmp_path_factory.mktemp("seq21")),
        (2, 2): SP.start((2, 2), [SP.serve_job("2x2", reqs["2x2"]), part],
                         tmp_path_factory.mktemp("seq22")),
    }
    out = {"partials": part}
    for tag, r in reqs.items():
        jax_out = SP.jax_serve(r)
        out[tag] = dict(jax=jax_out, one=SP.port_serve(r, jax_out["fed"]))
    ranks = {m: SP.join(j) for m, j in jobs.items()}
    for tag, (mesh, *_) in CASES.items():
        out[tag]["ranks"] = [(res["coords"], res[tag])
                             for res in ranks[mesh]]
    out["partials"]["ranks"] = [res["partials"] for res in ranks[(2, 2)]]
    return out


def test_empty_shard_merges_with_weight_zero(worlds):
    p = worlds["partials"]
    ref = np.asarray(JA.decode_attention(
        jnp.asarray(p["q"].numpy()), jnp.asarray(p["k"].numpy()),
        jnp.asarray(p["v"].numpy()), jnp.asarray(3)))
    for r in p["ranks"]:
        assert r["placement"][2] == "model" and r["local"] == 8
        assert torch.isfinite(r["out"]).all()
        assert rel_err(r["out"], ref) <= TOL
        assert rel_err(r["out"], TA.decode_attention(
            p["q"], p["k"], p["v"], torch.tensor(3))) <= TOL


@pytest.mark.parametrize("tag", list(CASES))
def test_serving_on_a_split_sequence(worlds, tag):
    """Prefill logits, each rank's cache (its part of JAX's after the
    prefill, of the world of one's after the last step), each step's
    logits and the greedy tokens."""
    mesh = CASES[tag][0]
    s = worlds[tag]
    for coords, r in s["ranks"]:
        rows = slice(*r["rows"])
        assert rel_err(r["prefill"], s["jax"]["prefill"][rows]) <= TOL
        assert rel_err(r["prefill"], s["one"]["prefill"][rows]) <= TOL
        got = SP.leaves(r["cache"]["layers"])
        want = SP.leaves(SP.rank_part(s["jax"]["cache"], coords, mesh,
                                      rows)["layers"])
        for (path, a), (_, b) in zip(got, want):
            assert tuple(a.shape) == b.shape, (path, a.shape, b.shape)
            assert rel_err(a, b) <= TOL, path
        end = SP.leaves(r["cache_end"]["layers"])
        want = SP.leaves(SP.rank_part(s["one"]["cache_end"], coords, mesh,
                                      rows)["layers"])
        for (path, a), (_, b) in zip(end, want):
            assert rel_err(a, b) <= TOL, path
        for i, logits in enumerate(r["steps"]):
            assert rel_err(logits, s["jax"]["steps"][i][rows]) <= TOL, i
            assert rel_err(logits, s["one"]["steps"][i][rows]) <= TOL, i
        fed = np.stack([t.numpy() for t in r["fed"]], 1)
        assert np.array_equal(fed, s["jax"]["fed"][rows])


def test_the_sequence_goes_over_data_at_batch_one(worlds):
    """B = 1: each data rank holds half the positions (10 and 8 slots a
    rank), every head; the model axis is 1."""
    for tag, half in (("b1", 10), ("ring", 8)):
        for coords, r in worlds[tag]["ranks"]:
            k = r["cache"]["layers"][0]["k"]
            assert k.shape[1:3] == (1, half), (tag, k.shape)


def test_the_ring_wraps(worlds):
    """12 steps from position 8 into a ring of 16: positions 16-19 went
    to slots 0-3, in rank 0's half; the fed tokens are JAX's."""
    s = worlds["ring"]
    assert len(s["ranks"][0][1]["steps"]) == 12
    r0 = next(r for c, r in s["ranks"] if c["data"] == 0)
    end, pre = r0["cache_end"]["layers"][0]["k"], r0["cache"]["layers"][0][
        "k"]
    assert not torch.equal(end[:, :, :4], pre[:, :, :4])


def test_mla_partial_matches_the_absorbed_decode():
    """``mla_decode_partial`` over the whole cache (one shard), and over
    two halves merged as ``combine_partials`` merges them, through
    ``w_uv`` and ``wo``, against ``mla_decode_absorbed``: the port's and
    JAX's."""
    rng = np.random.default_rng(9)
    B, S, d, H, hd, rd, r = 2, 12, 32, 4, 8, 4, 16
    theta, index = 10000.0, 5
    f = lambda *s: rng.standard_normal(s).astype(np.float32) / math.sqrt(
        s[0] if len(s) > 1 else 1)
    p = {"w_dkv": f(d, r), "w_kr": f(d, rd), "w_uk": f(r, H, hd),
         "w_uv": f(r, H, hd), "wq": f(d, H * (hd + rd)), "wo": f(H * hd, d)}
    x = rng.standard_normal((B, d)).astype(np.float32)
    ckv = rng.standard_normal((B, S, r)).astype(np.float32)
    krope = rng.standard_normal((B, S, rd)).astype(np.float32)
    ckv[:, index:], krope[:, index:] = 0, 0
    jy, _, _ = JA.mla_decode_absorbed(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()},
        jnp.asarray(ckv), jnp.asarray(krope), jnp.asarray(index),
        num_heads=H, head_dim=hd, rope_head_dim=rd, rope_theta=theta)
    tp_ = {k: torch.from_numpy(v) for k, v in p.items()}
    tc, tk = torch.from_numpy(ckv.copy()), torch.from_numpy(krope.copy())
    ty = TA.mla_decode_absorbed(torch.from_numpy(x), tp_, tc, tk,
                                torch.tensor(index), num_heads=H,
                                head_dim=hd, rope_head_dim=rd,
                                rope_theta=theta)
    assert rel_err(ty, np.asarray(jy)) <= TOL
    # the query through w_uk, as the sharded decode forms it
    from repro_torch.models.layers import apply_rope
    xt = torch.from_numpy(x)
    pos = torch.full((B, 1), index)
    q = (xt @ tp_["wq"]).reshape(B, H, hd + rd)
    q_rope = apply_rope(q[:, None, :, hd:], pos, theta)[:, 0]
    q_lat = torch.einsum("bhd,rhd->bhr", q[..., :hd], tp_["w_uk"])

    def finish(o_lat):
        o = torch.einsum("bhr,rhd->bhd", o_lat, tp_["w_uv"])
        return o.reshape(B, -1) @ tp_["wo"]
    m, l, o = TA.mla_decode_partial(q_lat, q_rope, tc, tk, index, 0, hd, rd)
    assert rel_err(finish(o / l[..., None]), np.asarray(jy)) <= TOL
    parts = [TA.mla_decode_partial(q_lat, q_rope, tc[:, a:a + S // 2],
                                   tk[:, a:a + S // 2], index, a, hd, rd)
             for a in (0, S // 2)]        # the second half: no valid slot
    mg = torch.maximum(parts[0][0], parts[1][0])
    corr = [torch.exp(pm - mg) for pm, _, _ in parts]
    assert float(corr[1].abs().max()) == 0.0
    lg = sum(pl * c for (_, pl, _), c in zip(parts, corr))
    og = sum(po * c[..., None] for (_, _, po), c in zip(parts, corr))
    assert rel_err(finish(og / lg[..., None]), np.asarray(jy)) <= TOL
