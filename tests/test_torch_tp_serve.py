"""Serving over the model axis: the prefill and the decode step on each
rank's shards of a (1, 2) mesh (two gloo processes on the CPU), with the
decode cache placed as ``sharding/specs.py::cache_shardings`` places it
(all heads at the rank's positions; the SSM state of the rank's heads,
the conv state of its channels), against JAX's ``model.prefill`` and
greedy decode on the same parameters (the bridge) and against the port's
world of one fed JAX's tokens, for four smoke configs: smollm (3 / 1
heads, which 2 does not divide: q/k/v gathered whole, the KV split by
sequence), deepseek (MLA on each rank's 2 of 4 heads, the experts
split), mamba2 (the SSD scan on each rank's 4 of 8 heads) and whisper
(the encoder and the cross layers, each rank's 2 of 4 heads; the
encoder's 64 keys split 32 a rank).

A prompt of 8 into a cache of 20 (10 slots a rank), then 4 greedy decode
steps at positions 8 to 11: the first two slots in rank 0's half, the
last two in rank 1's.  Tolerance 1e-5, max |a-b| over max |b|, on the
prefill logits, each rank's cache (after the prefill, and after the last
step against the world of one's), each step's logits; the greedy tokens
equal to JAX's.
"""
import numpy as np
import pytest

import _torch_tp_serve_parity as SP
from _torch_parity import rel_err

ARCHS = ["smollm-360m-smoke", "deepseek-v2-lite-16b-smoke",
         "mamba2-780m-smoke", "whisper-large-v3-smoke"]
MESH = (1, 2)
B, PROMPT, CACHE, STEPS = 2, 8, 20, 4
TOL = 1e-5


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    reqs = {n: SP.request(n, 11 + i, batch=B, prompt=PROMPT,
                          cache_len=CACHE, steps=STEPS)
            for i, n in enumerate(ARCHS)}
    job = SP.start(MESH, [SP.serve_job(n, r) for n, r in reqs.items()],
                   tmp_path_factory.mktemp("tp_serve"))
    out = {}
    for n, r in reqs.items():
        jax_out = SP.jax_serve(r)
        out[n] = dict(jax=jax_out, one=SP.port_serve(r, jax_out["fed"]))
    ranks = SP.join(job)
    for n in ARCHS:
        out[n]["ranks"] = [(res["coords"], res[n]) for res in ranks]
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_match_jax_and_the_world_of_one(served, arch):
    s = served[arch]
    for _, r in s["ranks"]:
        assert rel_err(r["prefill"], s["jax"]["prefill"]) <= TOL
        assert rel_err(r["prefill"], s["one"]["prefill"]) <= TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_each_rank_holds_its_part_of_the_cache(served, arch):
    """After the prefill, each rank's cache is its part of JAX's and of
    the world of one's; after the last step, of the world of one's."""
    s = served[arch]
    for coords, r in s["ranks"]:
        rows = slice(*r["rows"])
        got = SP.leaves({k: v for k, v in r["cache"].items()
                         if k != "index"})
        for ref in (s["jax"]["cache"], s["one"]["cache"]):
            want = SP.leaves(SP.rank_part(ref, coords, MESH, rows))
            assert [p for p, _ in got] == [p for p, _ in want]
            for (path, a), (_, b) in zip(got, want):
                assert tuple(a.shape) == b.shape, (path, a.shape, b.shape)
                assert rel_err(a, b) <= TOL, path
        end = SP.leaves(r["cache_end"]["layers"])
        want = SP.leaves(SP.rank_part(s["one"]["cache_end"], coords, MESH,
                                      rows)["layers"])
        for (path, a), (_, b) in zip(end, want):
            assert rel_err(a, b) <= TOL, path
        assert int(r["cache_end"]["index"]) == PROMPT + STEPS


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_across_both_halves_of_the_cache(served, arch):
    """Steps at positions 8-11: slots 8 and 9 in rank 0's half, 10 and
    11 in rank 1's; every step's logits, whole on both ranks."""
    s = served[arch]
    for _, r in s["ranks"]:
        assert len(r["steps"]) == STEPS
        for i, logits in enumerate(r["steps"]):
            assert rel_err(logits, s["one"]["steps"][i]) <= TOL, i
            assert rel_err(logits, s["jax"]["steps"][i]) <= TOL, i


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_equal_jax(served, arch):
    s = served[arch]
    for _, r in s["ranks"]:
        fed = np.stack([t.numpy() for t in r["fed"]], 1)
        assert np.array_equal(fed, s["jax"]["fed"])
        last = np.argmax(r["steps"][-1].numpy(), -1)
        assert np.array_equal(last, np.argmax(s["jax"]["steps"][-1], -1))
