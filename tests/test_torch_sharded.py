"""The two-tier sharded executor (``--executor sharded``) over
``torch.distributed``, on the CPU with gloo, and the sequence-parallel
flash decode.

Two jobs are spawned, launched as ``torchrun`` launches them (the rank
body is ``tests/_torch_sharded_worker.py``, which imports no JAX): a
world of two and a world of one.  Each rank runs 2 chained rounds of a
small MLP at cohort 5, chunk 3, in post, ``through_aggregation`` and int8
+ error feedback, and rank 0 runs the single-process chunked round on the
same inputs.

Tolerances, max |a-b| over max |b|:

  * two ranks against the chunked round 1e-6: each rank's partial
    accumulators hold the same client gradients (a rank vmaps its three
    slots as the chunked core vmaps its chunks of three), and tier 2 sums
    the two partials, which reassociates the sum; int8 residuals 1e-6 of
    the encoded gradient's size (a cancellation, as in
    ``test_torch_comm_round.py``);
  * a world of one against the chunked round bitwise, and the two ranks'
    states bitwise each other's (the state is replicated);
  * ``sharded_flash_decode`` over two cache shards against JAX's
    ``decode_attention`` 1e-5, as the JAX suite's shard_map test holds it.
"""
import socket

import numpy as np
import pytest
import torch

import _torch_sharded_worker as W
from _torch_parity import rel_err
from repro_torch.core.flat import make_flat_spec
from repro_torch.sharding.specs import (Mesh, axis_size, batch_axes,
                                        cohort_split, flat_group_pspecs)

TOL_TWO_TIER = 1e-6


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(world, out_dir):
    torch.multiprocessing.spawn(W.main, args=(world, _free_port(),
                                              str(out_dir)), nprocs=world)
    return [torch.load(out_dir / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    return _spawn(2, tmp_path_factory.mktemp("two_ranks"))


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    return _spawn(1, tmp_path_factory.mktemp("one_rank"))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _leaves(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (tuple, list)):
        return [x for i, t in enumerate(tree)
                for x in _leaves(t, f"{prefix}/{i}")]
    return [(prefix, np.asarray(tree))]


def _compare(a, b, tol):
    """Max error of states and histories a against b (0 where bitwise)."""
    (sa, ha), (sb, hb) = a, b
    la, lb = _leaves(sa), _leaves(sb)
    assert [n for n, _ in la] == [n for n, _ in lb]
    for (n, x), (_, y) in zip(la, lb):
        e = rel_err(x, y)
        if n.startswith("/comm/residual"):
            e /= 254                 # the encoded gradient's size
        assert e <= tol, (n, e)
    assert [sorted(m) for m in ha] == [sorted(m) for m in hb]
    for ma, mb in zip(ha, hb):
        for k in ma:
            assert rel_err(np.float32(ma[k]), np.float32(mb[k])) <= tol, \
                (k, ma[k], mb[k])


@pytest.mark.parametrize("case", list(W.CASES))
def test_two_tier_matches_chunked(two_ranks, case):
    rank0, rank1 = two_ranks
    assert rank0["mesh"] == ({"data": 2, "model": 1},
                             {"data": 0, "model": 0})
    assert rank1["mesh"][1] == {"data": 1, "model": 0}
    _compare(rank0[f"sharded:{case}"], rank0[f"chunked:{case}"],
             TOL_TWO_TIER)
    _compare(rank1[f"sharded:{case}"], rank0[f"sharded:{case}"], 0.0)


@pytest.mark.parametrize("case", list(W.CASES))
def test_world_of_one_is_chunked_bitwise(one_rank, case):
    (rank0,) = one_rank
    assert rank0["mesh"][0] == {"data": 1, "model": 1}
    _compare(rank0[f"sharded:{case}"], rank0[f"chunked:{case}"], 0.0)


def test_sharded_flash_decode_matches_jax(two_ranks, one_rank):
    import jax.numpy as jnp
    from repro.models.attention import decode_attention
    q, k, v = W.decode_inputs()
    ref = np.asarray(decode_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v),
                                      jnp.asarray(W.DECODE["index"])))
    for res in two_ranks + one_rank:
        assert rel_err(res["decode"], ref) <= 1e-5


def test_model_axis_raises_naming_item_7b(two_ranks):
    """What still refuses a model axis above 1 names item 7c: a model that
    is not a transformer config (the MLP in the ranks) and, from the CLI
    before any process group starts, the through_aggregation meta mode."""
    for res in two_ranks:
        assert "ROADMAP Queue 1 item 7c" in res["model_axis"]
    from repro_torch.launch.train import main
    with pytest.raises(NotImplementedError, match="item 7c"):
        main(["--arch", "smollm-360m-smoke", "--fused", "--rounds", "1",
              "--cohort", "2", "--client-batch", "4", "--seq", "8",
              "--device", "cpu", "--executor", "sharded",
              "--mesh-model", "2", "--meta-mode", "through_aggregation"])


def _mesh(data, model, d, m):
    return Mesh(("data", "model"), {"data": data, "model": model},
                {"data": d, "model": m}, {}, torch.device("cpu"))


def test_mesh_splits():
    """The cohort split pads to a multiple of the data axis; ranks are
    row-major; the flat rows split over the model axis where it divides
    them, and stay whole where it does not."""
    mesh = _mesh(2, 3, 1, 2)
    assert batch_axes(mesh) == ("data",)
    assert axis_size(mesh, "data") == 2 and axis_size(mesh, None) == 1
    assert axis_size(mesh, ("data", "model")) == 6 == mesh.size
    assert mesh.rank == 5 and mesh.rank_of(data=0) == 2
    assert cohort_split(5, mesh) == (3, 6)
    assert cohort_split(10, _mesh(4, 1, 0, 0)) == (3, 12)
    assert cohort_split(4, _mesh(1, 1, 0, 0)) == (4, 4)
    spec = make_flat_spec({"a": torch.zeros(24 * 128)})
    assert flat_group_pspecs(spec, mesh) == (slice(16, 24),)
    assert flat_group_pspecs(spec, _mesh(1, 1, 0, 0)) == (slice(0, 24),)
    assert flat_group_pspecs(spec, _mesh(1, 5, 0, 4)) == (slice(0, 24),)
