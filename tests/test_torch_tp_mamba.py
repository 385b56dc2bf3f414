"""Tensor-parallel client compute over the mesh's model axis on the Mamba2
mixer and the hybrid period, on the CPU with gloo.

One job is spawned, launched as ``torchrun`` launches it (the rank body
is ``tests/_torch_tp_layers_worker.py``, which imports no JAX): a world
of two on a (1, 2) mesh running mamba2-780m-smoke (8 heads: the mixer on
4 a process; ``in_proj``'s columns and ``conv_w``'s channels split
inside the x segment, so the projection and the conv weight are gathered
whole) and jamba-1.5-large-398b-smoke (a mamba layer with a dense MLP,
then GQA 4/2 with a top-2 MoE); two chained sharded rounds of jamba are
``test_torch_tp_rounds.py``.

Held (``_torch_tp_parity.hold_model``): the loss and metrics within 1e-6
of JAX's, the gradient and one ``uga_update`` within 1e-5 of the
unsharded port's and 1e-4 of JAX's update, ``gather_params`` bitwise;
mamba2's gradient within 1e-5 of JAX's too.  jamba's client update is
ill-conditioned in the embedding (``tests/test_torch_ssm_train.py``: the
fp32 rounding of the first local step moves it by up to 1.5e-4 at lr
0.05, and the sharded update is 1.3e-5 from the unsharded one for that
reason alone), so it is held with the first local step pinned to JAX's,
in every process and in the unsharded reference alike; and its
gradient's ``A_log`` is 1.5e-5 from JAX's in the unsharded port itself,
so its gradient is held to 1e-5 of the unsharded port's and to the JAX
suite's 1e-4 of JAX's.  The routing of jamba's MoE on every process is
JAX's and the unsharded port's.  The gradients of the whole leaves a
process slices to its heads (``A_log``, ``D``, ``dt_bias``) are held on
every process against the unsharded ones: a process that kept its own
heads' part only would lose the other's.
"""
import pytest

from _torch_parity import (assert_same_routing, max_tree_rel_err, rel_err,
                           routes_port)
from _torch_tp_parity import complete, hold_model, join, prepare, start

MAMBA2 = "mamba2-780m-smoke"
JAMBA = "jamba-1.5-large-398b-smoke"


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """JAX's references, computed while the job runs."""
    refs = {MAMBA2: prepare(MAMBA2, seed=4),
            JAMBA: prepare(JAMBA, seed=5, pin=True)}
    job = start(2, 2, tmp_path_factory.mktemp("tp_mamba_1x2"),
                list(refs.values()))
    for ref in refs.values():
        complete(ref)
    return refs, join(job)


@pytest.fixture(scope="module")
def refs(run):
    return run[0]


@pytest.fixture(scope="module")
def mesh_1x2(run):
    return run[1]


@pytest.mark.parametrize("name", [MAMBA2, JAMBA])
def test_model_on_two_matches_jax_and_unsharded(mesh_1x2, refs, name):
    hold_model(mesh_1x2, refs[name])


def test_jamba_free_update_near_jax(mesh_1x2, refs):
    """jamba's update without the pin: within 5e-4 of JAX's (the bound
    ``test_torch_ssm_train.py`` holds the unsharded port's to)."""
    ref = refs[JAMBA]
    for res in mesh_1x2:
        assert max_tree_rel_err(res[JAMBA]["uga"][0], ref["uga"][0]) <= 5e-4


def test_jamba_routing_on_two_is_the_unsharded_routing(mesh_1x2, refs,
                                                       monkeypatch):
    ref = refs[JAMBA]
    _, trecs = routes_port(lambda: ref["tm"].loss(ref["p0"], ref["batch"]),
                           monkeypatch)
    assert_same_routing(ref["routes"], trecs)
    for res in mesh_1x2:
        assert_same_routing(ref["routes"], res[JAMBA]["loss:gather"][2])


@pytest.mark.parametrize("name", [MAMBA2, JAMBA])
def test_sliced_whole_leaves_have_whole_gradients(mesh_1x2, refs, name):
    """``A_log``, ``D`` and ``dt_bias`` are whole leaves each process
    slices to its heads; the gradient each process holds of them is the
    whole one (1e-5 of the unsharded port's), not its heads' part."""
    ref = refs[name]
    for res in mesh_1x2:
        sliced = res[name]["sliced"]
        assert {k.rsplit(".", 1)[1] for k in sliced} == {"A_log", "D",
                                                        "dt_bias"}
        for k, v in sliced.items():
            assert v.shape == ref["p0"][k].shape
            assert rel_err(v, ref["port_grad"][k]) <= 1e-5, k


def test_mamba_shards_are_the_placements(mesh_1x2):
    """``in_proj``'s 1064 columns and ``conv_w``'s 544 channels split at
    532 and 272, inside the x segment; ``out_proj``'s 512 rows at 256, 4
    whole heads; the per-head leaves whole."""
    for res in mesh_1x2:
        s = res[MAMBA2]["shapes"]
        assert s["blocks.0.mamba.in_proj"] == (2, 256, 532)
        assert s["blocks.0.mamba.conv_w"] == (2, 4, 272)
        assert s["blocks.0.mamba.out_proj"] == (2, 256, 256)
        for k in ("A_log", "D", "dt_bias"):
            assert s[f"blocks.0.mamba.{k}"] == (2, 8)
