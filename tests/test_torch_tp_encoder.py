"""Tensor-parallel client compute over the mesh's model axis on the
encoder and the cross layers, on the CPU with gloo.

One job is spawned, launched as ``torchrun`` launches it (the rank body
is ``tests/_torch_tp_layers_worker.py``, which imports no JAX): a world
of two on a (1, 2) mesh running whisper-large-v3-smoke (an encoder of 2
pre-LN layers over 64 frames, attention on each process's 2 of 4 heads,
the GELU MLP split: ``w_in``'s columns, ``w_out``'s rows, each process
adding its part of the whole ``b_in`` and ``b_out`` once after the sum;
the decoder's self layer and its cross layer over the encoder's output
on each process's heads) and llama-3.2-vision-90b-smoke (no encoder
layers: the cross layer's keys and values from ``enc_embeds`` directly,
GQA 8/2 on each process's heads).

Held (``_torch_tp_parity.hold_model``): the loss and metrics within 1e-6
of JAX's, the gradient within 1e-5 of JAX's and of the unsharded port's,
one ``uga_update`` within 1e-4 of JAX's and 1e-5 of the unsharded
port's, ``gather_params`` of the shards bitwise the parameters.  The
gradient of ``b_in``, a whole leaf each process slices to its columns,
is held on every process against the unsharded one: a process that kept
its own columns' part only would lose the other's.  Then one sharded
round of each through the launcher's data (seeded ``enc_embeds``)
against the port's world of one.
"""
import pytest

from _torch_parity import max_tree_rel_err, rel_err
from _torch_tp_parity import complete, hold_model, join, prepare, start

WHISPER = "whisper-large-v3-smoke"
VISION = "llama-3.2-vision-90b-smoke"
ARCHS = [WHISPER, VISION]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """JAX's references and the port's world of one (2 rounds of each),
    computed while the job runs."""
    import _torch_tp_layers_worker as W
    refs = {name: prepare(name, seed=i + 6) for i, name in enumerate(ARCHS)}
    job = start(2, 2, tmp_path_factory.mktemp("tp_encoder_1x2"),
                list(refs.values()), rounds=[(n, 2) for n in ARCHS])
    for ref in refs.values():
        complete(ref)
    one = {n: W.run_rounds(n, refs[n]["p0"], 2) for n in ARCHS}
    return refs, join(job), one


@pytest.fixture(scope="module")
def refs(run):
    return run[0]


@pytest.fixture(scope="module")
def mesh_1x2(run):
    return run[1]


@pytest.fixture(scope="module")
def world_of_one(run):
    return run[2]


@pytest.mark.parametrize("name", ARCHS)
def test_model_on_two_matches_jax_and_unsharded(mesh_1x2, refs, name):
    hold_model(mesh_1x2, refs[name])


def test_b_in_gradient_is_whole_on_every_process(mesh_1x2, refs):
    ref = refs[WHISPER]
    for res in mesh_1x2:
        sliced = res[WHISPER]["sliced"]
        assert list(sliced) == ["encoder.layers.mlp.b_in"]
        v = sliced["encoder.layers.mlp.b_in"]
        assert v.shape == (2, 512)
        assert rel_err(v, ref["port_grad"]["encoder.layers.mlp.b_in"]) \
            <= 1e-5


def test_encoder_and_cross_shards_are_the_placements(mesh_1x2):
    """whisper: the encoder's q/k/v columns and ``wo`` rows at whole heads
    (2 of 4 a process), ``w_in`` / ``w_out`` split, the biases and norms
    whole; the cross layer's k/v columns.  vision: q 8 heads and k/v 2
    heads of 32 split to 4 and 1."""
    for res in mesh_1x2:
        w, v = res[WHISPER]["shapes"], res[VISION]["shapes"]
        assert w["encoder.layers.attn.wq"] == (2, 256, 128)
        assert w["encoder.layers.attn.wo"] == (2, 128, 256)
        assert w["encoder.layers.mlp.w_in"] == (2, 256, 256)
        assert w["encoder.layers.mlp.w_out"] == (2, 256, 256)
        assert w["encoder.layers.mlp.b_in"] == (2, 512)
        assert w["encoder.layers.mlp.b_out"] == (2, 256)
        assert w["encoder.layers.ln1_s"] == (2, 256)
        assert w["blocks.1.attn.wk"] == (1, 256, 128)
        assert v["blocks.1.attn.wq"] == (1, 256, 128)
        assert v["blocks.1.attn.wk"] == (1, 256, 32)


@pytest.mark.parametrize("name", ARCHS)
def test_sharded_rounds_match_the_world_of_one(mesh_1x2, world_of_one,
                                               name):
    """Two rounds of the trainer on the launcher's data (``enc_embeds``
    drawn by ``SeededFrames``): parameters 1e-5 and metrics 1e-4 of the
    port's world of one, the two ranks' histories equal."""
    pstate, phist = world_of_one[name]
    (state, hist), (_, ohist) = (r[f"rounds:{name}:2"] for r in mesh_1x2)
    assert ohist == hist and len(hist) == len(phist)
    for tr, pr in zip(hist, phist):
        for k in ("client_loss", "grad_norm", "meta_loss"):
            assert abs(tr[k] - pr[k]) <= 1e-4 * abs(pr[k]), (k, tr, pr)
    assert max_tree_rel_err(state["params"], pstate["params"]) <= 1e-5
