"""Tensor-parallel client compute over the mesh's model axis on the MoE
and MLA layers, on the CPU with gloo.

Two jobs are spawned, launched as ``torchrun`` launches them (the rank
body is ``tests/_torch_tp_layers_worker.py``, which imports no JAX): a
world of two on a (1, 2) mesh running deepseek-v2-lite-16b-smoke (MLA
on each process's 2 of 4 heads, the latent and rope products gathered;
2 of the 4 experts a process, the shared expert split like the dense
MLP) and llama4-scout-17b-a16e-smoke (GQA 4/2 on each process's heads,
top-1 MoE, the shared expert split); and a world of three on (1, 3)
running deepseek-smoke, whose experts, heads, latent rank, rope dim,
shared expert and vocab the axis does not divide (all whole, as JAX's
placement leaves them) while ``wq``'s columns split mid-head.

Parameters are JAX's, bridged; tokens are made with numpy from a seed.
Held (``_torch_tp_parity.hold_model``): the loss and metrics within 1e-6
of JAX's, the gradient within 1e-5 of JAX's and of the unsharded port's,
one ``uga_update`` within 1e-4 of JAX's and 1e-5 of the unsharded
port's, ``gather_params`` of the shards bitwise the parameters.  Before
any value, the routing: every process routes every token as JAX and the
unsharded port do (expert indices and capacity keeps of every MoE
layer), in both dispatch forms, since the router weight is gathered and
the logits taken at the unsharded shape.
"""
import pytest

from _torch_parity import assert_same_routing, routes_port
from _torch_tp_parity import complete, hold_model, join, prepare, start

DEEPSEEK = "deepseek-v2-lite-16b-smoke"
SCOUT = "llama4-scout-17b-a16e-smoke"
ARCHS = [DEEPSEEK, SCOUT]
FORMS = ("gather", "einsum")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """JAX's references, computed while both jobs run."""
    refs = {name: prepare(name, seed=i + 2) for i, name in enumerate(ARCHS)}
    two = start(2, 2, tmp_path_factory.mktemp("tp_moe_1x2"),
                list(refs.values()), {n: FORMS for n in ARCHS})
    three = start(3, 3, tmp_path_factory.mktemp("tp_moe_1x3"),
                  [refs[DEEPSEEK]], {DEEPSEEK: FORMS})
    for ref in refs.values():
        complete(ref)
    return refs, join(two), join(three)


@pytest.fixture(scope="module")
def refs(run):
    return run[0]


@pytest.fixture(scope="module")
def mesh_1x2(run):
    return run[1]


@pytest.fixture(scope="module")
def mesh_1x3(run):
    return run[2]


@pytest.mark.parametrize("name", ARCHS)
def test_model_on_two_matches_jax_and_unsharded(mesh_1x2, refs, name):
    hold_model(mesh_1x2, refs[name])


def test_deepseek_on_three_matches_jax_and_unsharded(mesh_1x3, refs):
    hold_model(mesh_1x3, refs[DEEPSEEK])


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("name", ARCHS)
def test_routing_on_two_is_the_unsharded_routing(mesh_1x2, refs, name,
                                                 form, monkeypatch):
    """Every process routes every token as JAX and the unsharded port
    do, in both dispatch forms; each form's loss within 1e-6 of JAX's."""
    from repro_torch.models import moe as TMOE
    ref = refs[name]
    monkeypatch.setattr(TMOE, "MOE_IMPL", form)
    _, trecs = routes_port(lambda: ref["tm"].loss(ref["p0"], ref["batch"]),
                           monkeypatch)
    assert_same_routing(ref["routes"], trecs)
    for res in mesh_1x2:
        value, _, recs = res[name][f"loss:{form}"]
        assert_same_routing(ref["routes"], recs)
        assert abs(float(value) - ref["loss"]) <= 1e-6 * abs(ref["loss"])


@pytest.mark.parametrize("form", FORMS)
def test_routing_on_three_is_the_unsharded_routing(mesh_1x3, refs, form):
    for res in mesh_1x3:
        assert_same_routing(refs[DEEPSEEK]["routes"],
                            res[DEEPSEEK][f"loss:{form}"][2])


# deepseek-smoke's whole leaves (past the stack of 2 layers)
WHOLE = {"mlp.router": (256, 4), "mlp.w_gate": (4, 256, 128),
         "mlp.w_down": (4, 128, 256), "mlp.shared.w_gate": (256, 128),
         "attn.wq": (256, 384), "attn.w_uk": (64, 4, 64),
         "attn.wo": (256, 256), "attn.w_dkv": (256, 64),
         "attn.w_kr": (256, 32)}


@pytest.mark.parametrize("m,split", [
    (2, {"mlp.router": -1, "mlp.w_gate": 0, "mlp.w_down": 0,
         "mlp.shared.w_gate": -1, "attn.wq": -1, "attn.w_uk": 1,
         "attn.wo": 0, "attn.w_dkv": -1, "attn.w_kr": -1}),
    (3, {"attn.wq": -1})])
def test_deepseek_shards_are_the_placements(request, m, split):
    """(1, 2): the experts, the router's columns, MLA's heads (``wq``,
    ``w_uk``, ``wo``), the latent and rope columns and the shared expert
    split in 2.  (1, 3): only ``wq``'s 384 columns divide (mid-head: 4
    heads of 96); the rest stays whole."""
    ranks = request.getfixturevalue(f"mesh_1x{m}")
    for res in ranks:
        shapes = res[DEEPSEEK]["shapes"]
        for k, whole in WHOLE.items():
            want = list(whole)
            if k in split:
                want[split[k]] //= m
            assert shapes[f"blocks.0.{k}"] == (2, *want), k
        assert shapes["embed"] == ((256, 256) if m == 2 else (512, 256))
