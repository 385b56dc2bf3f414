"""The int8 uplink codec on the mesh's model axis, on the CPU with gloo:
smollm-360m-smoke from JAX's parameters, two chained rounds with and
without error feedback on a (1, 2) mesh of two processes, and with it on
a (2, 2) mesh of four (each client's residual row summed over the model
axis, then broadcast over the data axis), in chunks of 2, against JAX's
unsharded trainer and the port's world of one at the tolerances of
``_torch_tp_modes_parity.py`` (the flip-aware criterion), every rank's
state bitwise the same; and a (1, 2) error-feedback run's checkpoint
restored in a world of one.

Each process holds of a client's gradient the elements it owns, so the
group's amax is reduced over the axis by MAX: the scale is exactly the
world of one's for the same gradient.  The sign1bit and topk codecs are
``test_torch_tp_codecs_sign.py`` and ``test_torch_tp_codecs_topk.py``:
JAX's trainer compiles once a mode, so the six modes are spread over
three files for a parallel run.
"""
import pytest
import torch

import _torch_tp_modes_parity as P
import _torch_tp_modes_worker as W
from repro_torch.configs import get_arch
from repro_torch.core.trainer import FederatedTrainer
from repro_torch.models.model import build_model

RUNS_1X2 = (("int8", 2, False), ("int8+ef", 2, True))
RUNS_2X2 = (("int8+ef", 2, False),)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return P.run_modes(tmp_path_factory, "tp_int8", RUNS_1X2, RUNS_2X2)


@pytest.mark.parametrize("mesh,mode,chunk", [
    ("1x2", m, c) for m, c, _ in RUNS_1X2] + [
    ("2x2", m, c) for m, c, _ in RUNS_2X2])
@pytest.mark.parametrize("against", ["jax", "port"])
def test_two_coded_rounds_on_the_model_axis(run, mesh, mode, chunk,
                                            against):
    P.codec_rounds_test(run, mesh, mode, chunk, against)


def test_error_feedback_checkpoint_restores_in_a_world_of_one(run):
    """A (1, 2) int8 + error-feedback run's blob is JAX's of the global
    state, the residual stacks whole: a trainer with no mesh restores
    its parameters and residuals bitwise."""
    state, _ = run[0]["1x2"][0]["rounds:int8+ef:2"]
    tt = FederatedTrainer(build_model(get_arch(W.SMOKE), loss_chunk=256),
                          W.fed_config("int8+ef", None), device="cpu",
                          seed=1)
    tt.restore(str(run[4] / "int8+ef.msgpack"))
    assert tt.round == W.ROUNDS
    for k, v in state["params"].items():
        assert torch.equal(tt.state["params"][k], v), k
    for a, b in zip(tt.state["comm"]["residual"],
                    state["comm"]["residual"]):
        assert torch.equal(a, b)
