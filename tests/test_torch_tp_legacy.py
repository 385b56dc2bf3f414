"""The ``legacy_tree`` engine (the launcher's default without
``--fused``) on the mesh's model axis, on the CPU with gloo:
smollm-360m-smoke from JAX's parameters, two chained rounds with sgd on a
(1, 2) mesh of two processes, in chunks of 2, against JAX's unsharded
legacy trainer and the port's world of one at the tolerances of
``_torch_tp_modes_parity.py``, every rank's state bitwise the same.

After the model-axis sum the streamed buffers are whole on every
process; the tree handle is their view as a tree, and the engine's tree
maps run whole on every process (no update kernel).
"""
import pytest

import _torch_tp_modes_parity as P

RUNS_1X2 = (("legacy_tree:sgd", 2, False),)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return P.run_modes(tmp_path_factory, "tp_legacy", RUNS_1X2)


@pytest.mark.parametrize("against", ["jax", "port"])
def test_two_legacy_rounds_on_the_model_axis(run, against):
    ranks, jax_ref, port = run[0]["1x2"], run[1], run[2]
    key = "rounds:legacy_tree:sgd:2"
    ref = (jax_ref["legacy_tree:sgd"] if against == "jax"
           else port[("legacy_tree:sgd", 2)])
    state, hist = ranks[0][key]
    P.hold_run(state, hist, ref, "legacy_tree:sgd", (key, against))
    P.hold_ranks_equal(ranks, key)
