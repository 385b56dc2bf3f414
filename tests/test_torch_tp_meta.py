"""FedMeta through the aggregation on the mesh's model axis, on the CPU
with gloo: smollm-360m-smoke from JAX's parameters, two chained rounds on
a (1, 2) mesh of two processes (sgd in chunks of 2, adam from a warm
state in chunks of 1) and on a (2, 2) mesh of four (sgd: the model-axis
sum of each client's ``dw`` comes before the data axis's gather),
against JAX's unsharded trainer and the port's world of one at the
tolerances of ``_torch_tp_modes_parity.py``, every rank's state bitwise
the same.  The ``legacy_tree`` engine on the axis is
``test_torch_tp_legacy.py`` (JAX's trainer compiles once a mode; the
files run in parallel).

The trap of the mode: each process's update backward sees only its rows,
so the step's scalar cotangents (and through ``||G||`` the clip's share
of dG) are partial sums until the model axis sums them.  One probe holds
the objective's gradients w.r.t. ``w_logits``, ``log_lr`` and the whole
aggregate G against the world of one's at 1e-5.

The jobs run while the parent computes the references (JAX's trainer one
compile a mode, the port's world of one).
"""
import pytest

import _torch_tp_modes_parity as P
from _torch_parity import rel_err

RUNS_1X2 = (("through:sgd", 2, False), ("through:adam", 1, False))
RUNS_2X2 = (("through:sgd", 1, False),)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return P.run_modes(tmp_path_factory, "tp_meta", RUNS_1X2, RUNS_2X2,
                       probes=("hypergrads",))


@pytest.mark.parametrize("mesh,mode,chunk", [
    ("1x2", m, c) for m, c, _ in RUNS_1X2] + [
    ("2x2", m, c) for m, c, _ in RUNS_2X2])
@pytest.mark.parametrize("against", ["jax", "port"])
def test_two_rounds_on_the_model_axis(run, mesh, mode, chunk, against):
    ranks, jax_ref, port = run[0][mesh], run[1], run[2]
    key = f"rounds:{mode}:{chunk}"
    ref = jax_ref[mode] if against == "jax" else port[(mode, chunk)]
    state, hist = ranks[0][key]
    P.hold_run(state, hist, ref, mode, (mesh, key, against))
    P.hold_ranks_equal(ranks, key)


def test_hypergradients_are_whole_on_every_rank(run):
    """The scalar cotangents of each rank's update backward (partial over
    its rows) summed over the axis: ``log_lr``'s hypergradient, the
    weights' and the whole dG equal the world of one's within 1e-5 on
    every rank, and the ranks' bitwise."""
    ref = run[3]["hypergrads"]
    got = [res["probe:hypergrads"] for res in run[0]["1x2"]]
    for g in got:
        for key in ("d_w_logits", "d_log_lr"):
            assert rel_err(g[key], ref[key]) <= P.TOL, key
        for a, b in zip(g["dG"], ref["dG"]):
            assert rel_err(a, b) <= P.TOL, "dG"
        for a, b in zip(g["G"], ref["G"]):
            assert rel_err(a, b) <= P.TOL, "G"
    for key in ("d_w_logits", "d_log_lr"):
        assert (got[1][key] == got[0][key]).all(), key
    assert all((a == b).all() for a, b in zip(got[1]["dG"], got[0]["dG"]))
