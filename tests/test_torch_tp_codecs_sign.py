"""The sign1bit uplink codec on the mesh's model axis, on the CPU with
gloo: two chained rounds with and without error feedback on a (1, 2) mesh,
as ``test_torch_tp_codecs.py`` holds int8 (its docstring).

The group's magnitude ``mu`` is the sum of |g| reduced over the axis.
The trap of the codec: ``sign(0) := +1``, so a process's zeros where it
owns nothing pack as +1 and would decode to +mu w, which every
non-owner would add to the sum, and leave a residual of -mu there.  One
probe holds one error-feedback round's aggregate and residual stacks to
the world of one's under the flip-aware criterion: a build that does not
mask the decode and the residual by ownership fails it at every element.
"""
import pytest

import _torch_tp_modes_parity as P
from test_torch_comm_rounds import flip_aware

RUNS_1X2 = (("sign1bit", 2, False), ("sign1bit+ef", 2, False))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return P.run_modes(tmp_path_factory, "tp_sign", RUNS_1X2,
                       probes=("sign1bit+ef",))


@pytest.mark.parametrize("mode,chunk", [(m, c) for m, c, _ in RUNS_1X2])
@pytest.mark.parametrize("against", ["jax", "port"])
def test_two_coded_rounds_on_the_model_axis(run, mode, chunk, against):
    P.codec_rounds_test(run, "1x2", mode, chunk, against)


def test_sign1bit_zeros_a_rank_does_not_own_add_nothing(run):
    """One sign1bit + error-feedback round: the aggregate G (a flip moves
    an element by 2 mu w_k) and the residual stacks (by 2 mu) of every
    rank against the world of one's, and the ranks' bitwise."""
    ref = run[3]["sign1bit+ef"]
    got = [res["probe:sign1bit+ef"] for res in run[0]["1x2"]]
    for g in got:
        for a, b in zip(g["G"], ref["G"]):
            top = float(b.abs().max())
            flip_aware(a, b, ref_scale=top, cap=2 * top, what="G")
        for a, b in zip(g["residual"], ref["residual"]):
            top = float(b.abs().max())
            flip_aware(a, b, ref_scale=top, cap=2 * top, what="residual")
    for a, b in zip(got[1]["G"] + list(got[1]["residual"]),
                    got[0]["G"] + list(got[0]["residual"])):
        assert (a == b).all()
