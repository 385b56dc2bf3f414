"""The topk uplink codec on the mesh's model axis, on the CPU with gloo:
two chained rounds with and without error feedback on a (1, 2) mesh, as
``test_torch_tp_codecs.py`` holds int8 (its docstring).

Each process takes its k largest |g| among the elements it owns (never
an element it does not own, whose zero would tie), the candidates of
every process are gathered, and the group's k are picked from them by
|g|, then by global index, the same pick on every process.
"""
import pytest

import _torch_tp_modes_parity as P

RUNS_1X2 = (("topk", 2, False), ("topk+ef", 2, False))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return P.run_modes(tmp_path_factory, "tp_topk", RUNS_1X2)


@pytest.mark.parametrize("mode,chunk", [(m, c) for m, c, _ in RUNS_1X2])
@pytest.mark.parametrize("against", ["jax", "port"])
def test_two_coded_rounds_on_the_model_axis(run, mode, chunk, against):
    P.codec_rounds_test(run, "1x2", mode, chunk, against)
