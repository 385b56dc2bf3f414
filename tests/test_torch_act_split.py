"""The residual stream split over the model axis by batch rows (the eager
meaning of JAX's ``set_activation_spec``, ``--act-spec on``): between
sublayers each process holds its rows of a client's (b, S, d) stream,
the norms and residual adds run on them, each sublayer's input is
gathered whole and its output reduce-scattered back to the rows
(``sharding/tensor_parallel.py``: ``GatherRows``, ``ReduceScatterRows``,
``SplitRows``; ``models/transformer.py::_sublayer``).

Two chained sharded rounds of the trainer on a (1, 2) mesh, two gloo
processes on the CPU, in chunks of 2, from JAX's parameters, for
smollm-360m-smoke (3 query heads, which 2 does not divide: q / k / v
gathered whole, ``wo`` row-parallel, the split MLP) and
deepseek-v2-lite-16b-smoke (MLA on each process's heads, the experts
split, the MoE's output whole), each with the stream split and
replicated; smollm also at a client batch of 6, so that a local step's 3
rows split as 2 a process with one zero row padding the second.  Held:
the split round's parameters within 1.192e-7 of the replicated round's
(max |a-b| over max |b| over the whole parameter vector, as
``chip_smoke.py::flat_err`` holds the axis to its world of one:
fp32's epsilon at the norms' scale of 1; the norm scales' gradient
is now each process's rows summed, then added over the axis, in another
order than one process's sum over all rows), and both ranks' states and
histories bitwise the same (the metrics within 1e-6 of the replicated
round's); the split round against JAX's unsharded
trainer within 1e-5 on the parameters and 1e-4 on the metrics, the
tolerances the model axis's other tests hold it to.  Then the dry run's smoke train
pair on (1, 2): less temp a process under ``on`` than under ``off``.
"""
import jax
import jax.numpy as jnp
import pytest
import torch

import _torch_tp_layers_worker as W
from _torch_parity import jax_params_to_torch, rel_err
from _torch_tp_parity import join, leaves, start
from repro.configs import FedConfig as JaxFedConfig
from repro.configs import get_arch as jax_get_arch
from repro.core import FederatedTrainer as JaxTrainer
from repro.launch.train import build_synthetic_fed_data as jax_fed_data
from repro.models.model import build_model as jax_build_model
from repro_torch.launch.dryrun import run_one

SMOLLM, DEEPSEEK = "smollm-360m-smoke", "deepseek-v2-lite-16b-smoke"
CHUNK = 2
# (arch, client batch): the rounds run under "on" and "off"
CASES = [(SMOLLM, W.BATCH), (SMOLLM, 6), (DEEPSEEK, W.BATCH)]
EPS = 1.192e-7
# the round's metrics under on against off: a norm of the gradient, losses
# at parameters a few fp32 steps apart (measured 1.9e-7 for deepseek)
TOL_ON_OFF_METRIC = 1e-6
TOL, TOL_METRIC = 1e-5, 1e-4


def _key(name, act, batch):
    return f"rounds:{name}:{CHUNK}:{act}:{batch}"


def flat_err(params, ref) -> float:
    """max |a-b| over max |b| over every leaf at once."""
    diff = max(float((v - ref[k]).abs().max()) for k, v in params.items())
    return diff / max(float(v.abs().max()) for v in ref.values())


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    p0, jax_runs = {}, {}
    for i, name in enumerate((SMOLLM, DEEPSEEK)):
        jm = jax_build_model(jax_get_arch(name), dtype=jnp.float32,
                             loss_chunk=256)
        jp = jax.jit(jm.init)(jax.random.PRNGKey(11 + i))
        p0[name] = jax_params_to_torch(jp)
        jax_runs[name] = (jm, jp)
    rounds = [(n, CHUNK, act, b) for n, b in CASES for act in ("on", "off")]
    job = start(2, 2, tmp_path_factory.mktemp("act_split"), [],
                rounds=rounds, p0=p0)
    ref = {}
    for name, batch in CASES:
        jm, jp = jax_runs[name]
        jt = JaxTrainer(jm, JaxFedConfig(**W.FED), seed=0)
        # a copy: the trainer donates its state's buffers
        jt.state["params"] = jax.tree.map(
            lambda x: jnp.array(x, copy=True), jp)
        hist = jt.run(jax_fed_data(jax_get_arch(name), **W.DATA),
                      rounds=W.ROUNDS, cohort=W.COHORT, batch=batch,
                      meta_batch=2 * batch)
        ref[(name, batch)] = (hist, jax_params_to_torch(jt.state["params"]))
    return join(job), ref


@pytest.mark.parametrize("name,batch", CASES)
def test_split_stream_round_equals_the_replicated_one(run, name, batch):
    ranks, _ = run
    for res in ranks:
        on, h_on = res[_key(name, "on", batch)]
        off, h_off = res[_key(name, "off", batch)]
        assert flat_err(on["params"], off["params"]) <= EPS
        for a, b in zip(h_on, h_off):
            for k in ("client_loss", "grad_norm", "meta_loss"):
                assert abs(a[k] - b[k]) <= TOL_ON_OFF_METRIC * abs(b[k]), k


@pytest.mark.parametrize("name,batch", CASES)
def test_ranks_hold_the_same_state(run, name, batch):
    ranks, _ = run
    state, hist = ranks[0][_key(name, "on", batch)]
    other, ohist = ranks[1][_key(name, "on", batch)]
    assert ohist == hist
    for (n, a), (_, b) in zip(leaves(other), leaves(state)):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b)), n


@pytest.mark.parametrize("name,batch", CASES)
def test_split_stream_round_matches_jax(run, name, batch):
    ranks, ref = run
    jhist, jparams = ref[(name, batch)]
    state, hist = ranks[0][_key(name, "on", batch)]
    assert [r["round"] for r in hist] == list(range(W.ROUNDS))
    for tr, jr in zip(hist, jhist):
        for k in ("client_loss", "grad_norm", "meta_loss"):
            assert abs(tr[k] - jr[k]) <= TOL_METRIC * abs(jr[k]), (k, tr, jr)
    errs = {k: rel_err(v, jparams[k]) for k, v in state["params"].items()}
    assert max(errs.values()) <= TOL, max(errs, key=errs.get)


def test_dry_run_temp_falls_with_the_split():
    recs = {spec: run_one(SMOLLM, "train_4k", mesh="1x2", act_spec=spec,
                          verbose=False) for spec in ("on", "off")}
    temp = {k: r["memory"]["temp_size_in_bytes"] for k, r in recs.items()}
    assert temp["on"] < temp["off"], temp
    assert "split over model" in recs["on"]["placement"]["activations"]
    assert "replicated" in recs["off"]["placement"]["activations"]
    assert recs["on"]["collectives"]["_counts"]["reduce_scatter_"] > 0
