"""Two chained sharded rounds of the hybrid on the mesh's model axis:
jamba-1.5-large-398b-smoke (a mamba layer with a dense MLP, then GQA 4/2
with a top-2 MoE) through the trainer on a (1, 2) mesh of two gloo
processes on the CPU, from JAX's parameters, in chunks of 2, against
JAX's unsharded trainer and the port's world of one.

The job is spawned as ``torchrun`` launches it (the rank body is
``tests/_torch_tp_layers_worker.py``, which imports no JAX) and runs
while the parent computes both references.  Held: metrics within 1e-4;
parameters within 1e-4; every rank's state and history bitwise the
same.  The parameters are held to 1e-4, not 1e-5, for the reason
``tests/test_torch_tp_mamba.py`` gives: a jamba client's update is
ill-conditioned in the embedding (``tests/test_torch_ssm_train.py``
holds the unsharded port's round to JAX's at 1e-4 for it).
"""
import jax
import jax.numpy as jnp
import pytest
import torch

import _torch_tp_layers_worker as W
from _torch_parity import jax_params_to_torch, rel_err
from _torch_tp_parity import join, leaves, prepare, start
from repro.configs import FedConfig as JaxFedConfig
from repro.configs import get_arch as jax_get_arch
from repro.core import FederatedTrainer as JaxTrainer
from repro.launch.train import build_synthetic_fed_data as jax_fed_data
from repro.models.model import build_model as jax_build_model

JAMBA = "jamba-1.5-large-398b-smoke"
ROUND_CHUNK = 2


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The ranks' W.ROUNDS rounds; JAX's unsharded trainer (one compile)
    and the port's world of one from the same parameters, computed while
    the ranks run."""
    ref = prepare(JAMBA, seed=5)
    job = start(2, 2, tmp_path_factory.mktemp("tp_rounds_1x2"), [],
                rounds=[(JAMBA, ROUND_CHUNK)], p0={JAMBA: ref["p0"]})
    jt = JaxTrainer(jax_build_model(jax_get_arch(JAMBA), dtype=jnp.float32,
                                    loss_chunk=256),
                    JaxFedConfig(**W.FED), seed=0)
    # a copy: the trainer donates its state's buffers
    jt.state["params"] = jax.tree.map(lambda x: jnp.array(x, copy=True),
                                      ref["jp"])
    hist = jt.run(jax_fed_data(jax_get_arch(JAMBA), **W.DATA),
                  rounds=W.ROUNDS, cohort=W.COHORT, batch=W.BATCH,
                  meta_batch=2 * W.BATCH)
    port = W.run_rounds(JAMBA, ref["p0"], ROUND_CHUNK)
    return join(job), (hist, jax_params_to_torch(jt.state["params"])), port


@pytest.fixture(scope="module")
def mesh_1x2(run):
    return run[0]


@pytest.fixture(scope="module")
def jamba_references(run):
    return run[1], run[2]


@pytest.mark.parametrize("against", ["jax", "port"])
def test_jamba_two_sharded_rounds(mesh_1x2, jamba_references, against):
    """Metrics within 1e-4; parameters within 1e-4, the bound
    ``test_torch_ssm_train.py`` holds jamba's unsharded round to: each
    client's update carries the ill-conditioning of the module docstring,
    worst in the
    embedding (measured 5.6e-5 from JAX's trainer, 2.6e-5 from the port's
    world of one) and in ``dt_bias``, which starts at zero, so that its
    relative error is its update's (4.9e-5, 1.3e-5)."""
    (jhist, jparams), (pstate, phist) = jamba_references
    ref_hist, ref_params = ((jhist, jparams) if against == "jax"
                            else (phist, pstate["params"]))
    state, hist = mesh_1x2[0][f"rounds:{JAMBA}:{ROUND_CHUNK}"]
    assert [r["round"] for r in hist] == list(range(W.ROUNDS))
    for tr, jr in zip(hist, ref_hist):
        for k in ("client_loss", "grad_norm", "meta_loss"):
            assert abs(tr[k] - jr[k]) <= 1e-4 * abs(jr[k]), (k, tr, jr)
    errs = {k: rel_err(v, ref_params[k]) for k, v in state["params"].items()}
    print(f"jamba rounds against {against}: worst leaves "
          f"{sorted(errs.items(), key=lambda kv: -kv[1])[:3]}")
    assert max(errs.values()) <= 1e-4, max(errs, key=errs.get)


def test_jamba_ranks_hold_the_same_state(mesh_1x2):
    state, hist = mesh_1x2[0][f"rounds:{JAMBA}:{ROUND_CHUNK}"]
    other, ohist = mesh_1x2[1][f"rounds:{JAMBA}:{ROUND_CHUNK}"]
    assert ohist == hist
    for (n, a), (_, b) in zip(leaves(other), leaves(state)):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b)), n
