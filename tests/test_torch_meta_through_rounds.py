"""Controllable meta updating through the aggregation
(``meta_mode='through_aggregation'``) end to end: 3 rounds of the JAX
``FederatedTrainer`` against the port's at smoke size, same data seed,
bridged init and ``ctrl``, held at the tolerances of
``test_torch_meta_through.py`` (its docstring).  The vmap/sgd case is
here, the scan/adam case (warm: t = 5, random m, v > 0) in
``test_torch_meta_through_rounds_scan.py``: each compiles its own JAX
trainer, so a parallel run spreads them over two workers.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import (SMOKE, jax_params_to_torch, max_tree_rel_err,
                           rel_err)
from repro.configs import FedConfig as JaxFedConfig
from repro.configs import get_arch as jax_get_arch
from repro.core import FederatedTrainer as JaxTrainer
from repro.launch.train import build_synthetic_fed_data as jax_fed_data
from repro.models.model import build_model as jax_build_model
from repro_torch import bridge
from repro_torch.configs import FedConfig, get_arch
from repro_torch.core.trainer import FederatedTrainer
from repro_torch.launch.train import build_synthetic_fed_data
from repro_torch.models.model import build_model
from test_torch_meta_through import (CTRL_KEYS, META_KEYS, TOL, TOL_METRIC,
                                     _fed_kw, _flat_state, _jax_state)


CASES = {"vmap-sgd": ("vmap", "sgd", False),
         "scan-adam-warm": ("scan", "adam", True)}


def three_rounds_match_jax_trainer(case):
    """Run ``case`` of :data:`CASES` 3 rounds in both trainers and hold
    the port to JAX: the history at the metric tolerance, ``ctrl``, the
    parameters and the optimizer slots at 1e-5."""
    strategy, opt, warm = CASES[case]
    kw = _fed_kw(strategy, opt)
    kw.update(cohort=2, server_lr=0.01, ctrl_lr=0.01, lr_decay=0.992)
    data_kw = dict(num_clients=8, examples=64, seq=32, iid=False, seed=0)
    run_kw = dict(rounds=3, cohort=2, batch=4, meta_batch=8)
    jt = JaxTrainer(jax_build_model(jax_get_arch(SMOKE), dtype=jnp.float32,
                                    loss_chunk=256), JaxFedConfig(**kw),
                    seed=0)
    tt = FederatedTrainer(build_model(get_arch(SMOKE), loss_chunk=256),
                          FedConfig(**kw), device="cpu",
                          params=jax_params_to_torch(jt.state["params"]))
    if warm:
        rows = jt.state["opt"]["m"][0].shape[0]
        opt_np = _flat_state(opt, rows, 5)
        jt.state["opt"], _ = _jax_state(opt_np, {})
        tt.state["opt"] = bridge.server_state_to_torch(opt_np)["opt"]
    tt.state["ctrl"] = bridge.server_state_to_torch(
        {}, jax.tree.map(np.asarray, jt.state["ctrl"]))["ctrl"]
    jh = jt.run(jax_fed_data(jax_get_arch(SMOKE), **data_kw), **run_kw)
    th = tt.run(build_synthetic_fed_data(get_arch(SMOKE), **data_kw),
                **run_kw)
    assert [r["round"] for r in th] == [0, 1, 2]
    for jr, tr in zip(jh, th):
        assert set(tr) == set(jr) == {"round", "client_loss", "grad_norm",
                                      *META_KEYS}
        for k in set(jr) - {"round"}:
            assert abs(tr[k] - jr[k]) <= TOL_METRIC * abs(jr[k]), (k, tr, jr)
    for k in CTRL_KEYS:
        assert rel_err(tt.state["ctrl"][k],
                       np.asarray(jt.state["ctrl"][k])) <= TOL, k
    assert max_tree_rel_err(tt.state["params"],
                            jax_params_to_torch(jt.state["params"])) <= TOL
    for slot in ("m", "v"):
        if slot in jt.state["opt"]:
            assert rel_err(tt.state["opt"][slot][0],
                           np.asarray(jt.state["opt"][slot][0])) <= TOL


@pytest.mark.parametrize("case", ["vmap-sgd"])
def test_three_rounds_match_jax_trainer(case):
    three_rounds_match_jax_trainer(case)
