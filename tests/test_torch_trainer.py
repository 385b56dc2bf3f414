"""The slice end to end: 3 rounds of the JAX ``FederatedTrainer`` against
the port's trainer — same data seed, same bridged init, fused engine,
UGA + FedMeta (``meta_mode='post'``) — at smoke size.

Tolerances are the JAX suite's across engines: history metrics <= 1e-4
relative, parameters <= 1e-5 (max |a-b| over max |b| per leaf).

Adam from a cold start (t = 1, m = v = 0) steps by about lr * sign(G)
wherever |G| is near eps, so the entries of G that are zero up to fp32
rounding flip the sign of their step with the summation order — in any two
implementations (the caveat ``tests/test_fused_update.py`` documents for
adam/yogi).  The cold (scan, adam) run is therefore held to the history
tolerance, and the parameter comparison for adam runs from a warm state
(t = 5, random m, v > 0), as the JAX suite compares it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import SMOKE, jax_params_to_torch, max_tree_rel_err
from repro.configs import FedConfig as JaxFedConfig
from repro.configs import get_arch as jax_get_arch
from repro.core import FederatedTrainer as JaxTrainer
from repro.launch.train import build_synthetic_fed_data as jax_fed_data
from repro.models.model import build_model as jax_build_model
from repro_torch.configs import FedConfig, get_arch
from repro_torch.core.trainer import FederatedTrainer
from repro_torch.launch.train import build_synthetic_fed_data
from repro_torch.models.model import build_model

ROUNDS, COHORT, BATCH, SEQ = 3, 2, 4, 32


def _warm_state(rows):
    rng = np.random.default_rng(5)
    m = (0.01 * rng.standard_normal((rows, 128))).astype(np.float32)
    v = (1e-3 * rng.random((rows, 128)) + 1e-4).astype(np.float32)
    return m, v


@pytest.mark.parametrize("strategy,opt,warm", [
    ("vmap", "sgd", False), ("scan", "adam", False), ("scan", "adam", True),
], ids=["vmap-sgd", "scan-adam-cold", "scan-adam-warm"])
def test_three_rounds_match_jax_trainer(strategy, opt, warm):
    kw = dict(algorithm="uga", meta=True, cohort=COHORT, local_steps=2,
              client_lr=0.01, server_lr=0.01, meta_lr=0.01, server_opt=opt,
              cohort_strategy=strategy, lr_decay=0.992, fused_update=True)
    data_kw = dict(num_clients=8, examples=64, seq=SEQ, iid=False, seed=0)
    run_kw = dict(rounds=ROUNDS, cohort=COHORT, batch=BATCH,
                  meta_batch=2 * BATCH)

    jt = JaxTrainer(jax_build_model(jax_get_arch(SMOKE), dtype=jnp.float32,
                                    loss_chunk=256),
                    JaxFedConfig(**kw), seed=0)
    p0 = jax_params_to_torch(jt.state["params"])
    tt = FederatedTrainer(build_model(get_arch(SMOKE), loss_chunk=256),
                          FedConfig(**kw), device="cpu", params=p0)
    if warm:
        m, v = _warm_state(jt.state["opt"]["m"][0].shape[0])
        jt.state["opt"] = {"m": (jnp.asarray(m),), "v": (jnp.asarray(v),),
                           "t": jnp.asarray(5, jnp.int32)}
        tt.state["opt"] = {"m": (torch.from_numpy(m),),
                           "v": (torch.from_numpy(v),),
                           "t": torch.tensor(5, dtype=torch.int32)}
    jh = jt.run(jax_fed_data(jax_get_arch(SMOKE), **data_kw), **run_kw)
    th = tt.run(build_synthetic_fed_data(get_arch(SMOKE), **data_kw),
                **run_kw)

    assert [r["round"] for r in th] == list(range(ROUNDS))
    for jr, tr in zip(jh, th):
        assert set(tr) == set(jr) == {"round", "client_loss", "grad_norm",
                                      "meta_loss"}
        for k in ("client_loss", "grad_norm", "meta_loss"):
            assert abs(tr[k] - jr[k]) <= 1e-4 * abs(jr[k]), (tr, jr)
    if opt == "adam" and not warm:
        return
    assert max_tree_rel_err(tt.state["params"],
                            jax_params_to_torch(jt.state["params"])) <= 1e-5
    for slot in ("m", "v"):
        if slot in jt.state["opt"]:
            assert max_tree_rel_err(
                {"x": tt.state["opt"][slot][0]},
                {"x": np.asarray(jt.state["opt"][slot][0])}) <= 1e-5
