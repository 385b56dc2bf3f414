"""The buffered-async runtime on the sharded executor: refused with the
JAX package's ValueError at every model-axis size.  JAX's
``make_federated_round`` refuses an async engine beside
``grad_shardings`` (its replicated delta pool, per-client staleness
slots), and its ``--executor sharded`` always sets them, so JAX runs the
runtime on no mesh; the port refuses the same, before any process group
starts, and from ``make_federated_round`` given a mesh.
"""
import pytest
import torch

import _torch_parity  # noqa: F401  (one torch thread)
from repro_torch.launch.train import main, run_training

POOL = "replicated delta pool"
KW = dict(rounds=1, cohort=2, client_batch=4, seq=8, executor="sharded",
          engine="buffered_async", fused=True)


@pytest.mark.parametrize("mesh_model", [1, 2])
def test_run_training_refuses_async_on_the_sharded_executor(mesh_model):
    with pytest.raises(ValueError, match=POOL):
        run_training("smollm-360m-smoke", mesh_model=mesh_model,
                     device="cpu", **KW)
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("mesh_model", ["1", "2"])
def test_the_cli_refuses_async_on_the_sharded_executor(mesh_model):
    with pytest.raises(ValueError, match=POOL):
        main(["--arch", "smollm-360m-smoke", "--fused", "--rounds", "1",
              "--cohort", "2", "--client-batch", "4", "--seq", "8",
              "--device", "cpu", "--executor", "sharded", "--mesh-model",
              mesh_model, "--engine", "buffered_async"])


def test_jax_refuses_it_too():
    """The reference: JAX's run_training with --executor sharded (a mesh
    of the one CPU device) raises its ValueError naming the pool."""
    from repro.launch.train import run_training as jax_run_training
    with pytest.raises(ValueError, match=POOL):
        jax_run_training("smollm-360m-smoke", mesh_model=1, **KW)


def test_make_federated_round_refuses_a_mesh():
    from repro_torch.configs import FedConfig, get_arch
    from repro_torch.core.round import make_federated_round
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.model import build_model
    fed = FedConfig(algorithm="uga", cohort=2, engine="buffered_async",
                    fused_update=True)
    try:
        mesh = make_debug_mesh(1, 1, device="cpu")
        with pytest.raises(ValueError, match=POOL):
            make_federated_round(build_model(get_arch("smollm-360m-smoke")),
                                 fed, mesh=mesh)
    finally:
        torch.distributed.destroy_process_group()
