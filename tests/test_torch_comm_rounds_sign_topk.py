"""The compressed uplink end to end, the sign1bit and topk cases: 3 rounds
of the JAX ``FederatedTrainer`` against the port's trainer, held as
``test_torch_comm_rounds.py`` holds its int8 cases (its docstring gives
the flip-aware criterion)."""
import pytest

from test_torch_comm_rounds import three_rounds_match_jax_trainer


@pytest.mark.parametrize("case", ["sign1bitef-vmap-sgd", "topk-scan-sgd"])
def test_three_rounds_match_jax_trainer(case):
    three_rounds_match_jax_trainer(case)
