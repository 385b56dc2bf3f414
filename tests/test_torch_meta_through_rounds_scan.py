"""Controllable meta updating through the aggregation end to end, the
scan/adam case from a warm state: 3 rounds of the JAX ``FederatedTrainer``
against the port's, held as ``test_torch_meta_through_rounds.py`` holds
its vmap/sgd case."""
import pytest

from test_torch_meta_through_rounds import three_rounds_match_jax_trainer


@pytest.mark.parametrize("case", ["scan-adam-warm"])
def test_three_rounds_match_jax_trainer(case):
    three_rounds_match_jax_trainer(case)
