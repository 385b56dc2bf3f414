"""FedAgg-style adaptive per-client aggregation weights (arXiv:2303.15799)
as a one-file ClientAlgorithm plugin for the PyTorch port — the FedAgg of
``examples/plugins/fedagg.py``, written against ``repro_torch``, with no
edit to the port's core.

FedAgg adapts each client's aggregation weight to how far its local model
has drifted from the global one, damping divergent (non-IID / noisy)
clients instead of trusting raw sample counts.  The registries aggregate
``G_k`` under fixed ``n_k`` weights, so the adaptive weight folds into the
update itself: the client rescales its pseudo-gradient by

    a_k = 1 / (1 + ALPHA * ||w_t - w_k||)

— a per-client trust coefficient computable locally, so the scheme stays
one-round.  The weighted mean of ``a_k * G_k`` under ``n_k`` is the
adaptive-weight aggregate up to the shared normalization.

Run it from the CLI (``--plugin`` imports this module before
``--algorithm``'s choices are read), with any cohort executor, server
engine and gradient codec — e.g. under an int8 uplink with error
feedback on the CPU:

  PYTHONPATH=src:. python -m repro_torch.launch.train \\
      --plugin examples.plugins.fedagg_torch --algorithm fedagg \\
      --arch smollm-360m-smoke --rounds 3 --cohort 2 --client-batch 4 \\
      --seq 32 --no-meta --fused --codec int8 --error-feedback --device cpu
"""
from functools import partial

import torch

from repro_torch.core.algorithms import register_algorithm
from repro_torch.core.client import fedavg_update

# drift-damping strength: a_k = 1 / (1 + ALPHA * ||delta_k||); 0 recovers
# fedavg exactly
ALPHA = 1.0


def fedagg_update(loss_fn, w_t, batch, lr, rng=None, *, local_steps=2,
                  local_epochs=1, prox_mu=0.0):
    pseudo, loss = fedavg_update(loss_fn, w_t, batch, lr, rng,
                                 local_steps=local_steps,
                                 local_epochs=local_epochs, prox_mu=prox_mu)
    # pseudo = w_t - w_k, so its norm is the local drift ||w_t - w_k||
    drift = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                           for g in pseudo.values()))
    a_k = 1.0 / (1.0 + ALPHA * drift)
    return {k: a_k * g for k, g in pseudo.items()}, loss


@register_algorithm("fedagg", pseudo_gradient=True,
                    description="adaptive drift-damped per-client weights "
                                "(FedAgg, arXiv:2303.15799)")
def build_fedagg(loss_fn, *, local_steps, local_epochs, prox_mu):
    return partial(fedagg_update, loss_fn, local_steps=local_steps,
                   local_epochs=local_epochs, prox_mu=prox_mu)
