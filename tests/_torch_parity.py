"""Shared helpers of the PyTorch-port parity tests (``test_torch_*.py``).

Inputs are made once with numpy and handed to both packages; JAX runs on
the CPU as in the rest of the suite.  ``rel_err`` is the tolerance metric
the port's tests state: max |a - b| over max |b|, per array.  (The
element-wise form, dividing by |b| + 1e-6, is dominated by entries within
fp32 rounding of zero once a deep model sums in another order.)
"""
import numpy as np
import torch

SMOKE = "smollm-360m-smoke"


def rel_err(a, b) -> float:
    a = np.asarray(a.detach().cpu() if isinstance(a, torch.Tensor) else a,
                   np.float64)
    b = np.asarray(b.detach().cpu() if isinstance(b, torch.Tensor) else b,
                   np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = np.max(np.abs(b)) if b.size else 0.0
    return float(np.max(np.abs(a - b)) / max(scale, 1e-30)) if b.size else 0.0


def max_tree_rel_err(port: dict, ref: dict) -> float:
    """Worst per-leaf ``rel_err`` between two flat dicts of arrays."""
    assert set(port) == set(ref), (sorted(port), sorted(ref))
    return max(rel_err(port[k], ref[k]) for k in ref)


def jax_params_to_torch(tree):
    import jax
    from repro_torch import bridge
    return bridge.to_torch(jax.tree.map(np.asarray, tree))
