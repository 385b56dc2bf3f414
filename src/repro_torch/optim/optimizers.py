"""Plain (non-federated) optimizers on the port's flat parameter dicts, as
``repro/optim/optimizers.py`` computes them: the update in fp32, cast back
to each parameter's dtype.  Out of place, so ``torch.func`` can
differentiate through them."""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

Params = Dict[str, torch.Tensor]


def sgd_step(params: Params, grads: Params, lr) -> Params:
    return {k: (p.to(torch.float32) - lr * grads[k].to(torch.float32)
                ).to(p.dtype) for k, p in params.items()}


def adam_init(params: Params) -> Dict[str, Any]:
    """Zero fp32 moments and the step count t = 0."""
    z = lambda: {k: torch.zeros_like(p, dtype=torch.float32)
                 for k, p in params.items()}
    return {"m": z(), "v": z(), "t": 0}


def adam_step(params: Params, grads: Params, state: Dict[str, Any], lr, *,
              b1=0.9, b2=0.999, eps=1e-8) -> Tuple[Params, Dict[str, Any]]:
    """One bias-corrected Adam step; the corrections 1 - b^t in fp32, as
    JAX computes them from its int32 step count."""
    t = int(state["t"]) + 1
    tf = np.float32(t)
    bc1 = float(np.float32(1) - np.float32(b1) ** tf)
    bc2 = float(np.float32(1) - np.float32(b2) ** tf)
    m, v, new = {}, {}, {}
    for k, p in params.items():
        g = grads[k].to(torch.float32)
        m[k] = b1 * state["m"][k] + (1 - b1) * g
        v[k] = b2 * state["v"][k] + (1 - b2) * g * g
        new[k] = (p.to(torch.float32) - lr * (m[k] / bc1)
                  / (torch.sqrt(v[k] / bc2) + eps)).to(p.dtype)
    return new, {"m": m, "v": v, "t": t}
