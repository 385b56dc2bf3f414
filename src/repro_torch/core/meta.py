"""FedMeta — controllable meta updating (§3.2), ``meta_mode='post'``
(PyTorch port of ``repro/core/meta.py::meta_update``): after aggregation
the server takes one gradient step on the curated meta set D_meta (Eq. 20).
The through-aggregation mode is ROADMAP Queue 1 item 1."""
from __future__ import annotations

from typing import Callable, Tuple

import torch
from torch.func import grad_and_value


def meta_update(loss_fn: Callable, params, meta_batch, meta_lr, rng=None
                ) -> Tuple[dict, torch.Tensor]:
    """w <- w - eta_meta * grad L(w; D_meta).  Returns (params, meta_loss)."""

    def obj(w):
        return loss_fn(w, meta_batch, rng)[0]

    g, meta_loss = grad_and_value(obj)(params)
    new = {k: (p.to(torch.float32) - meta_lr * g[k].to(torch.float32)
               ).to(p.dtype) for k, p in params.items()}
    return new, meta_loss
