"""LR schedules (``repro/optim/schedules.py``): each returns ``f(step) ->
lr``, a float computed in fp32 as the JAX schedules compute it.  Includes
WSD (warmup-stable-decay), MiniCPM's [arXiv:2404.06395], and the
linear-scaling rule [Goyal et al., 2017] the paper applies for different
local batch sizes B (§4.2.3)."""
from __future__ import annotations

import numpy as np

_f32 = np.float32


def constant(lr: float):
    return lambda step: float(_f32(lr))


def cosine(lr: float, total_steps: int, warmup: int = 0,
           final_frac: float = 0.1):
    def f(step):
        step = _f32(step)
        warm = min(step / _f32(max(warmup, 1)), _f32(1.0))
        prog = np.clip((step - _f32(warmup))
                       / _f32(max(total_steps - warmup, 1)), _f32(0.0),
                       _f32(1.0))
        cos = _f32(final_frac) + (_f32(1) - _f32(final_frac)) * _f32(0.5) \
            * (_f32(1) + np.cos(_f32(np.pi) * prog))
        return float(_f32(lr) * warm * cos)
    return f


def wsd_schedule(lr: float, total_steps: int, warmup_frac: float = 0.01,
                 decay_frac: float = 0.1, final_frac: float = 0.01):
    """Warmup-Stable-Decay: linear warmup, long flat stage, sharp decay
    tail — MiniCPM's schedule."""
    warm = max(int(total_steps * warmup_frac), 1)
    decay_start = int(total_steps * (1 - decay_frac))

    def f(step):
        step = _f32(step)
        w = min(step / _f32(warm), _f32(1.0))
        d = np.clip((step - _f32(decay_start))
                    / _f32(max(total_steps - decay_start, 1)), _f32(0.0),
                    _f32(1.0))
        return float(_f32(lr) * w * (_f32(1.0) - (_f32(1.0)
                                                  - _f32(final_frac)) * d))
    return f


def linear_scaling_lr(base_lr: float, batch: int, base_batch: int = 64
                      ) -> float:
    """lr ~ B (Goyal et al., 2017), as the paper uses for different B."""
    return base_lr * batch / base_batch
