from repro_torch.optim.optimizers import adam_init, adam_step, sgd_step
from repro_torch.optim.schedules import (constant, cosine, linear_scaling_lr,
                                         wsd_schedule)

__all__ = ["constant", "cosine", "wsd_schedule", "linear_scaling_lr",
           "adam_init", "adam_step", "sgd_step"]
