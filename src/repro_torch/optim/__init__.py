"""Optimizers and learning-rate schedules of the port (``repro/optim``)."""
from repro_torch.optim.optimizers import (OptState, adamw, apply_updates,
                                          init_opt_state, momentum_sgd, sgd)
from repro_torch.optim.schedules import (cosine_schedule, get_schedule,
                                         wsd_schedule)

__all__ = ["OptState", "adamw", "apply_updates", "init_opt_state",
           "momentum_sgd", "sgd", "cosine_schedule", "get_schedule",
           "wsd_schedule"]
