"""Optimizers (mirrors ``repro/optim``): the reference's AdamW (with
its float32 master weights), its LR schedule and, in ``compression``,
int8 gradient compression with error feedback."""

from repro_torch.optim.adamw import (AdamWConfig, adamw_update, global_norm,
                                     init_opt_state)
from repro_torch.optim.schedules import warmup_cosine

__all__ = ["AdamWConfig", "adamw_update", "global_norm", "init_opt_state",
           "warmup_cosine"]
