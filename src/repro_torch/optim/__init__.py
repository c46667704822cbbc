"""Optimizers (mirrors ``repro/optim``): the reference's AdamW and its
LR schedule.  ``compression.py`` belongs to the LM trainer, not ported.
"""

from repro_torch.optim.adamw import (AdamWConfig, adamw_update, global_norm,
                                     init_opt_state)
from repro_torch.optim.schedules import warmup_cosine

__all__ = ["AdamWConfig", "adamw_update", "global_norm", "init_opt_state",
           "warmup_cosine"]
