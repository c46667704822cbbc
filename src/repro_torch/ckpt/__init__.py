"""Checkpoints (mirrors ``repro/ckpt``): atomic, checksummed param
trees.  ``AsyncCheckpointer`` belongs to the LM trainer, not ported."""

from repro_torch.ckpt.checkpoint import latest_step, restore, save

__all__ = ["latest_step", "restore", "save"]
