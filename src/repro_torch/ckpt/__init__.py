"""Checkpoints (mirrors ``repro/ckpt``): atomic, checksummed param
trees, written synchronously (``save``) or on a background thread
(``AsyncCheckpointer``)."""

from repro_torch.ckpt.checkpoint import (AsyncCheckpointer, latest_step,
                                         restore, save)

__all__ = ["AsyncCheckpointer", "latest_step", "restore", "save"]
