"""Family dispatch: one API surface over the model families (port of
``repro/models/registry.py``).

Every family exposes init(generator, cfg) -> params, train_loss,
prefill(params, tokens, cfg, cache_len, ...), decode_step(params, cache,
token, cfg) and decode_hidden (the trunk-only decode the serving engine
samples adaptively).  The dense, MoE, audio and VLM families share
the transformer's (the audio family's prefill takes ``frames``, the
VLM's ``image_embeds``: ``needs_frames``/``needs_images``), the SSM and
hybrid families ``ssm_lm``'s.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.models import ssm_lm, transformer
from repro_torch.models.transformer import ModelConfig

@dataclasses.dataclass(frozen=True)
class ModelAPI:
    init: Callable
    train_loss: Callable
    prefill: Callable
    decode_step: Callable
    decode_hidden: Callable = None   # trunk-only decode (serving engine)
    needs_frames: bool = False
    needs_images: bool = False


def get_api(cfg: ModelConfig) -> ModelAPI:
    if cfg.family in ("ssm", "hybrid"):
        return ModelAPI(
            init=ssm_lm.init_ssm_lm,
            train_loss=ssm_lm.train_loss_ssm,
            prefill=ssm_lm.prefill_ssm,
            decode_step=ssm_lm.decode_step_ssm,
            decode_hidden=ssm_lm.decode_hidden_ssm,
        )
    if cfg.family not in ("dense", "moe", "audio", "vlm"):
        raise ValueError(f"unknown model family {cfg.family!r}")
    return ModelAPI(
        init=transformer.init_transformer,
        train_loss=transformer.train_loss,
        prefill=transformer.prefill,
        decode_step=transformer.decode_step,
        decode_hidden=transformer.decode_hidden,
        needs_frames=cfg.family == "audio",
        needs_images=cfg.family == "vlm",
    )
