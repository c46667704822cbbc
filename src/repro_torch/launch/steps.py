"""Step builders: train, prefill and decode (port of
``repro/launch/steps.py``).

``make_train_step`` is the reference's step as a plain function on one
card: the gradients of ``get_api(cfg).train_loss`` (autograd; with
``microbatches`` > 1 accumulated in float32 over the batch's slices,
each slice's activations freed before the next), the warmup-cosine LR
and the reference's AdamW.  The step takes the step count from the
host (``step``): the reference reads ``opt_state["count"]`` inside its
jitted step, which on the card would cost a device-to-host read a
step.  ``shape_adjusted_config`` and ``input_specs`` (as shapes and
dtypes) size a cell; ``make_prefill_step`` and ``make_decode_step`` are
the serving steps.

What has no twin on one card: ``mesh_hinted_config`` and the
``jit_train_step``/``jit_prefill_step``/``jit_decode_step`` builders
place a step's inputs and outputs over a device mesh (they wait for
more than one GPU, ROADMAP A10b); ``abstract_params`` and
``abstract_cache`` are ``jax.eval_shape`` stand-ins for the reference's
multi-pod dry run, which lowers and costs XLA programs and has nothing
to lower here.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch import float32_math
from repro_torch.models.registry import get_api
from repro_torch.models.transformer import ModelConfig, apply_bayes_head
from repro_torch.optim import AdamWConfig, adamw_update, warmup_cosine
from repro_torch.utils.trees import leaves, tree_map, unflatten_like


class TensorSpec(NamedTuple):
    shape: tuple
    dtype: torch.dtype


def shape_adjusted_config(cfg: ModelConfig, seq_len: int) -> ModelConfig:
    """A cell's config: a learned position table (whisper) grown to
    seq_len + 1 rows where it is shorter."""
    if cfg.learned_pos and cfg.learned_pos < seq_len + 1:
        cfg = dataclasses.replace(cfg, learned_pos=seq_len + 1)
    return cfg


def input_specs(cfg: ModelConfig, seq_len: int, global_batch: int,
                kind: str) -> dict:
    """The model inputs of one (arch × shape) cell as {name:
    TensorSpec}: tokens (and labels to train) int32 [B, S] ([B, 1] to
    decode), and the audio family's frames / the VLM's image embeddings
    in bfloat16."""
    b, s = global_batch, seq_len
    if kind == "train":
        batch = {"tokens": TensorSpec((b, s), torch.int32),
                 "labels": TensorSpec((b, s), torch.int32)}
    elif kind == "prefill":
        batch = {"tokens": TensorSpec((b, s), torch.int32)}
    elif kind == "decode":
        batch = {"tokens": TensorSpec((b, 1), torch.int32)}
    else:
        raise ValueError(kind)
    if cfg.family == "audio":
        batch["frames"] = TensorSpec((b, cfg.n_frames, cfg.d_model),
                                     torch.bfloat16)
    if cfg.family == "vlm":
        batch["image_embeds"] = TensorSpec(
            (b, cfg.n_image_tokens, cfg.d_model), torch.bfloat16)
    return batch


def loss_and_grads(cfg: ModelConfig, params, batch: dict, step: int):
    """``get_api(cfg).train_loss`` at stream offset ``step`` and its
    gradients -> (loss, metrics, grads like ``params``), detached.  A
    leaf the loss does not reach gets a zero gradient, as JAX gives it.
    """
    p = tree_map(lambda x: x.detach().requires_grad_(), params)
    loss, metrics = get_api(cfg).train_loss(p, batch, cfg, step=step)
    flat = leaves(p)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(flat, grads)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            unflatten_like(params, grads))


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    total_steps: int = 10000, warmup_steps: int = 200,
                    microbatches: int = 1):
    """-> train_step(params, opt_state, batch, step) -> (params,
    opt_state, metrics {ce, kl, aux, loss, grad_norm, lr}).

    ``step`` is the host's count of steps taken (``opt_state["count"]``
    on the device).  With ``microbatches`` > 1 the batch's leading axis
    is cut into that many slices: their gradients are summed in float32
    and divided by the count, as is the loss; ce/kl/aux are the last
    slice's, in float32.  The products run in float32 (bfloat16 products
    reduce in float32): ``float32_math``."""

    def train_step(params, opt_state, batch: dict, step: int):
        with float32_math():
            if microbatches == 1:
                loss, metrics, grads = loss_and_grads(cfg, params, batch,
                                                      step)
            else:
                acc = [torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device) for p in leaves(params)]
                loss_sum = torch.zeros((), dtype=torch.float32,
                                       device=acc[0].device)
                slices = {k: v.reshape(microbatches,
                                       v.shape[0] // microbatches,
                                       *v.shape[1:])
                          for k, v in batch.items()}
                for i in range(microbatches):
                    loss, metrics, g = loss_and_grads(
                        cfg, params, {k: v[i] for k, v in slices.items()},
                        step)
                    metrics = {k: v.to(torch.float32)
                               for k, v in metrics.items()}
                    acc = [a + x.to(torch.float32)
                           for a, x in zip(acc, leaves(g))]
                    loss_sum = loss_sum + loss.to(torch.float32)
                grads = unflatten_like(params,
                                       [a / microbatches for a in acc])
                loss = loss_sum / microbatches
            lr_scale = warmup_cosine(step, warmup_steps=warmup_steps,
                                     total_steps=total_steps)
            params, opt_state, opt_metrics = adamw_update(
                params, grads, opt_state, opt_cfg, lr_scale)
        return params, opt_state, dict(metrics, loss=loss, **opt_metrics)

    return train_step


def make_prefill_step(cfg: ModelConfig, cache_len: int):
    """-> prefill_step(params, batch) -> (cache, logit samples [R, B,
    Vp] of the prompt's last position)."""
    api = get_api(cfg)

    def prefill_step(params, batch: dict):
        extras = {k: v for k, v in batch.items() if k != "tokens"}
        cache, last_h = api.prefill(params, batch["tokens"], cfg,
                                    cache_len=cache_len, **extras)
        return cache, apply_bayes_head(params, last_h, cfg, cache["pos"])

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """-> decode_step(params, cache, token) -> (logit samples, cache)."""
    api = get_api(cfg)

    def decode_step(params, cache: dict, token):
        return api.decode_step(params, cache, token, cfg)

    return decode_step
