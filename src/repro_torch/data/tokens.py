"""Deterministic synthetic token pipeline (port of
``repro/data/tokens.py``).

Every batch is a pure function of (seed, step): a ``torch.Generator``
seeded with the 32-bit ``core/hashing.hash2(step, seed)`` draws it (the
CPU generator keeps 32 bits of its seed), so a restart at step k sees the
batches a run that never stopped would have seen.  The synthetic
language is the reference's noisy affine bigram: next = (a·tok + c) mod
V in int32 arithmetic (the product wraps at 2³², as the reference's
int32 product does, then the remainder is taken as a floor modulus),
and with probability ``noise`` a uniform random token instead.  The
draws are the port's own, not JAX's threefry: the structure is the
reference's, the tokens are not.  The stub audio-frontend frames and
vision patch embeddings (``stub_frames``, ``stub_image_embeds``) are
standard normal float32 [B, n, d], drawn the same way from (seed, salt,
step) with a salt each.  ``host_shard`` waits for the LM trainer
(ROADMAP A14).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.hashing import hash2


@dataclasses.dataclass(frozen=True)
class TokenPipelineConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    noise: float = 0.1        # fraction of random transitions
    a: int = 31337            # bigram multiplier
    c: int = 17               # bigram offset


_SALT = 0x70C5
_FRAMES_SALT = 0xF0
_IMAGE_SALT = 0xF1


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values reduced to int32 two's complement (as an int32
    product overflows)."""
    return ((x + 2**31) % 2**32) - 2**31


def bigram_next(cfg: TokenPipelineConfig, tok: torch.Tensor) -> torch.Tensor:
    """The noiseless successor of ``tok``: (a·tok + c) mod V, each step
    in int32 as the reference computes it."""
    return _wrap_i32(_wrap_i32(tok * cfg.a) + cfg.c) % cfg.vocab


def batch_at(cfg: TokenPipelineConfig, step: int, device=None) -> dict:
    """The batch at ``step``: {"tokens", "labels": int32 [B, S]}, labels
    the tokens shifted by one.  Drawn on the host, then moved."""
    gen = torch.Generator().manual_seed(
        int(hash2(int(step), int(cfg.seed), _SALT)))
    b, s, v = cfg.global_batch, cfg.seq_len, cfg.vocab
    start = torch.randint(0, v, (b,), generator=gen)
    noise_mask = torch.rand((b, s), generator=gen) < cfg.noise
    noise_tok = torch.randint(0, v, (b, s), generator=gen)
    seq = torch.empty((b, s), dtype=torch.int64)
    tok = start
    for t in range(s):
        tok = torch.where(noise_mask[:, t], noise_tok[:, t],
                          bigram_next(cfg, tok))
        seq[:, t] = tok
    tokens = torch.cat([start[:, None], seq[:, :-1]], dim=1)
    return {"tokens": tokens.to(torch.int32).to(device),
            "labels": seq.to(torch.int32).to(device)}


def batch_iterator(cfg: TokenPipelineConfig, start_step: int = 0,
                   device=None):
    step = start_step
    while True:
        yield step, batch_at(cfg, step, device)
        step += 1


def _stub_embeds(cfg: TokenPipelineConfig, salt: int, n: int, d_model: int,
                 step: int, batch: int, device) -> torch.Tensor:
    gen = torch.Generator().manual_seed(
        int(hash2(int(step), int(cfg.seed), salt)))
    return torch.randn((batch, n, d_model), generator=gen,
                       dtype=torch.float32).to(device)


def stub_frames(cfg: TokenPipelineConfig, n_frames: int, d_model: int,
                step: int, batch: int, device=None) -> torch.Tensor:
    """Stub audio-frontend frame embeddings [batch, n_frames, d_model]
    (whisper's frontend is a stub), float32 N(0, 1), a pure function of
    (seed, step).  Drawn on the host, then moved."""
    return _stub_embeds(cfg, _FRAMES_SALT, n_frames, d_model, step, batch,
                        device)


def stub_image_embeds(cfg: TokenPipelineConfig, n_tokens: int, d_model: int,
                      step: int, batch: int, device=None) -> torch.Tensor:
    """Stub vision-frontend patch embeddings [batch, n_tokens, d_model]
    (llama-3.2-vision's frontend is a stub), float32 N(0, 1), a pure
    function of (seed, step).  Drawn on the host, then moved."""
    return _stub_embeds(cfg, _IMAGE_SALT, n_tokens, d_model, step, batch,
                        device)
