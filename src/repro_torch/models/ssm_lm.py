"""SSM language models: mamba2-130m (pure SSM) and zamba2-2.7b (hybrid)
(port of ``repro/models/ssm_lm.py``).

zamba2 style: a stack of mamba2 blocks with ONE shared transformer block
(attention + MLP, parameters reused at every application site) applied
after every ``hybrid_attn_every`` mamba layers.  Each application site
keeps its own KV cache; the shared block takes concat(h, h0) through an
input projection (zamba's global skip to the embeddings).  Both end in
the paper's Bayesian head, served as the transformer's is
(``transformer.apply_bayes_head``: on the card ``bayes_mvm.cu`` rank16).

The decode cache is {"ssm": [L, B, H, P, N] float32, "conv": [L, B,
conv_dim, K−1] (cfg.dtype after a prefill, float32 after a decode step,
as the reference's), "pos": a host int, "start": [B] int32 (left-padded
admissions)} and, for the hybrid, "k", "v": [sites, B, Sc, Hkv, dh] in
cfg.dtype.  As in the reference, a left-padded prompt's pad tokens run
through the recurrence (the SSM state absorbs them) and through the
shared block's prefill attention, which is not masked by ``start``
(ROADMAP C26: faults of the reference that the port matches); decode
masks the pad through ``start``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import bayes_layer
from repro_torch.models import blocks
from repro_torch.models import transformer as tr
from repro_torch.models.mamba2 import (init_mamba_stack, mamba_block_decode,
                                       mamba_block_full)


def init_ssm_lm(generator: torch.Generator, cfg) -> dict:
    """Random params in the reference's tree: embed, mamba (stacked on
    the layer axis), final_norm, the hybrid's shared_attn (one block, no
    layer axis), shared_w_in [2D, D] and shared_w_out [D, D], and the
    head; the reference's scales, the port's own draws."""
    dev, d = generator.device, cfg.d_model
    params: dict = {
        "embed": blocks.embed_init(generator, cfg.vocab_padded, d),
        "mamba": init_mamba_stack(generator, cfg, cfg.n_layers),
        "final_norm": torch.ones((d,), device=dev),
    }
    if cfg.hybrid_attn_every:
        params["shared_attn"] = tr._init_block(generator, cfg)
        params["shared_w_in"] = blocks.dense_init(generator, 2 * d, d)
        params["shared_w_out"] = blocks.dense_init(generator, d, d)
    if cfg.bayesian_head:
        params["head"] = bayes_layer.init(generator, cfg.head_bayes_cfg(),
                                          device=dev)
    else:
        params["head"] = {"w": blocks.dense_init(generator, d,
                                                 cfg.vocab_padded)}
    return params


def _shared_block_full(h, h0, params: dict, cfg, positions):
    u = torch.cat([h, h0], dim=-1) @ params["shared_w_in"].to(h.dtype)
    u, _, kv, _ = tr._block_full(u, params["shared_attn"], cfg, positions,
                              causal=True)
    return h + u @ params["shared_w_out"].to(h.dtype), kv


def _shared_block_decode(h, h0, params: dict, cfg, ck, cv, pos: int,
                         start=None):
    """The shared block for one token against its site's KV cache
    (written in place at ``pos``)."""
    u = torch.cat([h, h0], dim=-1) @ params["shared_w_in"].to(h.dtype)
    u, ck, cv = tr._block_decode(u, params["shared_attn"], cfg, ck, cv, pos,
                                 rolling=False, start=start)
    return h + u @ params["shared_w_out"].to(h.dtype), ck, cv


def _is_site(cfg, l: int) -> bool:
    """Whether the shared block follows mamba layer ``l``."""
    every = cfg.hybrid_attn_every
    return bool(every) and (l + 1) % every == 0


def trunk_forward_ssm(params: dict, tokens, cfg,
                      collect_cache: bool = False):
    """tokens [B, S] -> (hidden [B, S, D], aux 0, caches or None):
    ``collect_cache`` gives {"ssm", "conv"} stacked over the layers and,
    for the hybrid, {"k", "v"} [sites, B, S, Hkv, dh]."""
    b, s = tokens.shape
    h = tr._embed(params, tokens, cfg)
    h0 = h
    positions = torch.arange(s, dtype=torch.int32,
                             device=h.device)[None].expand(b, s)
    ssm, conv, ks, vs = [], [], [], []
    for l in range(cfg.n_layers):
        out, (st, cst) = mamba_block_full(h, tr._layer(params["mamba"], l),
                                          cfg)
        h = h + out
        if collect_cache:
            ssm.append(st)
            conv.append(cst)
        if _is_site(cfg, l):
            h, (k, v) = _shared_block_full(h, h0, params, cfg, positions)
            if collect_cache:
                ks.append(k)
                vs.append(v)
    caches = None
    if collect_cache:
        caches = {"ssm": torch.stack(ssm), "conv": torch.stack(conv)}
        if ks:
            caches["k"], caches["v"] = torch.stack(ks), torch.stack(vs)
    h = blocks.rms_norm(h, params["final_norm"])
    return h, torch.zeros((), dtype=torch.float32, device=h.device), caches


def train_loss_ssm(params, batch, cfg, step=0):
    """The SSM LMs' training loss waits for the LM trainer (ROADMAP
    A14)."""
    raise NotImplementedError(
        "the SSM LM training loss is not ported yet (ROADMAP A14: the LM "
        "trainer, launch/train and launch/steps)")


def prefill_ssm(params: dict, tokens, cfg, *, cache_len: int,
                prompt_lengths=None):
    """Run the prompt (S a multiple of ``cfg.ssm_chunk``) and build the
    decode cache.  -> (cache, last-position hidden [B, D]).  The SSM
    state is O(1) in length; the hybrid's sites keep KV caches of
    ``cache_len`` (the prompt's last entries, or zero-padded after it).
    ``prompt_lengths`` [B] (left-padded admission) is recorded as the
    per-slot ``start`` (S − length, not shifted when the prompt is
    longer than the cache, as the reference's); the pad tokens still run
    through the recurrence and the shared block's prefill attention (the
    module docstring)."""
    b, s = tokens.shape
    h, _, caches = trunk_forward_ssm(params, tokens, cfg, collect_cache=True)
    cache = {"ssm": caches["ssm"], "conv": caches["conv"], "pos": s}
    if prompt_lengths is not None:
        lengths = torch.as_tensor(prompt_lengths, device=tokens.device)
        cache["start"] = (s - lengths).to(torch.int32)
    if "k" in caches:
        def fit(x):  # [sites, B, S, Hkv, dh] -> [sites, B, Sc, Hkv, dh]
            if s >= cache_len:
                return x[:, :, s - cache_len:].contiguous()
            return F.pad(x, (0, 0, 0, 0, 0, cache_len - s))

        cache["k"], cache["v"] = fit(caches["k"]), fit(caches["v"])
    return cache, h[:, -1]


def decode_hidden_ssm(params: dict, cache: dict, token, cfg):
    """One trunk decode step without the Bayesian head: token [B, 1] ->
    (last hidden [B, D], new cache): new ssm/conv states, the hybrid's
    k/v a copy with this step's entries written at ``pos`` (``start``
    masks each slot's pad), ``pos`` advanced by one.  The SSM state is
    slot-local, so the engine's admission copies its rows as they are."""
    pos = int(cache["pos"])
    start = cache.get("start")
    h = tr._embed(params, token, cfg)                          # [B, 1, D]
    h0 = h
    hybrid = bool(cfg.hybrid_attn_every)
    if hybrid:
        new_k, new_v = cache["k"].clone(), cache["v"].clone()
    ssm, conv = [], []
    for l in range(cfg.n_layers):
        out, (st, cst) = mamba_block_decode(
            h, tr._layer(params["mamba"], l), cfg, cache["ssm"][l],
            cache["conv"][l])
        h = h + out
        ssm.append(st)
        conv.append(cst)
        if _is_site(cfg, l):
            site = l // cfg.hybrid_attn_every
            h, _, _ = _shared_block_decode(h, h0, params, cfg, new_k[site],
                                           new_v[site], pos, start=start)
    new_cache = dict(cache, ssm=torch.stack(ssm), conv=torch.stack(conv),
                     pos=pos + 1)
    if hybrid:
        new_cache.update(k=new_k, v=new_v)
    h = blocks.rms_norm(h, params["final_norm"])
    return h[:, 0], new_cache


def decode_step_ssm(params: dict, cache: dict, token, cfg):
    """One decode step: token [B, 1] -> (logit samples [R, B, Vp], new
    cache); the head's selections are indexed by decode position, as
    the transformer's."""
    pos = int(cache["pos"])
    x, new_cache = decode_hidden_ssm(params, cache, token, cfg)
    return tr.apply_bayes_head(params, x, cfg, pos), new_cache
