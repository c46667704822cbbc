"""Decoder-only, encoder-decoder and cross-attention transformer LMs:
the dense, MoE, audio (whisper) and VLM (llama-3.2-vision) families
(port of ``repro/models/transformer.py``).

Pre-norm blocks over parameters stacked on a leading layer axis, as the
reference's ``lax.scan`` stacks are (``[L, d_in, d_out]`` float32 for
every layer leaf; an MoE block's ``moe`` leaves ``[L, E, ...]``); the
port loops over the layers.  The LM head is the paper's Bayesian
weight-decomposition layer (µ, ρ), served with CLT-GRNG sampling:
``decode_step``/``apply_bayes_head`` draw a fixed R through
``core/sampling.logit_samples`` (on the card, ``bayes_mvm.cu`` rank16),
and ``decode_hidden`` gives the trunk's hidden state alone, which the
serving engine samples adaptively.

An encoder-decoder config (whisper: ``encoder_layers``) runs a
non-causal encoder over its stub frame embeddings plus the encoder's
learned positions, and every decoder layer carries a cross-attention
sub-block (self-attention, then cross-attention, then the MLP) over the
encoder's output; its tokens take learned positions (``learned_pos``)
instead of RoPE.  A cross-attention config (llama-3.2-vision:
``cross_attn_every``) runs its self layers in groups of
``cross_attn_every``, each group followed by a dedicated cross layer
(with its own MLP) over the stub image embeddings.  Cross keys and
values come from the memory and are not rotated; decode reads them from
the cache's ``xk``/``xv`` at the last memory position, with no mask.

The SSM and hybrid families live in ``models/ssm_lm`` and reuse this
module's blocks (``_init_block``, ``_block_full``, ``_block_decode``)
for the hybrid's shared block.

Training: ``train_loss`` is next-token cross entropy plus the head's
KL (Bayes-by-backprop: ``head_logits_train`` draws the head's weights
once at the step's stream offset, ε through the GRNG ε kernel on the
card) plus the MoE aux loss.  ``cfg.remat`` is honoured as the
reference's ``_maybe_remat`` honours it, on every layer body of the
trunk and the encoder, whenever autograd records: ``full`` recomputes a
layer's forward in the backward (``torch.utils.checkpoint``), ``dots``
keeps the layer's matrix products without a batch axis (``aten.mm``,
as ``dots_with_no_batch_dims_saveable``) and recomputes the rest,
``none`` keeps everything.  Remat changes no value.

The mesh (``launch/steps``' mesh steps): a step builder hands the
trunk one data row's shard body at a time, its params ``Placed``
(``sharding/specs``) and bound to the row.  ``_layer`` gathers a
layer's placed leaves on the row's device, the FSDP all-gather GSPMD
does, except the leaves a sharded path reads piece by piece
(``sharded_leaf``): with the mesh hints ``batch_axes`` and
``model_axis_size`` > 1, ``_mlp_apply`` routes an MoE layer over a
sequence through ``models/moe.make_sharded_moe``, and with
``explicit_tp`` the helpers ``_tp_ok``/``_tp_linear`` run q, the
self-attention's output and a SwiGLU MLP Megatron-style over 'model'.
``_tp_ok`` reads the mesh from the placed weight (the port has no
ambient mesh).  ``_wsc`` (the reference's sharding constraint on
activations) has no effect on values and returns its input: a row body
holds its rows' activations whole.  Without a mesh nothing changes.

The decode cache is {"k", "v": [L, B, Sc, Hkv, dh] in cfg.dtype, "pos":
a host int (the pool clock: every position it sets is a launch-time
index, nothing is read back from the card), "start": [B] int32 first
valid positions (left-padded admissions)} and, for the cross-attention
families, "xk", "xv": [L (whisper) or G cross layers (VLM), B, Sm,
Hkv, dh], the memory's keys and values, slot-local.  A sliding-window
config whose cache is no longer than its window decodes through the
rolling cache (``models/attention``), as the reference's does, and then
ignores ``start`` as the reference does (ROADMAP C25).
"""

from __future__ import annotations

import dataclasses
import functools
import re
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt_util

from repro_torch.core import bayes_layer
from repro_torch.core.bayes_layer import BayesDenseConfig
from repro_torch.core.clt_grng import GRNGConfig
from repro_torch.core.hashing import as_u32
from repro_torch.core.lfsr import indexed_selections
from repro_torch.models import attention as attn
from repro_torch.models import blocks
from repro_torch.models.moe import init_moe, make_sharded_moe, moe_apply
from repro_torch.sharding.specs import P, Placed


# ----------------------------------------------------------------------
# Config
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"        # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 64
    d_ff: int = 1024
    vocab: int = 1024
    vocab_pad_multiple: int = 256
    norm: str = "rms"            # rms | ln
    mlp: str = "swiglu"          # swiglu | gelu
    use_rope: bool = True
    rope_theta: float = 1e6
    qk_norm: bool = False
    qkv_bias: bool = False
    swa_window: int | None = None
    learned_pos: int = 0         # >0: learned positional table size (whisper)
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    # SSM (mamba2 / zamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_ngroups: int = 1
    ssm_conv: int = 4
    ssm_chunk: int = 256
    hybrid_attn_every: int = 0   # zamba2: shared attn block every N ssm layers
    # enc-dec (whisper: encoder frames are a stubbed modality frontend)
    encoder_layers: int = 0
    n_frames: int = 0
    # vlm (llama-3.2-vision: patch embeds stubbed)
    cross_attn_every: int = 0
    n_image_tokens: int = 0
    # Paper technique: Bayesian LM head
    bayesian_head: bool = True
    uq_samples: int = 8
    head_mode: str = "rank16"    # paper | rank16 | moment
    sigma_init: float = 0.03
    prior_sigma: float = 0.1
    kl_weight: float = 1e-5
    # compute
    dtype: Any = torch.bfloat16
    remat: str = "full"          # full | dots | none
    attn_chunk_q: int = 512
    attn_chunk_kv: int = 1024
    # mesh hints (launch/steps.mesh_hinted_config)
    batch_axes: tuple = ()
    model_axis_size: int = 0
    explicit_tp: bool = False

    @property
    def vocab_padded(self) -> int:
        m = self.vocab_pad_multiple
        return -(-self.vocab // m) * m

    @property
    def grng(self) -> GRNGConfig:
        return GRNGConfig()

    def head_bayes_cfg(self) -> BayesDenseConfig:
        return BayesDenseConfig(
            d_in=self.d_model, d_out=self.vocab_padded,
            sigma_init=self.sigma_init, prior_sigma=self.prior_sigma,
            grng=self.grng)

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head µ+ρ)."""
        d, f, l = self.d_model, self.d_ff, self.n_layers
        hq = self.n_heads * self.head_dim
        hkv = self.n_kv_heads * self.head_dim
        attn_p = d * hq + 2 * d * hkv + hq * d
        if self.n_experts:
            mlp_p = self.n_experts * 3 * d * f + d * self.n_experts
        else:
            mlp_p = 3 * d * f if self.mlp == "swiglu" else 2 * d * f
        per_layer = attn_p + mlp_p + 2 * d
        total = l * per_layer + self.vocab_padded * d * 2
        if self.encoder_layers:
            total += self.encoder_layers * (attn_p + mlp_p + 2 * d)
            total += l * (attn_p + d)          # decoder xattn blocks
        if self.cross_attn_every:
            n_cross = l // self.cross_attn_every
            total += n_cross * (attn_p + mlp_p + 2 * d)
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top-k experts only)."""
        if not self.n_experts:
            return self.param_count()
        d, f, l = self.d_model, self.d_ff, self.n_layers
        hq = self.n_heads * self.head_dim
        hkv = self.n_kv_heads * self.head_dim
        attn_p = d * hq + 2 * d * hkv + hq * d
        mlp_p = self.top_k * 3 * d * f + d * self.n_experts
        return l * (attn_p + mlp_p + 2 * d) + self.vocab_padded * d * 2


# ----------------------------------------------------------------------
# Parameter init
# ----------------------------------------------------------------------
def _stack(generator, l: int, d_in: int, d_out: int) -> torch.Tensor:
    return torch.stack([blocks.dense_init(generator, d_in, d_out)
                        for _ in range(l)])


def _init_attn_block(generator, cfg: ModelConfig, l: int,
                     cross: bool = False) -> dict:
    """Attention projections of ``l`` layers; a cross block (``cross``)
    has no qkv bias, as the reference's."""
    d = cfg.d_model
    hq = cfg.n_heads * cfg.head_dim
    hkv = cfg.n_kv_heads * cfg.head_dim
    dev = generator.device
    p = {"wq": _stack(generator, l, d, hq),
         "wk": _stack(generator, l, d, hkv),
         "wv": _stack(generator, l, d, hkv),
         "wo": _stack(generator, l, hq, d)}
    if cfg.qkv_bias and not cross:
        p["bq"] = torch.zeros((l, hq), device=dev)
        p["bk"] = torch.zeros((l, hkv), device=dev)
        p["bv"] = torch.zeros((l, hkv), device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((l, cfg.head_dim), device=dev)
        p["k_norm"] = torch.ones((l, cfg.head_dim), device=dev)
    return p


def _init_mlp_block(generator, cfg: ModelConfig, l: int) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.mlp == "swiglu":
        return {"wi": _stack(generator, l, d, f),
                "wg": _stack(generator, l, d, f),
                "wo": _stack(generator, l, f, d)}
    dev = generator.device
    return {"wi": _stack(generator, l, d, f),
            "bi": torch.zeros((l, f), device=dev),
            "wo": _stack(generator, l, f, d),
            "bo": torch.zeros((l, d), device=dev)}


def _init_block_stack(generator, cfg: ModelConfig, l: int,
                      cross: bool = False, with_xattn: bool = False) -> dict:
    """``l`` blocks stacked on a leading layer axis: attention, norms
    (and their biases under layer norm), the MLP or, in an MoE config's
    self layers, ``moe`` from ``models/moe.init_moe``.  ``cross``: the
    VLM's cross layers (no qkv bias, a dense MLP); ``with_xattn``: an
    encoder-decoder's decoder layers, with the cross-attention
    sub-block ``xattn`` and its norm ``lnx`` (and ``lnx_b``)."""
    dev, d = generator.device, cfg.d_model
    p = {"attn": _init_attn_block(generator, cfg, l, cross),
         "ln1": torch.ones((l, d), device=dev),
         "ln2": torch.ones((l, d), device=dev)}
    if cfg.norm == "ln":
        p["ln1_b"] = torch.zeros((l, d), device=dev)
        p["ln2_b"] = torch.zeros((l, d), device=dev)
    if cfg.n_experts and not cross:
        p["moe"] = init_moe(generator, l, d, cfg.d_ff, cfg.n_experts)
    else:
        p["mlp"] = _init_mlp_block(generator, cfg, l)
    if with_xattn:
        p["xattn"] = _init_attn_block(generator, cfg, l, cross=True)
        p["lnx"] = torch.ones((l, d), device=dev)
        if cfg.norm == "ln":
            p["lnx_b"] = torch.zeros((l, d), device=dev)
    return p


def _init_block(generator, cfg: ModelConfig) -> dict:
    """One block with no layer axis, the hybrid's shared block: the
    reference's ``_init_block_stack(key, cfg, 1)`` with its stack axis
    dropped."""
    return _layer(_init_block_stack(generator, cfg, 1), 0)


def init_transformer(generator: torch.Generator, cfg: ModelConfig) -> dict:
    """Random params in the reference's tree and layout, drawn from
    ``generator`` on its device with the reference's scales (dense
    N(0, 1/d_in), embedding N(0, 0.02²), norms 1, biases 0, the head's
    µ N(0, 1/d_model) and ρ = softplus⁻¹(sigma_init); an MoE config's
    blocks hold ``moe`` in place of ``mlp``, from ``models/moe.init_moe``;
    learned position tables N(0, 0.02²): ``pos_embed`` [learned_pos, d]
    and the encoder's [n_frames, d]).  The draws are the port's own, not
    JAX's."""
    dev = generator.device
    l, d = cfg.n_layers, cfg.d_model
    params: dict = {
        "embed": blocks.embed_init(generator, cfg.vocab_padded, d),
        "blocks": _init_block_stack(generator, cfg, l,
                                    with_xattn=cfg.encoder_layers > 0),
        "final_norm": torch.ones((d,), device=dev),
    }
    if cfg.norm == "ln":
        params["final_norm_b"] = torch.zeros((d,), device=dev)
    if cfg.learned_pos:
        params["pos_embed"] = blocks.embed_init(generator, cfg.learned_pos,
                                                d)
    if cfg.encoder_layers:
        params["encoder"] = {
            "blocks": _init_block_stack(generator, cfg, cfg.encoder_layers),
            "final_norm": torch.ones((d,), device=dev),
            "final_norm_b": torch.zeros((d,), device=dev),
            "pos_embed": blocks.embed_init(generator, cfg.n_frames, d)}
    if cfg.cross_attn_every:
        params["blocks_cross"] = _init_block_stack(
            generator, cfg, l // cfg.cross_attn_every, cross=True)
    if cfg.bayesian_head:
        params["head"] = bayes_layer.init(generator, cfg.head_bayes_cfg(),
                                          device=dev)
    else:
        params["head"] = {"w": blocks.dense_init(generator, d,
                                                 cfg.vocab_padded)}
    return params


# ----------------------------------------------------------------------
# Remat
# ----------------------------------------------------------------------
_NO_BATCH_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """``dots``: keep the products without a batch axis, recompute the
    rest."""
    return (ckpt_util.CheckpointPolicy.MUST_SAVE if op in _NO_BATCH_DOTS
            else ckpt_util.CheckpointPolicy.PREFER_RECOMPUTE)


def _maybe_remat(fn, cfg: ModelConfig):
    """``fn`` under the config's remat policy (the reference's
    ``_maybe_remat``): checkpointed when autograd records and its first
    argument (the hidden state) carries a gradient, else ``fn`` itself,
    so serving never pays for it.  The bodies draw nothing at random, so
    no RNG state is stashed."""
    if cfg.remat == "none":
        return fn
    if cfg.remat not in ("full", "dots"):
        raise ValueError(f"unknown remat policy {cfg.remat!r}")
    context_fn = (functools.partial(
        ckpt_util.create_selective_checkpoint_contexts, _save_dots)
        if cfg.remat == "dots" else ckpt_util.noop_context_fn)

    def remat(h, *args):
        if not (torch.is_grad_enabled() and h.requires_grad):
            return fn(h, *args)
        return ckpt_util.checkpoint(fn, h, *args, use_reentrant=False,
                                    preserve_rng_state=False,
                                    context_fn=context_fn)
    return remat


# ----------------------------------------------------------------------
# Block applications
# ----------------------------------------------------------------------
def _layer(tree: dict, l: int) -> dict:
    """Layer ``l`` of a stacked block tree.  A placed leaf (a mesh
    step's row body) is gathered on its row's device, unless it is kept
    placed for a sharded path (``Placed.keep``: ``sharded_leaf``)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _layer(v, l)
        elif isinstance(v, Placed):
            out[k] = v.layer(l) if v.keep else v.layer(l).gather()
        else:
            out[k] = v[l]
    return out


# ----------------------------------------------------------------------
# The mesh: sharded leaves, constraints, tensor parallelism
# ----------------------------------------------------------------------
def sharded_leaf(cfg: ModelConfig, path: str) -> bool:
    """Whether a mesh step hands the param at ``path`` (slash path) to
    its row bodies placed rather than gathered: the MoE leaves when the
    sharded MoE can run (the mesh hints set, 'model' > 1), and with
    ``explicit_tp`` the linears the TP helpers read (every ``wq``, the
    self-attention's ``wo``, a SwiGLU MLP's ``wi``/``wg``/``wo``)."""
    hinted = bool(cfg.batch_axes) and cfg.model_axis_size > 1
    if re.search(r"(^|/)moe/(router|wi|wg|wo)$", path):
        return hinted
    if not (hinted and cfg.explicit_tp):
        return False
    return bool(re.search(r"(^|/)(wq|attn/wo)$", path) or (
        cfg.mlp == "swiglu" and re.search(r"(^|/)mlp/(wi|wg|wo)$", path)))


def _local(w):
    """A leaf kept placed where its sharded path does not run, gathered
    on its row's device; a tensor as it is."""
    return w.gather() if isinstance(w, Placed) else w


def _wsc(x, cfg: ModelConfig, *rest):
    """The reference's constraint of an activation to the DP axes (and
    ``rest``): placement only, so ``x`` itself here."""
    return x


def _model_ax(cfg: ModelConfig, dim: int):
    """'model' when the launcher told us the axis size divides ``dim``."""
    if cfg.model_axis_size and dim % cfg.model_axis_size == 0:
        return "model"
    return None


def _tp_ok(cfg: ModelConfig, w, d_in: int, d_out: int) -> bool:
    """Whether the explicit TP path takes weight ``w``: ``explicit_tp``
    with the mesh hints, ``w`` kept placed, and the 'model' size
    dividing ``d_out`` and the mesh's 'data' size ``d_in``."""
    if not (cfg.explicit_tp and cfg.batch_axes and cfg.model_axis_size > 1
            and isinstance(w, Placed)):
        return False
    data = w.mesh.shape.get("data", 1)
    return d_out % cfg.model_axis_size == 0 and d_in % data == 0


def _tp_linear(x, w: Placed, cfg: ModelConfig, kind: str):
    """Explicit tensor-parallel matmul (Megatron row/col parallel) in
    the row body of ``w``'s row, one product a 'model' coordinate on its
    device, each gathering its weight piece over 'data' (FSDP; the
    gradient's reduce-scatter by autograd).

    'col': w [D_in(fsdp:data), D_out(tp:model)]; coordinate j computes
           the j-th block of output columns, gathered on the row's
           device (the row body holds its activations whole).
    'row': w [D_in(tp:model), D_out(fsdp:data)]; coordinate j takes the
           j-th block of x's columns; the partials are added in x.dtype
           (one psum), as the reference's bf16 psum.
    """
    from repro_torch.launch.mesh import all_gather, psum
    mesh, row = w.mesh, w.row or 0
    n_data, n_model = mesh.shape["data"], mesh.shape["model"]
    home = x.device
    spec, axis = (P("data", "model"), 0) if kind == "col" else (
        P("model", "data"), 1)
    f = x.shape[-1] // n_model
    parts = []
    for j in range(n_model):
        dev = mesh.device((row, j))
        w_full = all_gather([w.block(spec, (i, j), dev)
                             for i in range(n_data)], mesh, "data", axis)
        x_j = x if kind == "col" else x.narrow(-1, j * f, f)
        parts.append(x_j.to(dev) @ w_full.to(x.dtype))
    if kind == "col":
        return torch.cat([y.to(home) for y in parts], -1)
    return psum(parts, mesh, "model", home)


def _norm(h, scale, bias, cfg: ModelConfig):
    if cfg.norm == "ln":
        return blocks.layer_norm(h, scale, bias)
    return blocks.rms_norm(h, scale)


def _project_qkv(h, p: dict, cfg: ModelConfig, memory=None):
    """-> q [B, S, Hq, dh], k, v [B, Skv, Hkv, dh] in h.dtype: q from
    ``h``, k and v from ``memory`` (cross-attention) or ``h``."""
    src = h if memory is None else memory
    if _tp_ok(cfg, p["wq"], h.shape[-1], cfg.n_heads * cfg.head_dim):
        q = _tp_linear(h, p["wq"], cfg, "col")
    else:
        q = h @ _local(p["wq"]).to(h.dtype)
    k = src @ p["wk"].to(h.dtype)
    v = src @ p["wv"].to(h.dtype)
    if "bq" in p:
        q = q + p["bq"].to(h.dtype)
        k = k + p["bk"].to(h.dtype)
        v = v + p["bv"].to(h.dtype)
    b, s = q.shape[:2]
    skv = k.shape[1]
    q = q.reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = k.reshape(b, skv, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(b, skv, cfg.n_kv_heads, cfg.head_dim)
    q = _wsc(q, cfg, None, _model_ax(cfg, cfg.n_heads), None)
    k = _wsc(k, cfg, None, _model_ax(cfg, cfg.n_kv_heads), None)
    v = _wsc(v, cfg, None, _model_ax(cfg, cfg.n_kv_heads), None)
    if cfg.qk_norm and "q_norm" in p:
        q = blocks.rms_norm(q, p["q_norm"])
        k = blocks.rms_norm(k, p["k_norm"])
    return q, k, v


def _mlp_apply(h, lp: dict, cfg: ModelConfig):
    """-> (y, aux): the MoE layer (its router cast to h.dtype before
    the float32 softmax, as the reference's) and its aux loss, or the
    dense MLP and aux 0."""
    if "moe" in lp:
        p = lp["moe"]
        if (isinstance(p["wi"], Placed) and cfg.batch_axes
                and cfg.model_axis_size > 1 and h.shape[1] > 1):
            # §Perf I1: the row's tokens to local experts, one psum
            moe = make_sharded_moe(
                p["wi"].mesh, top_k=cfg.top_k,
                capacity_factor=cfg.capacity_factor,
                n_experts=cfg.n_experts, dp_axes=tuple(cfg.batch_axes))
            return moe(h, *(p[n].to(h.dtype)
                            for n in ("router", "wi", "wg", "wo")),
                       row=p["wi"].row)
        return moe_apply(h, *(_local(p[n]).to(h.dtype)
                              for n in ("router", "wi", "wg", "wo")),
                         top_k=cfg.top_k,
                         capacity_factor=cfg.capacity_factor)
    p = lp["mlp"]
    if cfg.mlp == "swiglu":
        if _tp_ok(cfg, p["wi"], h.shape[-1], cfg.d_ff) and _tp_ok(
                cfg, p["wo"], cfg.d_ff, p["wo"].shape[1]):
            hi = (blocks.silu(_tp_linear(h, p["wg"], cfg, "col"))
                  * _tp_linear(h, p["wi"], cfg, "col"))
            y = _tp_linear(hi, p["wo"], cfg, "row")
        else:
            y = blocks.swiglu(h, *(_local(p[n]).to(h.dtype)
                                   for n in ("wi", "wg", "wo")))
    else:
        y = blocks.gelu_mlp(h, p["wi"].to(h.dtype), p["bi"].to(h.dtype),
                            p["wo"].to(h.dtype), p["bo"].to(h.dtype))
    return y, torch.zeros((), dtype=torch.float32, device=h.device)


def _attend_memory(h, p: dict, cfg: ModelConfig, memory):
    """Cross-attention over the whole memory (no mask, no rotation):
    -> (the output projection [B, S, D], (k, v) [B, Sm, Hkv, dh])."""
    q, k, v = _project_qkv(h, p, cfg, memory=memory)
    o = attn.chunked_attention(
        q, attn.expand_kv(k, cfg.n_heads), attn.expand_kv(v, cfg.n_heads),
        causal=False, chunk_q=cfg.attn_chunk_q, chunk_kv=cfg.attn_chunk_kv)
    return o.reshape(*h.shape[:2], -1) @ _local(p["wo"]).to(h.dtype), (k, v)


def _attend_cache(h, p: dict, cfg: ModelConfig, xk, xv):
    """One token's cross-attention against the memory's cached k/v
    [B, Sm, Hkv, dh]: ``decode_attention`` at the last memory position,
    GQA without expanding.  -> the output projection [B, 1, D]."""
    q = (h @ _local(p["wq"]).to(h.dtype)).reshape(h.shape[0], 1,
                                                  cfg.n_heads, cfg.head_dim)
    o = attn.decode_attention(q, xk, xv, xk.shape[1] - 1)
    return o.reshape(*h.shape[:2], -1) @ _local(p["wo"]).to(h.dtype)


def _block_full(h, lp: dict, cfg: ModelConfig, positions, causal: bool,
                kv_start=None, memory=None):
    """One block over a sequence: self-attention, [cross-attention over
    ``memory`` where the block has ``xattn``,] then the MLP.  -> (h, aux,
    (k, v) with k RoPE'd, both [B, S, Hkv, dh], (xk, xv) [B, Sm, Hkv, dh]
    or None)."""
    hn = _norm(h, lp["ln1"], lp.get("ln1_b"), cfg)
    q, k, v = _project_qkv(hn, lp["attn"], cfg)
    if cfg.use_rope:
        q = blocks.apply_rope(q, positions, cfg.rope_theta)
        k = blocks.apply_rope(k, positions, cfg.rope_theta)
    ke = _wsc(attn.expand_kv(k, cfg.n_heads), cfg, None,
              _model_ax(cfg, cfg.n_heads), None)
    ve = _wsc(attn.expand_kv(v, cfg.n_heads), cfg, None,
              _model_ax(cfg, cfg.n_heads), None)
    o = attn.chunked_attention(
        q, ke, ve, causal=causal, window=cfg.swa_window, kv_start=kv_start,
        chunk_q=cfg.attn_chunk_q, chunk_kv=cfg.attn_chunk_kv)
    o = _wsc(o, cfg, None, _model_ax(cfg, cfg.n_heads), None)
    of, wo = o.reshape(*h.shape[:2], -1), lp["attn"]["wo"]
    if _tp_ok(cfg, wo, wo.shape[1], of.shape[-1]):
        h = h + _tp_linear(of, wo, cfg, "row")
    else:
        h = h + of @ _local(wo).to(h.dtype)
    h = _wsc(h, cfg, None, None)
    xkv = None
    if "xattn" in lp:
        delta, xkv = _attend_memory(_norm(h, lp["lnx"], lp.get("lnx_b"),
                                          cfg), lp["xattn"], cfg, memory)
        h = h + delta
    hn = _norm(h, lp["ln2"], lp.get("ln2_b"), cfg)
    y, aux = _mlp_apply(hn, lp, cfg)
    return _wsc(h + y, cfg, None, None), aux, (k, v), xkv


def _block_decode(h, lp: dict, cfg: ModelConfig, ck, cv, pos: int,
                  rolling: bool, xk=None, xv=None, start=None):
    """One token's block against its layer's KV cache (written in
    place at ``pos``) and, where the block has ``xattn``, the memory's
    cached k/v.  -> (h, ck, cv)."""
    hn = _norm(h, lp["ln1"], lp.get("ln1_b"), cfg)
    q, k, v = _project_qkv(hn, lp["attn"], cfg)
    if cfg.use_rope:
        positions = torch.full((h.shape[0], 1), pos, dtype=torch.int32,
                               device=h.device)
        q = blocks.apply_rope(q, positions, cfg.rope_theta)
        k = blocks.apply_rope(k, positions, cfg.rope_theta)
    ck, cv = attn.cache_update(ck, cv, k, v, pos, rolling=rolling)
    o = attn.decode_attention(q, ck, cv, pos, window=cfg.swa_window,
                              rolling=rolling, start=start)
    h = h + o.reshape(*h.shape[:2], -1) @ _local(lp["attn"]["wo"]).to(
        h.dtype)
    if "xattn" in lp:
        h = h + _attend_cache(_norm(h, lp["lnx"], lp.get("lnx_b"), cfg),
                              lp["xattn"], cfg, xk, xv)
    hn = _norm(h, lp["ln2"], lp.get("ln2_b"), cfg)
    y, _ = _mlp_apply(hn, lp, cfg)
    return h + y, ck, cv


def _cross_layer_full(h, lp: dict, cfg: ModelConfig, memory):
    """A VLM cross layer (its own MLP, llama-3.2 style) over the
    memory.  -> (h, aux, (xk, xv))."""
    delta, xkv = _attend_memory(_norm(h, lp["ln1"], lp.get("ln1_b"), cfg),
                                lp["attn"], cfg, memory)
    h = h + delta
    y, aux = _mlp_apply(_norm(h, lp["ln2"], lp.get("ln2_b"), cfg), lp, cfg)
    return h + y, aux, xkv


def _cross_layer_decode(h, lp: dict, cfg: ModelConfig, xk, xv):
    """One token through a VLM cross layer against its cached k/v."""
    h = h + _attend_cache(_norm(h, lp["ln1"], lp.get("ln1_b"), cfg),
                          lp["attn"], cfg, xk, xv)
    y, _ = _mlp_apply(_norm(h, lp["ln2"], lp.get("ln2_b"), cfg), lp, cfg)
    return h + y


def _final_norm(h, params: dict, cfg: ModelConfig):
    if cfg.norm == "ln":
        return blocks.layer_norm(h, params["final_norm"],
                                 params["final_norm_b"])
    return blocks.rms_norm(h, params["final_norm"])


def _embed(params: dict, tokens, cfg: ModelConfig):
    """Embedding rows in cfg.dtype (gathered, then cast: the values of
    the reference's cast-then-gather)."""
    return params["embed"][tokens.long()].to(cfg.dtype)


# ----------------------------------------------------------------------
# Trunk forward
# ----------------------------------------------------------------------
def _encode(params: dict, frames, cfg: ModelConfig):
    """The whisper encoder: the stub frame embeddings [B, n_frames, D]
    plus the encoder's learned positions, in cfg.dtype, through its
    blocks without a causal mask, then its final LayerNorm."""
    enc = params["encoder"]
    eh = frames.to(cfg.dtype) + enc["pos_embed"].to(cfg.dtype)[None]
    b, sf = eh.shape[:2]
    epos = torch.arange(sf, dtype=torch.int32,
                        device=eh.device)[None].expand(b, sf)
    body = _maybe_remat(lambda h, lp: _block_full(h, lp, cfg, epos,
                                                   causal=False)[0], cfg)
    for l in range(enc["blocks"]["ln1"].shape[0]):
        eh = body(eh, _layer(enc["blocks"], l))
    return blocks.layer_norm(eh, enc["final_norm"], enc["final_norm_b"])


def _memory(params: dict, cfg: ModelConfig, frames, image_embeds):
    """The cross-attention memory [B, Sm, D] in cfg.dtype: the encoder's
    output (audio) or the stub image embeddings (VLM); None otherwise."""
    if cfg.encoder_layers:
        if frames is None:
            raise ValueError(f"{cfg.name} needs stub frame embeddings "
                             f"(frames [B, {cfg.n_frames}, d_model])")
        return _encode(params, frames, cfg)
    if cfg.cross_attn_every:
        if image_embeds is None:
            raise ValueError(f"{cfg.name} needs stub patch embeddings "
                             f"(image_embeds [B, {cfg.n_image_tokens}, "
                             f"d_model])")
        return image_embeds.to(cfg.dtype)
    return None


def _n_groups(params: dict, cfg: ModelConfig) -> int:
    """A VLM's cross layers, one after each group of
    ``cross_attn_every`` self layers; 0 for the other families."""
    if cfg.cross_attn_every and "blocks_cross" in params:
        return params["blocks_cross"]["ln1"].shape[0]
    return 0


def trunk_forward(params: dict, tokens, cfg: ModelConfig, *, frames=None,
                  image_embeds=None, collect_cache: bool = False,
                  kv_start=None):
    """Token trunk: tokens [B, S] -> (hidden [B, S, D], aux, caches or
    None, memory [B, Sm, D] or None).  ``collect_cache``: caches {"k",
    "v": [L, B, S, Hkv, dh]} and, with a memory, {"xk", "xv": [L or G,
    B, Sm, Hkv, dh]}; ``kv_start``: optional [B] first valid positions
    of left-padded rows (masks self-attention only).  ``frames``
    (whisper) or ``image_embeds`` (VLM) feed the memory; a learned
    position table adds its first S rows to the embeddings.  Each layer
    body runs under ``cfg.remat`` (``_maybe_remat``)."""
    b, s = tokens.shape
    h = _embed(params, tokens, cfg)
    if cfg.learned_pos:
        h = h + params["pos_embed"][:s].to(cfg.dtype)[None]
    positions = torch.arange(s, dtype=torch.int32,
                             device=h.device)[None].expand(b, s)
    memory = _memory(params, cfg, frames, image_embeds)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    ks, vs, xks, xvs = [], [], [], []
    n_groups = _n_groups(params, cfg)
    every = cfg.cross_attn_every if n_groups else cfg.n_layers
    self_body = _maybe_remat(
        lambda h, lp: _block_full(h, lp, cfg, positions, causal=True,
                                  kv_start=kv_start, memory=memory), cfg)
    cross_body = _maybe_remat(
        lambda h, lp: _cross_layer_full(h, lp, cfg, memory), cfg)
    for g in range(max(n_groups, 1)):
        for l in range(g * every, (g + 1) * every):
            h, a, (k, v), xkv = self_body(h, _layer(params["blocks"], l))
            aux = aux + a
            if collect_cache:
                ks.append(k)
                vs.append(v)
                if xkv is not None:
                    xks.append(xkv[0])
                    xvs.append(xkv[1])
        if n_groups:
            h, a, (xk, xv) = cross_body(
                h, _layer(params["blocks_cross"], g))
            aux = aux + a
            if collect_cache:
                xks.append(xk)
                xvs.append(xv)
    caches = None
    if collect_cache:
        caches = {"k": torch.stack(ks), "v": torch.stack(vs)}
        if xks:
            caches["xk"], caches["xv"] = torch.stack(xks), torch.stack(xvs)
    return _final_norm(h, params, cfg), aux, caches, memory


# ----------------------------------------------------------------------
# Heads + losses
# ----------------------------------------------------------------------
def head_logits_train(params_head: dict, h, cfg: ModelConfig, step: int):
    """One reparameterized draw of the head at stream offset ``step``
    (Bayes-by-backprop): -> (logits h·w in h.dtype, the head's KL).  ε
    comes from ``bayes_layer.sample_weights_at`` (on the card one ε
    kernel launch, [d_model, vocab_padded]) and carries no gradient.
    A non-Bayesian head gives h·w and KL 0."""
    w, kl = head_weights_train(params_head, cfg, step, h.device)
    return h @ w.to(h.dtype), kl


def head_weights_train(params_head: dict, cfg: ModelConfig, step: int,
                       device) -> tuple:
    """``head_logits_train``'s head: (the drawn weights [d_model,
    vocab_padded], the KL), or a non-Bayesian head's ``w`` and KL 0 (on
    ``device``).  A mesh step draws it once, on its first device."""
    if not cfg.bayesian_head:
        return (params_head["w"],
                torch.zeros((), dtype=torch.float32, device=device))
    bcfg = cfg.head_bayes_cfg()
    w = bayes_layer.sample_weights_at(params_head, bcfg, step)
    return w, bayes_layer.kl_divergence(params_head, bcfg)


def train_loss(params, batch, cfg: ModelConfig, step: int = 0):
    """Next-token cross entropy + kl_weight · KL / tokens +
    aux_loss_weight · MoE aux, at stream offset ``step`` (the host's
    step count: nothing is read back from the card).  ``batch``:
    {"tokens", "labels": [B, S]} and, for the audio and VLM families,
    "frames" / "image_embeds".  -> (loss, {"ce", "kl", "aux"})."""
    h, aux, _, _ = trunk_forward(
        params, batch["tokens"], cfg, frames=batch.get("frames"),
        image_embeds=batch.get("image_embeds"))
    logits, kl = head_logits_train(params["head"], h, cfg, step)
    ce = blocks.causal_cross_entropy(logits, batch["labels"], cfg.vocab)
    n_tokens = batch["tokens"].shape[0] * batch["tokens"].shape[1]
    loss = ce + cfg.kl_weight * kl / n_tokens + cfg.aux_loss_weight * aux
    return loss, {"ce": ce, "kl": kl, "aux": aux}


# ----------------------------------------------------------------------
# Serving
# ----------------------------------------------------------------------
def prefill(params: dict, tokens, cfg: ModelConfig, *, cache_len: int,
            frames=None, image_embeds=None, prompt_lengths=None):
    """Run the prompt, build a KV cache of ``cache_len``.

    -> (cache, last-position hidden [B, D]).  ``prompt_lengths`` [B]:
    true lengths of LEFT-padded rows (continuous-batching admission):
    pad positions are masked out of attention and recorded as the
    cache's per-slot ``start``.  A prompt longer than the cache keeps
    its last entries and its ``start`` shifts with them.  A
    sliding-window config whose ``cache_len`` exceeds its window gets a
    rolling cache of the window's size, which takes no
    ``prompt_lengths`` (ValueError), as the reference's.  ``frames`` /
    ``image_embeds`` feed a cross-attention family's memory, whose k/v
    the cache carries as ``xk``/``xv``."""
    b, s = tokens.shape
    rolling = cfg.swa_window is not None and cache_len > cfg.swa_window
    sc = cfg.swa_window if rolling else cache_len
    kv_start = None
    if prompt_lengths is not None:
        if rolling:
            raise ValueError(
                "prompt_lengths (left-padded admission) is not supported "
                f"with a rolling SWA cache (cache_len={cache_len} > "
                f"window={cfg.swa_window}): decode_attention cannot apply "
                "the per-slot start mask to a circular buffer")
        lengths = torch.as_tensor(prompt_lengths, device=tokens.device)
        kv_start = (s - lengths).to(torch.int32)
    h, _, caches, _ = trunk_forward(params, tokens, cfg, frames=frames,
                                    image_embeds=image_embeds,
                                    collect_cache=True, kv_start=kv_start)

    def fit(x):  # [L, B, S, Hkv, dh] -> [L, B, sc, Hkv, dh]
        if s >= sc:
            return x[:, :, s - sc:].contiguous()
        return F.pad(x, (0, 0, 0, 0, 0, sc - s))

    cache = {"k": fit(caches["k"]), "v": fit(caches["v"]), "pos": s}
    if kv_start is not None:
        cache["start"] = (kv_start if s <= sc else
                          torch.clamp(kv_start - (s - sc), min=0))
    if "xk" in caches:
        cache["xk"], cache["xv"] = caches["xk"], caches["xv"]
    return cache, h[:, -1]


def _head_serving(params: dict, cfg: ModelConfig) -> dict:
    """Serving head {mu_prime, sigma} in cfg.dtype: a prepared head's,
    or the raw µ and softplus(ρ)."""
    hp = params["head"]
    if "mu_prime" in hp:
        return {"mu_prime": hp["mu_prime"].to(cfg.dtype),
                "sigma": hp["sigma"].to(cfg.dtype)}
    return {"mu_prime": hp["mu"].to(cfg.dtype),
            "sigma": bayes_layer.sigma_of(hp).to(cfg.dtype)}


def _learned_position(params: dict, pos: int, cfg: ModelConfig):
    """The learned position term decode adds at ``pos``, as the
    reference's ``decode_hidden`` computes it: the table's row at
    ``pos``, clamped to its last row past the table (``lax.
    dynamic_slice_in_dim`` clamps its start), of which the indexing
    ``pe[None, 0:1, 0]`` keeps the first element only, broadcast over
    the model width (ROADMAP C28: prefill adds the whole row).  ->
    [1, 1] in cfg.dtype."""
    row = min(max(int(pos), 0), params["pos_embed"].shape[0] - 1)
    return params["pos_embed"][row, 0:1].to(cfg.dtype)[None]


def decode_hidden(params: dict, cache: dict, token, cfg: ModelConfig):
    """One trunk decode step without the Bayesian head: token [B, 1] ->
    (last hidden [B, D], new cache).  The new cache's k/v are a copy
    with this step's entries written at ``pos``; ``pos`` advances by
    one; ``xk``/``xv`` are read, not written.  Honors ``cache["start"]``
    (left-padded admissions) on a linear cache; a sliding-window
    config's cache decodes as the rolling one, which ignores it, as the
    reference's does (ROADMAP C25).  A learned position table adds
    ``_learned_position`` (C28)."""
    pos = int(cache["pos"])
    start = cache.get("start")
    h = _embed(params, token, cfg)                             # [B, 1, D]
    if cfg.learned_pos:
        h = h + _learned_position(params, pos, cfg)
    rolling = (cfg.swa_window is not None
               and cache["k"].shape[2] <= cfg.swa_window)
    new_k, new_v = cache["k"].clone(), cache["v"].clone()
    xk, xv = cache.get("xk"), cache.get("xv")
    n_groups = _n_groups(params, cfg)
    every = cfg.cross_attn_every if n_groups else cfg.n_layers
    for g in range(max(n_groups, 1)):
        for l in range(g * every, (g + 1) * every):
            lp = _layer(params["blocks"], l)
            h, _, _ = _block_decode(
                h, lp, cfg, new_k[l], new_v[l], pos, rolling,
                xk=xk[l] if "xattn" in lp else None,
                xv=xv[l] if "xattn" in lp else None, start=start)
        if n_groups:
            h = _cross_layer_decode(h, _layer(params["blocks_cross"], g),
                                    cfg, xk[g], xv[g])
    h = _final_norm(h, params, cfg)
    return h[:, 0], dict(cache, k=new_k, v=new_v, pos=pos + 1)


def decode_step(params: dict, cache: dict, token, cfg: ModelConfig):
    """One decode step: token [B, 1] -> (logit samples [R, B, Vp], new
    cache).  The selection stream is indexed by decode position, so
    every generated token sees fresh samples."""
    pos = int(cache["pos"])
    x, new_cache = decode_hidden(params, cache, token, cfg)
    return apply_bayes_head(params, x, cfg, pos), new_cache


def apply_bayes_head(params: dict, x: torch.Tensor, cfg: ModelConfig,
                     pos: int) -> torch.Tensor:
    """R = ``cfg.uq_samples`` logit samples [R, B, Vp] of the Bayesian
    head at decode position ``pos``: selections at stream indices
    pos·R + r (uint32), through ``logit_samples`` (on the card the
    rank16 head kernel)."""
    from repro_torch.core.sampling import BayesHeadConfig, logit_samples
    if not cfg.bayesian_head:
        return (x @ params["head"]["w"].to(x.dtype))[None]
    r = cfg.uq_samples
    x = x.contiguous()      # a prefill's last position is a strided view
    hcfg = BayesHeadConfig(num_samples=r, mode=cfg.head_mode, grng=cfg.grng,
                           compute_dtype=cfg.dtype)
    idx = as_u32(int(pos) * r + torch.arange(r, device=x.device))
    sel = indexed_selections(cfg.grng.lfsr_seed, idx)
    return logit_samples(_head_serving(params, cfg), x, hcfg, sel=sel)
