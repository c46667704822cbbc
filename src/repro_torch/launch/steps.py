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

The mesh steps, twins of the reference's ``jit_*`` builders, run a
step over a (data, model) ``DeviceMesh`` (``launch/mesh``):
``mesh_hinted_config`` gives the config the mesh hints,
``mesh_train_step``/``mesh_prefill_step``/``mesh_decode_step`` place
params, AdamW state and caches by ``sharding/specs`` (``place``: views
where a device repeats, no bytes added) and cut the batch over 'data'
into rows.  Each row runs as one shard body on its row's device, its
params gathered a layer at a time (FSDP) except those a sharded path
reads piece by piece (the sharded MoE; with ``explicit_tp`` the TP
linears: ``models/transformer.sharded_leaf``).  Where the reference
computes an op over the whole batch (an MoE layer that does not take
the sharded path: decode, or a 'model' axis of 1), the step runs the
whole batch in one body, as GSPMD's result is the whole batch's.  The
Bayesian head's kernels run where the reference's Pallas call does
under GSPMD, on gathered operands on the mesh's first device: the
training draw's ε (one ``grng_eps.cu`` launch a step) and the serving
head (``bayes_mvm.cu`` rank16).  Training pmeans the rows' cross
entropy and aux loss, differentiates through the gathers (autograd's
reduce-scatter) and applies AdamW piece by piece.

What has no twin: ``abstract_params`` and ``abstract_cache`` are
``jax.eval_shape`` stand-ins for the reference's multi-pod dry run,
which lowers and costs XLA programs and has nothing to lower here.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch import float32_math
from repro_torch.launch.mesh import pmean
from repro_torch.models import blocks, ssm_lm, transformer
from repro_torch.models.registry import get_api
from repro_torch.models.transformer import ModelConfig, apply_bayes_head
from repro_torch.optim import AdamWConfig, adamw_update, warmup_cosine
from repro_torch.sharding import specs as S
from repro_torch.utils.trees import (leaves, tree_map, tree_map_with_name,
                                     unflatten_like)


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
                    microbatches: int = 1, *, grads_fn=None,
                    update_fn=adamw_update):
    """-> train_step(params, opt_state, batch, step) -> (params,
    opt_state, metrics {ce, kl, aux, loss, grad_norm, lr}).

    ``step`` is the host's count of steps taken (``opt_state["count"]``
    on the device).  With ``microbatches`` > 1 the batch's leading axis
    is cut into that many slices: their gradients are summed in float32
    and divided by the count, as is the loss; ce/kl/aux are the last
    slice's, in float32.  The products run in float32 (bfloat16 products
    reduce in float32): ``float32_math``.  ``grads_fn(params, batch,
    step)`` -> (loss, metrics, grads) and ``update_fn`` (``adamw_update``'s
    signature) default to one device's; the mesh step passes its own."""
    if grads_fn is None:
        def grads_fn(params, batch, step):
            return loss_and_grads(cfg, params, batch, step)

    def train_step(params, opt_state, batch: dict, step: int):
        with float32_math():
            if microbatches == 1:
                loss, metrics, grads = grads_fn(params, batch, step)
            else:
                acc = loss_sum = None
                slices = {k: v.reshape(microbatches,
                                       v.shape[0] // microbatches,
                                       *v.shape[1:])
                          for k, v in batch.items()}
                for i in range(microbatches):
                    loss, metrics, g = grads_fn(
                        params, {k: v[i] for k, v in slices.items()}, step)
                    metrics = {k: v.to(torch.float32)
                               for k, v in metrics.items()}
                    if acc is None:
                        acc = [torch.zeros(x.shape, dtype=torch.float32,
                                           device=x.device)
                               for x in leaves(g)]
                        loss_sum = torch.zeros((), dtype=torch.float32,
                                               device=loss.device)
                    acc = [a + x.to(torch.float32)
                           for a, x in zip(acc, leaves(g))]
                    loss_sum = loss_sum + loss.to(torch.float32)
                grads = unflatten_like(g, [a / microbatches for a in acc])
                loss = loss_sum / microbatches
            lr_scale = warmup_cosine(step, warmup_steps=warmup_steps,
                                     total_steps=total_steps)
            params, opt_state, opt_metrics = update_fn(
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


# ----------------------------------------------------------------------
# The mesh steps
# ----------------------------------------------------------------------
def mesh_hinted_config(cfg: ModelConfig, mesh,
                       global_batch: int) -> ModelConfig:
    """Inject activation-sharding hints: DP axes that divide the batch
    and the model-axis size (for divisibility-guarded paths)."""
    dp = S.dp_axes(mesh)
    size = 1
    for a in dp:
        size *= mesh.shape[a]
    if global_batch % size != 0:
        dp = ("data",) if global_batch % mesh.shape["data"] == 0 else ()
    return dataclasses.replace(cfg, batch_axes=tuple(dp),
                               model_axis_size=mesh.shape["model"])


def _rows(cfg: ModelConfig, mesh, batch: int, seq: int) -> int:
    """The data rows a mesh step cuts a batch of ``batch`` × ``seq``
    into: the 'data' size where the hints cut the batch and every op of
    the trunk is local to a row; 1 (the whole batch in row 0's body)
    where an MoE layer runs on the whole batch (its capacity is the
    batch's): decode, or a 'model' axis of 1."""
    n = mesh.shape["data"]
    if not cfg.batch_axes or batch % n:
        return 1
    if cfg.n_experts and not (cfg.model_axis_size > 1 and seq > 1):
        return 1
    return n


def _row_params(params, row: int, cfg: ModelConfig):
    """Row ``row``'s view of placed params (the head left out): a
    stacked leaf bound to the row (``transformer._layer`` gathers a
    layer at a time), a leaf a sharded path reads kept placed, every
    other leaf gathered on the row's device."""
    def leaf(path, x):
        if not isinstance(x, S.Placed):
            return x
        keep = transformer.sharded_leaf(cfg, path)
        if keep or S.stacked(path):
            return x.bind(row, keep)
        return x.bind(row, False).gather()
    return tree_map_with_name(
        leaf, {k: v for k, v in params.items() if k != "head"})


def _row_batch(batch: dict, row: int, rows: int, mesh) -> dict:
    """Row ``row`` of ``rows`` of a batch's leaves (dim 0), on the row's
    device."""
    dev = mesh.device((row, 0))
    out = {}
    for k, v in batch.items():
        size = v.shape[0] // rows
        out[k] = v.narrow(0, row * size, size).to(dev)
    return out


def _mean_rows(xs: list, mesh, dev):
    """The rows' pmean over 'data' (one row: itself)."""
    return xs[0] if len(xs) == 1 else pmean(xs, mesh, "data", dev)


def _mesh_loss(cfg: ModelConfig, mesh, params, batch: dict, step: int):
    """``train_loss`` over the mesh: each row's trunk, then the head
    drawn once on the first device (one ε launch), each row's cross
    entropy, the rows' ce and aux pmean'd; the KL over the global token
    count.  -> (loss, {"ce", "kl", "aux"})."""
    dev0 = mesh.first_device
    b, s = batch["tokens"].shape
    rows = _rows(cfg, mesh, b, s)
    ssm = cfg.family in ("ssm", "hybrid")
    hs, auxs = [], []
    for d in range(rows):
        p_d = _row_params(params, d, cfg)
        b_d = _row_batch(batch, d, rows, mesh)
        if ssm:
            h, aux, _ = ssm_lm.trunk_forward_ssm(p_d, b_d["tokens"], cfg)
        else:
            h, aux, _, _ = transformer.trunk_forward(
                p_d, b_d["tokens"], cfg, frames=b_d.get("frames"),
                image_embeds=b_d.get("image_embeds"))
        hs.append((h, b_d["labels"]))
        auxs.append(aux)
    w, kl = transformer.head_weights_train(S.gather(params["head"], dev0),
                                           cfg, step, dev0)
    ces = [blocks.causal_cross_entropy(h @ w.to(h.device).to(h.dtype),
                                       labels, cfg.vocab)
           for h, labels in hs]
    ce = _mean_rows(ces, mesh, dev0)
    aux = _mean_rows(auxs, mesh, dev0)
    loss = ce + cfg.kl_weight * kl / (b * s)
    if not ssm:
        loss = loss + cfg.aux_loss_weight * aux
    return loss, {"ce": ce, "kl": kl, "aux": aux}


def _mesh_grads(cfg: ModelConfig, mesh, params, batch: dict, step: int):
    """``_mesh_loss`` and its gradients -> (loss, metrics, grads): one
    gradient a slice of each placed leaf (``Placed.canonical``), in leaf
    order, each the sum over every body that read the slice."""
    flat = leaves(params)
    tracked = [{k: t.detach().requires_grad_()
                for k, t in x.canonical().items()} for x in flat]
    loss, metrics = _mesh_loss(
        cfg, mesh, unflatten_like(params, [x.with_canonical(t) for x, t
                                           in zip(flat, tracked)]),
        batch, step)
    ins = [t for tr in tracked for t in tr.values()]
    grads = torch.autograd.grad(loss, ins, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(ins, grads)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)


def _mesh_update(mesh, params, grads: list, opt_state: dict,
                 opt_cfg: AdamWConfig, lr_scale: float):
    """AdamW piece by piece: ``adamw_update`` over each placed leaf's
    slices (params, their gradients, moments and master copy, which
    share the params' specs), the global norm over every slice once;
    each new slice copied to its other holders' devices."""
    flat = leaves(params)

    def pieces(tree):
        return [t for x in leaves(tree) for t in x.canonical().values()]

    state = {k: pieces(opt_state[k]) for k in ("mu", "nu", "master")
             if k in opt_state}
    state["count"] = S.gather(opt_state["count"])
    new_p, new_state, metrics = adamw_update(pieces(params), grads, state,
                                             opt_cfg, lr_scale)

    def rebuild(new: list):
        it = iter(new)
        return unflatten_like(params, [x.with_canonical(
            {k: next(it) for k in x.canonical()}) for x in flat])
    out = {k: rebuild(new_state[k]) for k in ("mu", "nu", "master")
           if k in new_state}
    out["count"] = S.place_tensor(new_state["count"], S.P(), mesh)
    return rebuild(new_p), out, metrics


def mesh_train_step(cfg: ModelConfig, mesh, opt_cfg: AdamWConfig,
                    seq_len: int, global_batch: int, microbatches: int = 1,
                    total_steps: int = 10000, warmup_steps: int = 200):
    """The twin of the reference's ``jit_train_step`` -> (train_step,
    cfg with the mesh hints).  ``train_step(params, opt_state, batch,
    step)`` places params and AdamW state by ``param_specs`` /
    ``opt_state_specs`` (already placed trees pass through), cuts the
    batch over 'data' and returns placed (params, opt_state) and the
    metrics on the mesh's first device; ``microbatches`` > 1 goes
    through ``make_train_step``'s accumulation."""
    cfg = shape_adjusted_config(cfg, seq_len)
    cfg = mesh_hinted_config(cfg, mesh, global_batch)

    def grads_fn(params, batch, step):
        return _mesh_grads(cfg, mesh, params, batch, step)

    def update_fn(params, grads, opt_state, opt_cfg_, lr_scale):
        return _mesh_update(mesh, params, grads, opt_state, opt_cfg_,
                            lr_scale)

    inner = make_train_step(cfg, opt_cfg, total_steps, warmup_steps,
                            microbatches, grads_fn=grads_fn,
                            update_fn=update_fn)

    def train_step(params, opt_state, batch: dict, step: int):
        return inner(S.place(params, S.param_specs, mesh),
                     S.place(opt_state, S.opt_state_specs, mesh), batch,
                     step)

    return train_step, cfg


def _cache_batch_dim(name: str) -> int:
    """A cache leaf's batch dim: ``start`` [B]; k/v/xk/xv/ssm/conv
    [L, B, ...]."""
    return 0 if name.rsplit("/", 1)[-1] == "start" else 1


def _place_cache(rows: list, mesh):
    """The rows' caches as one placed by ``cache_specs`` (the host-int
    ``pos`` as it is)."""
    def abstract(name, x):
        if not isinstance(x, torch.Tensor):
            return x
        shape = list(x.shape)
        shape[_cache_batch_dim(name)] *= len(rows)
        return torch.empty(shape, dtype=x.dtype, device="meta")
    specs = S.cache_specs(tree_map_with_name(abstract, rows[0]), mesh)
    flat = [leaves(c) for c in rows]
    names = leaves(tree_map_with_name(lambda n, x: n, rows[0]))
    out = []
    for i, (name, spec) in enumerate(zip(names, leaves(specs))):
        parts = [f[i] for f in flat]
        out.append(S.place_rows(parts, _cache_batch_dim(name), spec, mesh)
                   if isinstance(parts[0], torch.Tensor) else parts[0])
    return unflatten_like(rows[0], out)


def _row_cache(cache, row: int, rows: int):
    """Row ``row``'s cache, whole on the row's device."""
    return tree_map_with_name(
        lambda n, x: x.row_part(_cache_batch_dim(n), row, rows)
        if isinstance(x, S.Placed) else x, cache)


def _serving_head(params, mesh) -> dict:
    return {"head": S.gather(params["head"], mesh.first_device)}


def mesh_prefill_step(cfg: ModelConfig, mesh, seq_len: int,
                      global_batch: int):
    """The twin of ``jit_prefill_step`` -> (prefill_step, cfg).
    ``prefill_step(params, batch)`` -> (cache placed by ``cache_specs``,
    logit samples [R, B, Vp] on the mesh's first device: the rows' last
    hidden states gathered there through the Bayesian head)."""
    cfg = shape_adjusted_config(cfg, seq_len)
    cfg = mesh_hinted_config(cfg, mesh, global_batch)
    api = get_api(cfg)

    def prefill_step(params, batch: dict):
        params = S.place(params, S.param_specs, mesh)
        b, s = batch["tokens"].shape
        rows = _rows(cfg, mesh, b, s)
        caches, hs = [], []
        for d in range(rows):
            b_d = _row_batch(batch, d, rows, mesh)
            extras = {k: v for k, v in b_d.items() if k != "tokens"}
            cache, last_h = api.prefill(_row_params(params, d, cfg),
                                        b_d["tokens"], cfg,
                                        cache_len=seq_len, **extras)
            caches.append(cache)
            hs.append(last_h.to(mesh.first_device))
        x = hs[0] if rows == 1 else torch.cat(hs)
        samples = apply_bayes_head(_serving_head(params, mesh), x, cfg,
                                   caches[0]["pos"])
        return _place_cache(caches, mesh), samples

    return prefill_step, cfg


def mesh_decode_step(cfg: ModelConfig, mesh, seq_len: int,
                     global_batch: int):
    """The twin of ``jit_decode_step`` -> (decode_step, cfg).
    ``decode_step(params, cache, token)`` -> (logit samples on the
    mesh's first device, the new cache placed by ``cache_specs``)."""
    cfg = shape_adjusted_config(cfg, seq_len)
    cfg = mesh_hinted_config(cfg, mesh, global_batch)
    api = get_api(cfg)

    def decode_step(params, cache: dict, token):
        params = S.place(params, S.param_specs, mesh)
        cache = S.place(cache, S.cache_specs, mesh)
        rows = _rows(cfg, mesh, token.shape[0], 1)
        caches, hs = [], []
        for d in range(rows):
            t_d = _row_batch({"t": token}, d, rows, mesh)["t"]
            x, new = api.decode_hidden(_row_params(params, d, cfg),
                                       _row_cache(cache, d, rows), t_d, cfg)
            caches.append(new)
            hs.append(x.to(mesh.first_device))
        x = hs[0] if rows == 1 else torch.cat(hs)
        samples = apply_bayes_head(_serving_head(params, mesh), x, cfg,
                                   cache["pos"])
        return samples, _place_cache(caches, mesh)

    return decode_step, cfg
