"""Rank-16 Bayesian-head sampling (port of ``repro/core/sampling.py``).

The selection lines are shared by every cell, so sample r of the head
output is affine in the 16 selection bits s_r:

    Y_r = X·µ' + ( Σ_j s_r[j] · X·(σ⊙I_j)  −  m̂ · X·σ ) / ĝ

``activation_basis`` computes y_mu = X·µ', x_sigma = X·σ and the 16
basis products m[..., j] = X·(σ⊙I_j) once per activation; afterwards any
number of samples, at any stream offset, costs only the [R,16]×[16,·]
mixing of ``mix_samples``.  With read noise (``read_sigma > 0``) each
logit also carries N(0, read_sigma²·x_sigsq), hashed from the absolute
sample index.

The 'paper' mode is the faithful baseline: R explicit σε products, ε
materialized per sample (``logit_samples_paper``), at any selection
granularity.  The 'moment' mode propagates the analytic mean and
diagonal variance (``logit_moments``) and draws Gaussians from them.
``logit_samples`` sends 'rank16' and 'layer' 'paper' through the fused
head kernels (``kernels/ops.bayes_head_mvm``); ``logit_samples_paper``
and ``logit_samples_rank16`` stay the plain functions.

A head hoisted with ``hoist_tile_n`` keeps its basis in host memory as
column chunks (``sigma_basis_host``); ``activation_basis`` streams them
through the device one at a time and returns the activation basis as
host chunks too (``m_host``), which ``mix_samples`` and
``serving/adaptive.update_stats_streamed`` consume chunk by chunk.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import clt_grng as g
from repro_torch.core import quant as q
from repro_torch.core.hashing import as_u32, gaussianish, hash3
from repro_torch.core.offset import compensate_mu

MODES = ("rank16", "paper", "moment")


@dataclasses.dataclass(frozen=True)
class BayesHeadConfig:
    num_samples: int = 20            # paper R = 20
    mode: str = "rank16"             # 'paper' | 'rank16' | 'moment'
    grng: g.GRNGConfig = dataclasses.field(default_factory=g.GRNGConfig)
    quant: q.QuantConfig = dataclasses.field(
        default_factory=lambda: q.QuantConfig(enabled=False))
    compute_dtype: torch.dtype = torch.bfloat16
    # Materialize the 16 σ⊙I_j basis matrices once at deployment, so
    # serving never recomputes the device-current hashes.
    hoist_basis: bool = False
    # With ``hoist_tile_n`` > 0 (and below N) the hoisted basis lives in
    # host memory as chunks of ``hoist_tile_n`` output columns, streamed
    # to the device one at a time: the device holds K·hoist_tile_n·16
    # of it instead of K·N·16 (vocabulary-width heads).
    hoist_tile_n: int = 0
    # Calibration epoch of the head this config serves: bumped by
    # hw/redeploy on every recalibrate-and-swap, so two calibrations of
    # one die never compare equal.
    calib_epoch: int = 0


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A device tensor copied to pinned host memory; a CPU tensor is
    already on the host."""
    if t.device.type == "cpu":
        return t
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return out.copy_(t)


def hoisted_sigma_basis(sigma: torch.Tensor, grng_cfg: g.GRNGConfig,
                        compute_dtype: torch.dtype,
                        tile_n: int = 0) -> dict:
    """The hoisted basis σ⊙I_j in compute dtype, dense or in host chunks.

    ``tile_n`` > 0 and below N: {"sigma_basis_host": tuple of host
    [K, ≤tile_n, 16] chunks}, each built on σ's device and copied to
    pinned host memory, so the whole basis never exists on the device;
    otherwise {"sigma_basis": [K, N, 16]} on σ's device."""
    kdim, n = sigma.shape
    if tile_n and tile_n < n:
        chunks = []
        for c0 in range(0, n, tile_n):
            c1 = min(c0 + tile_n, n)
            cur = g.device_currents_grid(grng_cfg, kdim, c1 - c0, col0=c0,
                                         device=sigma.device)  # [K, cn, 16]
            chunks.append(_to_host(
                (sigma[:, c0:c1, None] * cur).to(compute_dtype)))
        return {"sigma_basis_host": tuple(chunks)}
    currents = g.device_currents_grid(grng_cfg, kdim, n,
                                      device=sigma.device)      # [K, N, 16]
    return {"sigma_basis": (sigma[..., None] * currents).to(compute_dtype)}


def prepare_serving_head(mu: torch.Tensor, sigma: torch.Tensor,
                         cfg: BayesHeadConfig,
                         hoist_tile_n: int | None = None) -> dict:
    """One-time deployment transform: offset compensation (+
    quantization when ``cfg.quant.enabled``).  Returns {mu_prime,
    sigma} in compute dtype, plus the hoisted rank16 basis when
    ``cfg.hoist_basis`` (``hoisted_sigma_basis`` at ``hoist_tile_n``,
    which overrides ``cfg.hoist_tile_n``)."""
    if cfg.mode not in MODES:
        raise ValueError(f"mode={cfg.mode!r} is not one of {MODES}")
    tile_n = cfg.hoist_tile_n if hoist_tile_n is None else hoist_tile_n
    mu_p = compensate_mu(mu, sigma, cfg.grng)
    if cfg.quant.enabled:
        mu_p, _ = q.quantize_mu(mu_p, cfg.quant)
        sigma, _ = q.quantize_sigma(sigma, cfg.quant)
    head = {"mu_prime": mu_p.to(cfg.compute_dtype),
            "sigma": sigma.to(cfg.compute_dtype)}
    if cfg.hoist_basis and cfg.mode == "rank16":
        head.update(hoisted_sigma_basis(sigma, cfg.grng, cfg.compute_dtype,
                                        tile_n))
    return head


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in the two operands' promoted dtype, as JAX promotes a
    mixed product (float32 @ bfloat16 is float32: the bfloat16 operand
    widens exactly); ``torch.matmul`` refuses mixed dtypes."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def sigma_basis_products(x: torch.Tensor, sigma: torch.Tensor,
                         grng: g.GRNGConfig, row0: int = 0,
                         col0: int = 0) -> torch.Tensor:
    """The 16 basis products m[..., j] = x·(σ⊙I_j), I_j hashed at global
    coordinates offset by (row0, col0), one device at a time ->
    [B, N, 16] in the promoted dtype of x and σ (σ⊙I_j in σ's and x's,
    as the reference's ``sigma * i_j.astype(x.dtype)`` promotes)."""
    kdim, n = sigma.shape
    rows = row0 + torch.arange(kdim, dtype=torch.int64,
                               device=x.device)[:, None]
    cols = col0 + torch.arange(n, dtype=torch.int64, device=x.device)[None]
    return torch.stack(
        [_mm(x, sigma * g.device_current_j(grng, rows, cols, j).to(x.dtype))
         for j in range(grng.n_devices)], dim=-1)


def activation_basis(head: dict, x: torch.Tensor, cfg: BayesHeadConfig,
                     dense: bool = False) -> dict:
    """Per-activation rank-16 basis: the serving engine's per-slot state.

    x [B, K] -> {"y_mu": [B,N], "x_sigma": [B,N], "m": [B,N,16]}, plus
    ``x_sigsq = (x²)·(σ²)`` [B,N] when ``cfg.grng.read_sigma > 0``.

    A head hoisted in host chunks (``sigma_basis_host``): each chunk is
    copied to x's device, contracted and copied back, and the basis
    comes back as host chunks ``m_host`` (tuple of [B, ≤tile_n, 16])
    in place of ``m``, so neither basis exists whole on the device.
    Products of mixed dtypes (a float32 x against a bfloat16 head, as
    the LM engine's) run in the promoted dtype, as the reference's.
    ``dense``: concatenate the chunks' products into one ``m`` on the
    device instead (what the decision kernel reads; the serving
    engine's ``featurize``, as the reference's engine does under jit).
    """
    if cfg.grng.granularity != "layer":
        raise ValueError("rank16 requires shared ('layer') selection")
    sigma = head["sigma"]
    ab = {"y_mu": _mm(x, head["mu_prime"]),           # [B, N]
          "x_sigma": _mm(x, sigma)}                   # [B, N]
    if "sigma_basis" in head:                          # hoisted at deployment
        ab["m"] = torch.einsum("bk,knj->bnj", x,
                               head["sigma_basis"].to(x.dtype))
    elif "sigma_basis_host" in head:                   # hoisted in chunks
        parts = (torch.einsum("bk,knj->bnj", x, blk.to(
            x.device, x.dtype, non_blocking=True))
            for blk in head["sigma_basis_host"])
        if dense:
            ab["m"] = torch.cat(list(parts), dim=1)
        else:
            ab["m_host"] = tuple(_to_host(p) for p in parts)
    else:
        ab["m"] = sigma_basis_products(x, sigma, cfg.grng)   # [B, N, 16]
    if cfg.grng.read_sigma:
        ab["x_sigsq"] = _mm(x * x, sigma * sigma)      # [B, N]
    return ab


def _noise_key(sel: torch.Tensor, sample_idx) -> torch.Tensor:
    """[R, B|1] uint32 (int64 carrier) read-noise hash key: the absolute
    stream indices when given, else the packed selection pattern."""
    if sample_idx is None:
        pow2 = 1 << torch.arange(16, dtype=torch.int64, device=sel.device)
        key = (sel.to(torch.int64) * pow2).sum(-1)     # [R] or [R, B]
    else:
        key = as_u32(sample_idx, device=sel.device)    # [R] or [R, B]
    return key[:, None] if key.ndim == 1 else key


def _mix_block(m, y_mu, x_sigma, x_sigsq, sel, cfg: BayesHeadConfig,
               key, col0: int = 0, row0: int = 0) -> torch.Tensor:
    """[R, B, cn] logit samples for one column block of the basis;
    the read-noise hash is keyed on GLOBAL (slot, column) coordinates."""
    gstd, gmean = cfg.grng.sum_std, cfg.grng.sum_mean
    if sel.ndim == 2:
        mix = torch.einsum("rj,bnj->rbn", sel.to(m.dtype), m)
    else:
        mix = torch.einsum("rbj,bnj->rbn", sel.to(m.dtype), m)
    out = mix - gmean * x_sigma[None]
    if cfg.grng.read_sigma:
        b, cn = x_sigma.shape
        rows = torch.arange(row0, row0 + b, dtype=torch.int64,
                            device=x_sigma.device)
        cols = col0 + torch.arange(cn, dtype=torch.int64,
                                   device=x_sigma.device)
        h = hash3(key[..., None], rows[None, :, None], cols[None, None, :],
                  cfg.grng.noise_seed)                      # [R, B, cn]
        sigma_read = (cfg.grng.read_sigma
                      * torch.sqrt(x_sigsq.clamp_min(0.0))).to(out.dtype)
        out = out + gaussianish(h).to(out.dtype) * sigma_read[None]
    return y_mu[None] + out / gstd


def basis_blocks(abasis: dict):
    """Yield (m_block, col0, col1) over an activation basis: one
    full-width block for the dense ``m``; for host chunks ``m_host``,
    each chunk copied to the basis's device for its turn only."""
    if "m_host" not in abasis:
        yield abasis["m"], 0, abasis["m"].shape[1]
        return
    dev, c0 = abasis["y_mu"].device, 0
    for blk in abasis["m_host"]:
        m = blk.to(dev, non_blocking=True)
        yield m, c0, c0 + m.shape[1]
        c0 += m.shape[1]


def mix_samples(abasis: dict, sel: torch.Tensor, cfg: BayesHeadConfig,
                sample_idx=None, row0: int = 0) -> torch.Tensor:
    """Selection vectors -> logit samples against a basis cache.

    sel: [R, 16] (shared stream) or [R, B, 16] (per-slot streams).
    sample_idx: the absolute stream indices of ``sel`` ([R] or [R, B]),
    the read-noise key on a degraded die.  Returns [R, B, N].  A basis
    in host chunks is mixed chunk by chunk (``basis_blocks``), the
    read noise keyed on global columns; ``row0``: the global slot id of
    row 0 (a slot shard's first slot).
    """
    key = _noise_key(sel, sample_idx) if cfg.grng.read_sigma else None
    y_mu, x_sigma = abasis["y_mu"], abasis["x_sigma"]
    x_sigsq = abasis.get("x_sigsq")
    parts = [
        _mix_block(m, y_mu[:, c0:c1], x_sigma[:, c0:c1],
                   None if x_sigsq is None else x_sigsq[:, c0:c1],
                   sel, cfg, key, col0=c0, row0=row0)
        for m, c0, c1 in basis_blocks(abasis)]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)


def _sigma_eps_mvm(x: torch.Tensor, sigma: torch.Tensor, grng: g.GRNGConfig,
                   sel: torch.Tensor, sample0: int = 0, row0: int = 0,
                   col0: int = 0) -> torch.Tensor:
    """The paper mode's inner loop at 'layer' granularity: R explicit
    x·(σ⊙ε_r) products, ε_r from the block's currents (hashed once) and
    the shared selection sel[r], with the per-cell read noise at
    absolute sample ``sample0 + r`` -> [R, B, N]."""
    kdim, n = sigma.shape
    currents = g.device_currents_grid(grng, kdim, n, row0, col0,
                                      device=x.device)       # [K, N, 16]
    return torch.stack([
        x @ (sigma * g.eps_at(currents, sel[r], grng, sample0 + r, row0,
                              col0).to(x.dtype))
        for r in range(sel.shape[0])])


def logit_samples_paper(head: dict, x: torch.Tensor, cfg: BayesHeadConfig,
                        num_samples: int | None = None,
                        sample0: int = 0) -> torch.Tensor:
    """Faithful R-pass sampling: x [B, K] -> [R, B, N].  At 'tile' and
    'cell' granularity the block's ε is materialized whole
    (``clt_grng.eps``) and multiplied sample by sample, as the
    reference's oracle path does."""
    num = num_samples or cfg.num_samples
    y_mu = x @ head["mu_prime"]
    sigma = head["sigma"]
    if cfg.grng.granularity == "layer":
        sel = g.selections(cfg.grng, num, sample0, device=x.device)
        return y_mu[None] + _sigma_eps_mvm(x, sigma, cfg.grng, sel, sample0)
    eps = g.eps(cfg.grng, *sigma.shape, num, sample0, device=x.device)
    return y_mu[None] + torch.stack([x @ (sigma * e.to(x.dtype))
                                     for e in eps])


def logit_samples_rank16(head: dict, x: torch.Tensor, cfg: BayesHeadConfig,
                         num_samples: int | None = None,
                         sample0: int = 0) -> torch.Tensor:
    """Exact rank-16 sampling: the activation basis (16 basis products)
    and its mixing, keyed by the absolute sample indices -> [R, B, N]."""
    if cfg.grng.granularity != "layer":
        raise ValueError("rank16 requires shared ('layer') selection")
    num = num_samples or cfg.num_samples
    sel = g.selections(cfg.grng, num, sample0, device=x.device)
    idx = sample0 + torch.arange(sel.shape[0], dtype=torch.int64,
                                 device=x.device)
    return mix_samples(activation_basis(head, x, cfg), sel, cfg,
                       sample_idx=idx)


def logit_moments(head: dict, x: torch.Tensor,
                  cfg: BayesHeadConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Analytic (mean, variance) of the logits: x [B, K] -> two [B, N].

    A cell's ε variance under a uniform 8-of-16 choice of its fixed
    currents is hypergeometric,
        Var[ε(k,n)] = k(1−k/n)·(n/(n−1))·var_j(I(k,n,j)) / ĝ²,
    plus the read noise's read_sigma²/ĝ².  The cross-cell covariance
    the shared selection creates is dropped (the reference's documented
    approximation)."""
    kdim, n = head["sigma"].shape
    grng = cfg.grng
    currents = g.device_currents_grid(grng, kdim, n, device=x.device)
    var_i = currents.var(dim=-1, correction=0)
    ksel, nd = grng.k_select, grng.n_devices
    var_eps = ((ksel * (1 - ksel / nd) * (nd / (nd - 1)) * var_i
                + grng.read_sigma**2) / grng.sum_std**2).to(x.dtype)
    mean = x @ head["mu_prime"]
    var = (x * x) @ ((head["sigma"] ** 2) * var_eps)
    return mean, var


def logit_samples(head: dict, x: torch.Tensor, cfg: BayesHeadConfig,
                  num_samples: int | None = None, sample0: int = 0,
                  generator: torch.Generator | None = None,
                  sel: torch.Tensor | None = None) -> torch.Tensor:
    """R logit samples [R, B, N] of the head for x [B, K] from sample
    ``sample0`` of the selection stream, by ``cfg.mode``:

      * 'rank16', and 'paper' at 'layer' granularity: the fused head
        kernels (``kernels/ops.bayes_head_mvm``; on CPU tensors their
        plain versions);
      * 'paper' at 'tile' or 'cell': ``logit_samples_paper`` on x's
        device.  The head kernels read one shared selection stream, as
        the reference's do (``kernels/ref.py``), whose
        ``logit_samples_paper`` draws these granularities outside any
        kernel.  The config alone picks this route;
      * 'moment': Gaussians around ``logit_moments``, drawn with
        ``generator`` (on x's device), or one seeded with ``sample0``
        where the reference seeds ``PRNGKey(sample0)``: the draws are
        not the reference's, their statistics are.

    ``sel`` [R, 16]: the selections to draw with in place of the
    stream's R from ``sample0`` (a decode loop's, indexed by position;
    the read noise stays keyed on ``sample0 + r``), for the head
    kernels' route only.
    """
    num = num_samples or cfg.num_samples
    if cfg.mode == "moment":
        mean, var = logit_moments(head, x, cfg)
        if generator is None:
            generator = torch.Generator(device=mean.device).manual_seed(
                sample0)
        z = torch.randn((num,) + tuple(mean.shape), generator=generator,
                        dtype=mean.dtype, device=mean.device)
        return mean[None] + torch.sqrt(var.clamp_min(0.0))[None] * z
    if cfg.mode not in ("paper", "rank16"):
        raise ValueError(f"mode={cfg.mode!r} is not one of {MODES}")
    if cfg.mode == "paper" and cfg.grng.granularity != "layer":
        if sel is not None:
            raise ValueError("sel overrides the shared 'layer' stream "
                             "only")
        return logit_samples_paper(head, x, cfg, num, sample0)
    from repro_torch.kernels import ops
    return ops.bayes_head_mvm(x, head["mu_prime"], head["sigma"], cfg.grng,
                              num, sample0=sample0, mode=cfg.mode, sel=sel)
