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
materialized per sample (``logit_samples_paper``).  ``logit_samples``
sends both modes through the fused head kernels
(``kernels/ops.bayes_head_mvm``); ``logit_samples_paper`` and
``logit_samples_rank16`` stay the plain functions.

Ported: the 'rank16' mode with a dense basis, hoisted or not, and the
'paper' mode, at 'layer' granularity.  The host-chunked hoist
(``hoist_tile_n``), the 'moment' mode and the 'tile'/'cell'
granularities of 'paper' wait for later slices.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import clt_grng as g
from repro_torch.core import quant as q
from repro_torch.core.hashing import as_u32, gaussianish, hash3
from repro_torch.core.offset import compensate_mu


@dataclasses.dataclass(frozen=True)
class BayesHeadConfig:
    num_samples: int = 20            # paper R = 20
    mode: str = "rank16"
    grng: g.GRNGConfig = dataclasses.field(default_factory=g.GRNGConfig)
    quant: q.QuantConfig = dataclasses.field(
        default_factory=lambda: q.QuantConfig(enabled=False))
    compute_dtype: torch.dtype = torch.bfloat16
    # Materialize the 16 σ⊙I_j basis matrices once at deployment, so
    # serving never recomputes the device-current hashes.
    hoist_basis: bool = False
    # Calibration epoch of the head this config serves: bumped by
    # hw/redeploy on every recalibrate-and-swap, so two calibrations of
    # one die never compare equal.
    calib_epoch: int = 0


def hoisted_sigma_basis(sigma: torch.Tensor, grng_cfg: g.GRNGConfig,
                        compute_dtype: torch.dtype) -> torch.Tensor:
    """The dense hoisted basis σ⊙I_j -> [K, N, 16] in compute dtype."""
    kdim, n = sigma.shape
    currents = g.device_currents_grid(grng_cfg, kdim, n,
                                      device=sigma.device)      # [K, N, 16]
    return (sigma[..., None] * currents).to(compute_dtype)


def prepare_serving_head(mu: torch.Tensor, sigma: torch.Tensor,
                         cfg: BayesHeadConfig) -> dict:
    """One-time deployment transform: offset compensation (+
    quantization when ``cfg.quant.enabled``).  Returns {mu_prime,
    sigma} in compute dtype, plus ``sigma_basis`` [K, N, 16] when the
    rank16 basis is hoisted."""
    if cfg.mode not in ("rank16", "paper"):
        raise NotImplementedError(f"mode={cfg.mode!r} is not ported yet")
    mu_p = compensate_mu(mu, sigma, cfg.grng)
    if cfg.quant.enabled:
        mu_p, _ = q.quantize_mu(mu_p, cfg.quant)
        sigma, _ = q.quantize_sigma(sigma, cfg.quant)
    head = {"mu_prime": mu_p.to(cfg.compute_dtype),
            "sigma": sigma.to(cfg.compute_dtype)}
    if cfg.hoist_basis and cfg.mode == "rank16":
        head["sigma_basis"] = hoisted_sigma_basis(sigma, cfg.grng,
                                                  cfg.compute_dtype)
    return head


def sigma_basis_products(x: torch.Tensor, sigma: torch.Tensor,
                         grng: g.GRNGConfig, row0: int = 0,
                         col0: int = 0) -> torch.Tensor:
    """The 16 basis products m[..., j] = x·(σ⊙I_j), I_j hashed at global
    coordinates offset by (row0, col0), one device at a time ->
    [B, N, 16] in x's dtype."""
    kdim, n = sigma.shape
    rows = row0 + torch.arange(kdim, dtype=torch.int64,
                               device=x.device)[:, None]
    cols = col0 + torch.arange(n, dtype=torch.int64, device=x.device)[None]
    return torch.stack(
        [x @ (sigma * g.device_current_j(grng, rows, cols, j).to(x.dtype))
         for j in range(grng.n_devices)], dim=-1)


def activation_basis(head: dict, x: torch.Tensor,
                     cfg: BayesHeadConfig) -> dict:
    """Per-activation rank-16 basis: the serving engine's per-slot state.

    x [B, K] -> {"y_mu": [B,N], "x_sigma": [B,N], "m": [B,N,16]}, plus
    ``x_sigsq = (x²)·(σ²)`` [B,N] when ``cfg.grng.read_sigma > 0``.
    """
    if cfg.grng.granularity != "layer":
        raise ValueError("rank16 requires shared ('layer') selection")
    sigma = head["sigma"]
    y_mu = x @ head["mu_prime"]                        # [B, N]
    x_sigma = x @ sigma                                # [B, N]
    if "sigma_basis" in head:                          # hoisted at deployment
        m = torch.einsum("bk,knj->bnj", x, head["sigma_basis"].to(x.dtype))
    else:
        m = sigma_basis_products(x, sigma, cfg.grng)   # [B, N, 16]
    ab = {"y_mu": y_mu, "x_sigma": x_sigma, "m": m}
    if cfg.grng.read_sigma:
        ab["x_sigsq"] = (x * x) @ (sigma * sigma)      # [B, N]
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
               key, col0: int = 0) -> torch.Tensor:
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
        rows = torch.arange(b, dtype=torch.int64, device=x_sigma.device)
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
    full-width block for the dense ``m`` (host-chunked bases are not
    ported yet)."""
    yield abasis["m"], 0, abasis["m"].shape[1]


def mix_samples(abasis: dict, sel: torch.Tensor, cfg: BayesHeadConfig,
                sample_idx=None) -> torch.Tensor:
    """Selection vectors -> logit samples against a basis cache.

    sel: [R, 16] (shared stream) or [R, B, 16] (per-slot streams).
    sample_idx: the absolute stream indices of ``sel`` ([R] or [R, B]),
    the read-noise key on a degraded die.  Returns [R, B, N].
    """
    key = _noise_key(sel, sample_idx) if cfg.grng.read_sigma else None
    y_mu, x_sigma = abasis["y_mu"], abasis["x_sigma"]
    x_sigsq = abasis.get("x_sigsq")
    parts = [
        _mix_block(m, y_mu[:, c0:c1], x_sigma[:, c0:c1],
                   None if x_sigsq is None else x_sigsq[:, c0:c1],
                   sel, cfg, key, col0=c0)
        for m, c0, c1 in basis_blocks(abasis)]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)


def _sigma_eps_mvm(x: torch.Tensor, sigma: torch.Tensor, grng: g.GRNGConfig,
                   sel: torch.Tensor, sample0: int = 0, row0: int = 0,
                   col0: int = 0) -> torch.Tensor:
    """The paper mode's inner loop: R explicit x·(σ⊙ε_r) products, ε_r
    from the block's currents (hashed once) and sample r's selection,
    with the per-cell read noise at absolute sample ``sample0 + r`` ->
    [R, B, N] ('layer' granularity)."""
    if grng.granularity != "layer":
        raise NotImplementedError(
            f"granularity={grng.granularity!r} is not ported yet")
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
    """Faithful R-pass sampling: x [B, K] -> [R, B, N]."""
    num = num_samples or cfg.num_samples
    sel = g.selections(cfg.grng, num, sample0, device=x.device)
    y_mu = x @ head["mu_prime"]
    return y_mu[None] + _sigma_eps_mvm(x, head["sigma"], cfg.grng, sel,
                                       sample0)


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


def logit_samples(head: dict, x: torch.Tensor, cfg: BayesHeadConfig,
                  num_samples: int | None = None,
                  sample0: int = 0) -> torch.Tensor:
    """R logit samples [R, B, N] of the head for x [B, K] from sample
    ``sample0`` of the selection stream, by ``cfg.mode``: 'paper' and
    'rank16' through the fused head kernels
    (``kernels/ops.bayes_head_mvm``; on CPU tensors their plain
    versions).  The 'moment' mode is not ported yet."""
    from repro_torch.kernels import ops
    if cfg.mode not in ("paper", "rank16"):
        raise NotImplementedError(f"mode={cfg.mode!r} is not ported yet")
    num = num_samples or cfg.num_samples
    return ops.bayes_head_mvm(x, head["mu_prime"], head["sigma"], cfg.grng,
                              num, sample0=sample0, mode=cfg.mode)
