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

Ported: the 'rank16' mode with a dense basis, hoisted or not.  The
host-chunked hoist (``hoist_tile_n``) and the 'paper'/'moment' modes
wait for later slices.
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
    if cfg.mode != "rank16":
        raise NotImplementedError(f"mode={cfg.mode!r} is not ported yet")
    mu_p = compensate_mu(mu, sigma, cfg.grng)
    if cfg.quant.enabled:
        mu_p, _ = q.quantize_mu(mu_p, cfg.quant)
        sigma, _ = q.quantize_sigma(sigma, cfg.quant)
    head = {"mu_prime": mu_p.to(cfg.compute_dtype),
            "sigma": sigma.to(cfg.compute_dtype)}
    if cfg.hoist_basis:
        head["sigma_basis"] = hoisted_sigma_basis(sigma, cfg.grng,
                                                  cfg.compute_dtype)
    return head


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
        kdim, n = sigma.shape
        rows = torch.arange(kdim, dtype=torch.int64, device=x.device)[:, None]
        cols = torch.arange(n, dtype=torch.int64, device=x.device)[None, :]
        m = torch.stack(
            [x @ (sigma * g.device_current_j(cfg.grng, rows, cols, j)
                  .to(x.dtype)) for j in range(cfg.grng.n_devices)],
            dim=-1)                                    # [B, N, 16]
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
