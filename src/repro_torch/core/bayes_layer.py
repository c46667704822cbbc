"""Variational Bayesian dense layer (port of ``repro/core/bayes_layer.py``).

The paper makes only the final projection Bayesian (§V-B1).  Its
variational parameters are (µ, ρ) with σ = softplus(ρ), trained by
Bayes-by-backprop (Eq. 1): the reparameterized draw w = µ + σ·ε with ε
from the same CLT-GRNG the head is served with (train/serve
distribution match), and the closed-form KL to the prior N(0, σ_p²).
ε is a constant w.r.t. (µ, ρ): it is drawn outside the graph.
Deployment freezes (µ, σ) into the offset-compensated serving head.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core import clt_grng as g
from repro_torch.core import lfsr
from repro_torch.core import quant as q
from repro_torch.core.sampling import BayesHeadConfig, prepare_serving_head
from repro_torch.kernels import grng


@dataclasses.dataclass(frozen=True)
class BayesDenseConfig:
    d_in: int
    d_out: int
    sigma_init: float = 0.05
    prior_sigma: float = 0.1
    grng: g.GRNGConfig = dataclasses.field(default_factory=g.GRNGConfig)
    quant: q.QuantConfig = dataclasses.field(
        default_factory=lambda: q.QuantConfig(enabled=False))
    param_dtype: torch.dtype = torch.float32


def _inv_softplus(x: float) -> float:
    return math.log(math.expm1(x))


def init(generator: torch.Generator, cfg: BayesDenseConfig,
         device=None) -> dict:
    """µ ~ N(0, 1/d_in), ρ = softplus⁻¹(sigma_init), drawn from
    ``generator`` on its own device; the result moves to ``device``."""
    mu = torch.randn((cfg.d_in, cfg.d_out), generator=generator,
                     dtype=cfg.param_dtype,
                     device=generator.device) / math.sqrt(cfg.d_in)
    rho = torch.full((cfg.d_in, cfg.d_out), _inv_softplus(cfg.sigma_init),
                     dtype=cfg.param_dtype, device=generator.device)
    return {"mu": mu.to(device), "rho": rho.to(device)}


def sigma_of(params: dict) -> torch.Tensor:
    """σ = softplus(ρ), as log(exp(ρ) + 1) — ``jax.nn.softplus``'s form
    (PyTorch's ``softplus`` switches to the identity above 20)."""
    rho = params["rho"]
    return torch.logaddexp(rho, torch.zeros_like(rho))


def sample_weights(params: dict, cfg: BayesDenseConfig, step=None):
    """Reparameterized weight draw w = µ + σ·ε with ε the first sample of
    the layer's GRNG stream (``step`` is not used: the reference folds
    the stream offset in elsewhere; ``sample_weights_at`` takes it).
    With ``cfg.quant`` enabled, w goes through the 8-bit straight-through
    quantizer."""
    sigma = sigma_of(params)
    eps = g.eps(cfg.grng, cfg.d_in, cfg.d_out, 1, sample0=0,
                device=sigma.device)[0]
    w = params["mu"] + sigma * eps
    if cfg.quant.enabled:
        scale = q.symmetric_scale(w.detach(), cfg.quant.mu_bits)
        w = q.fake_quant_ste(w, scale, cfg.quant.mu_bits)
    return w


def eps_at(cfg: g.GRNGConfig, d_in: int, d_out: int, step: int,
           device=None) -> torch.Tensor:
    """The training draw's ε [d_in, d_out] at sample index ``step``: the
    layer-shared selection ``lfsr.indexed_selections(lfsr_seed, step)``
    (one 16-bit selection a training step, by random access) over the 16
    device currents, through the ε kernel (``kernels/grng.grng_eps``,
    R = 1; its plain version on the CPU).  The reference's draw has no
    read noise and no imprint, so neither enters here; and it divides by
    ``sum_std`` where the kernel multiplies by float32(1/sum_std), so ε
    may differ from the reference's by one float32 step."""
    ideal = dataclasses.replace(cfg, read_sigma=0.0, imprint=0.0)
    idx = torch.full((1,), int(step) & 0xFFFFFFFF, dtype=torch.int64,
                     device=device)
    sel = lfsr.indexed_selections(cfg.lfsr_seed, idx)           # [1, 16]
    return grng.grng_eps(sel, ideal, d_in, d_out, sample0=int(step))[0]


def sample_weights_at(params: dict, cfg: BayesDenseConfig,
                      step: int) -> torch.Tensor:
    """Like ``sample_weights`` but at the stream offset ``step`` (the
    training step): w = µ + σ·ε(step), ε from ``eps_at`` on the params'
    device, carrying no gradient."""
    sigma = sigma_of(params)
    eps = eps_at(cfg.grng, cfg.d_in, cfg.d_out, step, device=sigma.device)
    return params["mu"] + sigma * eps


def kl_divergence(params: dict, cfg: BayesDenseConfig) -> torch.Tensor:
    """KL( N(µ,σ²) ‖ N(0,σ_p²) ), summed over all weights."""
    sigma = sigma_of(params)
    sp = cfg.prior_sigma
    # f32(σ_p)/σ as the reference divides (PyTorch's number/tensor is a
    # reciprocal times the number)
    kl = (torch.log(torch.full_like(sigma, sp) / sigma)
          + (sigma**2 + params["mu"] ** 2) / (2 * sp**2) - 0.5)
    return kl.sum()


def apply_train(params: dict, x: torch.Tensor, cfg: BayesDenseConfig,
                step: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Training forward: one reparameterized sample -> (y, kl)."""
    w = sample_weights_at(params, cfg, step)
    return x @ w.to(x.dtype), kl_divergence(params, cfg)


def to_serving(params: dict, head_cfg: BayesHeadConfig) -> dict:
    """Freeze the variational posterior into the serving head."""
    return prepare_serving_head(params["mu"], sigma_of(params), head_cfg)
