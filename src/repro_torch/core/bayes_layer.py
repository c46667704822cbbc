"""Variational Bayesian dense layer (port of ``repro/core/bayes_layer.py``).

The paper makes only the final projection Bayesian (§V-B1).  Its
variational parameters are (µ, ρ) with σ = softplus(ρ); deployment
freezes them into the offset-compensated serving head.  The training
forward pass and the KL term wait for the training slice.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core import clt_grng as g
from repro_torch.core import quant as q
from repro_torch.core.sampling import BayesHeadConfig, prepare_serving_head


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
    ``generator`` (a CPU generator; the result moves to ``device``)."""
    mu = torch.randn((cfg.d_in, cfg.d_out), generator=generator,
                     dtype=cfg.param_dtype) / math.sqrt(cfg.d_in)
    rho = torch.full((cfg.d_in, cfg.d_out), _inv_softplus(cfg.sigma_init),
                     dtype=cfg.param_dtype)
    return {"mu": mu.to(device), "rho": rho.to(device)}


def sigma_of(params: dict) -> torch.Tensor:
    """σ = softplus(ρ), as log(exp(ρ) + 1) — ``jax.nn.softplus``'s form
    (PyTorch's ``softplus`` switches to the identity above 20)."""
    rho = params["rho"]
    return torch.logaddexp(rho, torch.zeros_like(rho))


def to_serving(params: dict, head_cfg: BayesHeadConfig) -> dict:
    """Freeze the variational posterior into the serving head."""
    return prepare_serving_head(params["mu"], sigma_of(params), head_cfg)
