"""SAR detection model (port of ``repro/models/sar_cnn.py``, paper §V-B):
a conv trunk with global average pooling, then the Bayesian last layer.

The ideal-die trunk is ported: three 3×3 stride-2 VALID convolutions
with ReLU, then GAP.  The public ``features`` keeps the reference's
layout (NHWC images in, [B, C] features out); inside it runs
``F.conv2d`` on NCHW/OIHW, a plain convolution that the reference, too,
left to its compiler.  The CIM trunk of a bound chip instance comes
with the chip-instance slice.

Port params: {"convs": [{"w": [Cout, Cin, k, k], "b": [Cout]}, ...],
"head": {"mu": [C, n_classes], "rho": [C, n_classes]}}; ``bridge.py``
converts the reference's HWIO pytree.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.core import bayes_layer
from repro_torch.core.bayes_layer import BayesDenseConfig
from repro_torch.core.clt_grng import GRNGConfig
from repro_torch.core.quant import QuantConfig


@dataclasses.dataclass(frozen=True)
class SarCnnConfig:
    image_size: int = 32
    channels: tuple = (16, 32, 64)
    kernel: int = 3
    n_classes: int = 2
    bayesian_head: bool = True
    sigma_init: float = 0.05
    prior_sigma: float = 0.1
    kl_weight: float = 1e-4
    cim_execution: bool = False          # CIM trunk: not ported yet
    quant: QuantConfig = dataclasses.field(
        default_factory=lambda: QuantConfig(enabled=True))
    grng: GRNGConfig = dataclasses.field(default_factory=GRNGConfig)

    def head_cfg(self) -> BayesDenseConfig:
        return BayesDenseConfig(
            d_in=self.channels[-1], d_out=self.n_classes,
            sigma_init=self.sigma_init, prior_sigma=self.prior_sigma,
            grng=self.grng)


def init_sar_cnn(generator: torch.Generator, cfg: SarCnnConfig,
                 device=None) -> dict:
    """Random params from a CPU ``generator`` (He-style normal convs,
    zero biases, the Bayesian head's (µ, ρ)), moved to ``device``."""
    if not cfg.bayesian_head:
        raise NotImplementedError("only the Bayesian head is ported")
    params: dict = {"convs": []}
    c_in = 1
    for c_out in cfg.channels:
        w = torch.randn((c_out, c_in, cfg.kernel, cfg.kernel),
                        generator=generator) / math.sqrt(cfg.kernel**2 * c_in)
        params["convs"].append({"w": w.to(device),
                                "b": torch.zeros(c_out, device=device)})
        c_in = c_out
    params["head"] = bayes_layer.init(generator, cfg.head_cfg(),
                                      device=device)
    return params


def features(params: dict, images: torch.Tensor,
             cfg: SarCnnConfig) -> torch.Tensor:
    """Conv trunk -> GAP features: images [B, H, W, 1] -> [B, C]."""
    if cfg.cim_execution:
        raise NotImplementedError("the CIM trunk is not ported yet")
    h = images.permute(0, 3, 1, 2)                      # NHWC -> NCHW
    for layer in params["convs"]:
        y = F.conv2d(h, layer["w"], stride=2)           # VALID
        h = F.relu(y + layer["b"][None, :, None, None])
    return h.mean(dim=(2, 3))                           # GAP -> [B, C]
