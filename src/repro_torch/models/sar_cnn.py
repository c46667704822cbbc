"""SAR detection model (port of ``repro/models/sar_cnn.py``, paper §V-B):
a conv trunk with global average pooling, then the Bayesian last layer.

The trunk is three 3×3 stride-2 VALID convolutions with ReLU, then
GAP.  The public ``features`` keeps the reference's layout (NHWC images
in, [B, C] features out).  On the ideal die it runs ``F.conv2d`` on
NCHW/OIHW, a plain convolution that the reference, too, left to its
compiler.

With a chip instance bound (``chip=``) every conv runs on that die's
µ-only subarrays instead, as the paper maps them ("via im2col"):
im2col patches in the reference's (dy, dx, c) order, 8-bit IDAC inputs
(``quantize_input``), 8-bit weights with the die's conductance
programming error (``program_weights``, tag ``_TRUNK_TAG0 + layer``),
K padded to the 64-deep tile, and the chunked-ADC CIM kernel with the
die's per-column ADC gain and offset (``kernels/ops.
cim_matmul_nonideal``).  ``program_trunk`` writes the weight matrices
once; ``features(trunk=...)`` reuses them, so a serving engine pays only
the input quantization, the full scale and the kernel per admission.
The pure-tensor ``cim_execution`` trunk (``repro/core/cim.py``) is not
ported yet.

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
from repro_torch.core import quant as q
from repro_torch.core.bayes_layer import BayesDenseConfig
from repro_torch.core.clt_grng import GRNGConfig
from repro_torch.core.quant import QuantConfig
from repro_torch.kernels import ops


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
    cim_execution: bool = False          # pure-tensor CIM trunk: not ported
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


def _im2col(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """[B, H, W, C] -> patches [B, Ho, Wo, k·k·C], K in (dy, dx, c)
    order as the reference's (the paper's CIM mapping)."""
    _, h, w, _ = x.shape
    ho = (h - k) // stride + 1
    wo = (w - k) // stride + 1
    return torch.cat([x[:, dy:dy + stride * (ho - 1) + 1:stride,
                        dx:dx + stride * (wo - 1) + 1:stride, :]
                      for dy in range(k) for dx in range(k)], dim=-1)


# program_weights tag space: the Bayesian head's µ/σε subarrays own
# tags 0/1 (hw/calib.py); conv-trunk arrays start here so co-located
# writes never share a programming-noise draw.
_TRUNK_TAG0 = 16


def program_trunk(params: dict, cfg: SarCnnConfig, chip) -> list[dict]:
    """Write the conv weights onto ``chip``'s µ-only subarrays, once.

    Per layer: the [k²C, Cout] weight matrix (rows in (dy, dx, c)
    order), 8-bit quantized, with the die's programming error, K padded
    to the chunk; the die's column front end [Cout]; the bias.
    """
    trunk = []
    for i, layer in enumerate(params["convs"]):
        w = layer["w"]                                  # OIHW
        cout, k = w.shape[0], w.shape[-1]
        wmat = w.permute(2, 3, 1, 0).reshape(-1, cout)  # HWIO -> [k²C, Cout]
        wq, _ = q.quantize_mu(wmat, cfg.quant)
        wq = chip.program_weights(wq, tag=_TRUNK_TAG0 + i)
        wq = F.pad(wq, (0, 0, 0, (-wq.shape[0]) % cfg.quant.chunk))
        gain, off = chip.adc_columns(cout)
        trunk.append({
            "w": wq.contiguous(), "b": layer["b"], "k": k,
            "gain": torch.as_tensor(gain, dtype=torch.float32,
                                    device=w.device),
            "offset": torch.as_tensor(off, dtype=torch.float32,
                                      device=w.device)})
    return trunk


def _cim_conv(x: torch.Tensor, layer: dict, cfg: SarCnnConfig,
              stride: int = 2) -> torch.Tensor:
    """One conv on the die: NHWC in, NHWC out (ReLU applied)."""
    cols = _im2col(x, layer["k"], stride)               # [B, Ho, Wo, k²C]
    bsz, ho, wo, d = cols.shape
    xq, _ = q.quantize_input(cols.reshape(-1, d), cfg.quant)
    xq = F.pad(xq, (0, layer["w"].shape[0] - d))        # tile depth align
    y = ops.cim_matmul_nonideal(xq, layer["w"], cfg.quant, layer["gain"],
                                layer["offset"])
    return F.relu(y.reshape(bsz, ho, wo, -1) + layer["b"])


def features(params: dict, images: torch.Tensor, cfg: SarCnnConfig,
             chip=None, trunk: list | None = None) -> torch.Tensor:
    """Conv trunk -> GAP features: images [B, H, W, 1] -> [B, C].

    ``chip`` (a ``hw.ChipInstance``): run every conv on that die's
    nonideal CIM arrays; ``trunk``: the arrays ``program_trunk`` wrote
    for it, reused.  Either overrides ``cfg.cim_execution`` (a physical
    chip has no float conv units).
    """
    if chip is not None or trunk is not None:
        if trunk is None:
            trunk = program_trunk(params, cfg, chip)
        h = images
        for layer in trunk:
            h = _cim_conv(h, layer, cfg)
        return h.mean(dim=(1, 2))                       # GAP -> [B, C]
    if cfg.cim_execution:
        raise NotImplementedError("the cim_execution trunk is not ported "
                                  "yet")
    h = images.permute(0, 3, 1, 2)                      # NHWC -> NCHW
    for layer in params["convs"]:
        y = F.conv2d(h, layer["w"], stride=2)           # VALID
        h = F.relu(y + layer["b"][None, :, None, None])
    return h.mean(dim=(2, 3))                           # GAP -> [B, C]
