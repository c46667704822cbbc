"""repro_torch.core — the paper's GRNG and Bayesian-head math on tensors.

Layout (mirrors ``repro/core``):
  hashing.py      counter-based entropy (uint32 values carried in int64)
  lfsr.py         16-bit LFSR + swapper selection network
  clt_grng.py     virtual device currents, selections, read noise
  offset.py       static offset compensation (exact)
  quant.py        8b µ / 4b σ quantizers reached by the serving head
  bayes_layer.py  variational head parameters -> serving head
  sampling.py     rank16 activation basis and sample mixing
  energy.py       analytic hardware energy model (pure Python)
"""

from repro_torch.core.bayes_layer import BayesDenseConfig
from repro_torch.core.clt_grng import GRNGConfig
from repro_torch.core.quant import QuantConfig
from repro_torch.core.sampling import BayesHeadConfig

__all__ = ["BayesDenseConfig", "BayesHeadConfig", "GRNGConfig",
           "QuantConfig"]
