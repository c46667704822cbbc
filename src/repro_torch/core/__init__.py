"""repro_torch.core — the paper's GRNG and Bayesian-head math on tensors.

Layout (mirrors ``repro/core``):
  hashing.py      counter-based entropy (uint32 values carried in int64)
  lfsr.py         16-bit LFSR + swapper selection network
  clt_grng.py     virtual device currents, selections (layer, tile,
                  cell), read noise
  offset.py       static offset compensation (exact) and its report
  quant.py        8b µ / 4b σ quantizers, 6-bit ADC, straight-through
                  estimator
  cim.py          chunked-ADC CIM matmul (the cim_execution trunk)
  bayes_layer.py  variational head: training draw (ε kernel), KL,
                  -> serving head
  sampling.py     rank16 activation basis (dense or in host chunks) and
                  sample mixing; paper, rank16 and moment logit samples
  uncertainty.py  predictive statistics, AURC, AECE/AMCE, UQ reports
  energy.py       analytic hardware energy model (pure Python)
"""

from repro_torch.core.bayes_layer import BayesDenseConfig
from repro_torch.core.clt_grng import GRNGConfig
from repro_torch.core.quant import QuantConfig
from repro_torch.core.sampling import BayesHeadConfig

__all__ = ["BayesDenseConfig", "BayesHeadConfig", "GRNGConfig",
           "QuantConfig"]
