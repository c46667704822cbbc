"""Hand-written Hopper kernels of the port, each beside its plain
PyTorch version.

  decision.py   fused decision update (CUDA, csrc/decision.cu)
  ops.py        decision_update: the kernel + the running-count update
  build.py      nvcc -> shared library -> ctypes, at first use
  csrc/         CUDA C++ sources (hash.cuh: device hash helpers)
"""
