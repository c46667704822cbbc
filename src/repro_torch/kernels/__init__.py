"""Hand-written Hopper kernels of the port, each beside its plain
PyTorch version.

  decision.py   fused decision update (CUDA, csrc/decision.cu)
  cim.py        chunked-ADC CIM product of the conv trunk on a chip
                instance (CUDA, csrc/cim_mvm.cu)
  ops.py        decision_update (the kernel + the running-count update);
                measured_full_scale, cim_matmul, cim_matmul_nonideal
  build.py      nvcc -> shared library -> ctypes, at first use
  csrc/         CUDA C++ sources (hash.cuh: device hash helpers)
"""
