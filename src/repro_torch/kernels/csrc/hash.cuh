// Device twins of repro_torch/core/hashing.py (mix32, hash3, gaussianish)
// and of the virtual device model of repro_torch/core/clt_grng.py.
//
// They replace the helpers _mix32, _hash3 and _gauss_of of the TPU
// kernels (repro/kernels/clt_grng_kernel.py:33-59) and must give the
// same bits.  Everything is native uint32: signed int32 would turn the
// right shifts arithmetic and break the hash.
#pragma once

#include <stdint.h>

namespace repro_torch {

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t hash3(uint32_t k, uint32_t n, uint32_t j,
                                          uint32_t seed) {
  uint32_t h = mix32(j * 0xC2B2AE35u + seed);
  h = mix32(n * 0x85EBCA6Bu + h);
  return mix32(k * 0x9E3779B9u + h);
}

// CLT-of-bytes normal surrogate: the three low bytes of a hash word,
// summed and standardized.  0x1.00038p-7f is float32(1 / 127.99316),
// the constant the reference rounds to.
__device__ __forceinline__ float gauss_of(uint32_t h) {
  const float b0 = static_cast<float>(h & 0xFFu);
  const float b1 = static_cast<float>((h >> 8) & 0xFFu);
  const float b2 = static_cast<float>((h >> 16) & 0xFFu);
  return (b0 + b1 + b2 - 382.5f) * 0x1.00038p-7f;
}

// The GRNG device model the hashing feeds, as float32 constants of a
// GRNGConfig (kernels/grng.py fills it): currents of the 16 virtual
// devices, read noise, and the standardization of the 8-device sum.
struct GrngParams {
  float i_lo, delta_i, gamma, imprint;  // device current model [uA]
  float read_sigma;                     // cycle-to-cycle read noise [uA]
  float sum_mean, inv_std;              // (raw - sum_mean) * inv_std
  uint32_t seed, imprint_seed, noise_seed;
};

// Virtual device current I(row, col, j): replaces _device_current
// (repro/kernels/clt_grng_kernel.py:62).  (i_lo + delta_i*bit31) +
// gamma*gauss, plus imprint*gauss(hash3(.., imprint_seed)) on an aged
// die, each step rounded to nearest (no FMA contraction), as the plain
// PyTorch version rounds it.  delta_i*bit is written as a select: the
// product is exactly delta_i or 0.
__device__ __forceinline__ float device_current(uint32_t row, uint32_t col,
                                                uint32_t j,
                                                const GrngParams& p) {
  const uint32_t h = hash3(row, col, j, p.seed);
  float out = __fadd_rn(__fadd_rn(p.i_lo, (h >> 31) ? p.delta_i : 0.f),
                        __fmul_rn(p.gamma, gauss_of(h)));
  if (p.imprint != 0.f)
    out = __fadd_rn(out, __fmul_rn(p.imprint,
                                   gauss_of(hash3(row, col, j,
                                                  p.imprint_seed))));
  return out;
}

// Cycle-to-cycle read noise at absolute sample index r_abs: replaces
// _read_noise (repro/kernels/clt_grng_kernel.py:73).
__device__ __forceinline__ float read_noise(uint32_t row, uint32_t col,
                                            uint32_t r_abs,
                                            const GrngParams& p) {
  return __fmul_rn(p.read_sigma, gauss_of(hash3(row, col, r_abs,
                                                p.noise_seed)));
}

}  // namespace repro_torch
