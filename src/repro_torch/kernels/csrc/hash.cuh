// Device twins of repro_torch/core/hashing.py (mix32, hash3, gaussianish)
// and of the virtual device model of repro_torch/core/clt_grng.py, shared
// by the port's kernels.
//
// They replace the helpers _mix32, _hash3, _gauss_of and _device_current
// of the TPU kernels (repro/kernels/clt_grng_kernel.py:33-71) and must
// give the same bits.  Everything is native uint32: signed int32 would
// turn the right shifts arithmetic and break the hash.
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

// hash3 factored by its coordinates, outermost last:
//   hash3(k, n, j, seed) = row_hash(k, col_prefix(n, j, seed)),
//   col_prefix(n, j, seed) = col_hash(n, key_prefix(j, seed)).
// A key prefix depends on the device (or sample) j alone and a column
// prefix on (column, j), so a kernel computes them once for a block's
// columns and a current (or a read-noise draw) then costs one mix32.
__device__ __forceinline__ uint32_t key_prefix(uint32_t j, uint32_t seed) {
  return mix32(j * 0xC2B2AE35u + seed);
}
__device__ __forceinline__ uint32_t col_hash(uint32_t n, uint32_t key) {
  return mix32(n * 0x85EBCA6Bu + key);
}
__device__ __forceinline__ uint32_t col_prefix(uint32_t n, uint32_t j,
                                               uint32_t seed) {
  return col_hash(n, key_prefix(j, seed));
}
__device__ __forceinline__ uint32_t row_hash(uint32_t k, uint32_t prefix) {
  return mix32(k * 0x9E3779B9u + prefix);
}

// The normal surrogate of a byte sum s = b0 + b1 + b2 (an exact float):
// (s - 382.5) * float32(1 / 127.99316), the subtraction exact, one
// rounding.  gauss_of and gauss_bytes compute this of a hash word.
__device__ __forceinline__ float gauss_of_sum(float s) {
  return __fmul_rn(__fadd_rn(s, -382.5f), 0x1.00038p-7f);
}

// gauss_of with each byte turned into a float by its bit pattern:
// 0x4B0000bb is 2^23 + bb exactly, so b0 + b1 = f0 + (f1 - 2^24) and the
// sum b0 + b1 + b2 are exact, as in gauss_of: the same bits, without
// int->float conversions (a quarter-rate pipe on Hopper).
__device__ __forceinline__ float gauss_bytes(uint32_t h) {
  const float f0 = __uint_as_float(__byte_perm(h, 0x4B000000u, 0x7440));
  const float f1 = __uint_as_float(__byte_perm(h, 0x4B000000u, 0x7441));
  const float f2 = __uint_as_float(__byte_perm(h, 0x4B000000u, 0x7442));
  const float b01 = __fadd_rn(f0, __fadd_rn(f1, -16777216.f));
  return gauss_of_sum(__fadd_rn(b01, __fadd_rn(f2, -8388608.f)));
}

// A device current from its hash word's top bit and gauss: replaces
// _device_current (repro/kernels/clt_grng_kernel.py:62) without the
// imprint.  (i_lo + delta_i*bit) + gamma*gauss, each step rounded to
// nearest (no FMA contraction), as the plain PyTorch version rounds it;
// delta_i*bit is written as a select: the product is exactly delta_i
// or 0.
__device__ __forceinline__ float current_of(uint32_t top, float gauss,
                                            const GrngParams& p) {
  return __fadd_rn(__fadd_rn(p.i_lo, top ? p.delta_i : 0.f),
                   __fmul_rn(p.gamma, gauss));
}

// Virtual device current I(row, col, j) from its column's prefixes (pc
// under p.seed, pi under p.imprint_seed), plus imprint*gauss(hash3(..,
// imprint_seed)) on an aged die (kImprint: p.imprint != 0).
template <bool kImprint>
__device__ __forceinline__ float current(uint32_t row, uint32_t pc,
                                         uint32_t pi, const GrngParams& p) {
  const uint32_t h = row_hash(row, pc);
  float out = current_of(h >> 31, gauss_bytes(h), p);
  if constexpr (kImprint)
    out = __fadd_rn(out, __fmul_rn(p.imprint,
                                   gauss_bytes(row_hash(row, pi))));
  return out;
}

}  // namespace repro_torch
