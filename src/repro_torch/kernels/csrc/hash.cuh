// Device twins of repro_torch/core/hashing.py (mix32, hash3, gaussianish).
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

}  // namespace repro_torch
