// Write-free CLT-GRNG block for Hopper (sm_90a): the standardized subset
// sums eps[r, k, n] of a weight block, from the hashed virtual devices.
//
// Replaces: the Pallas TPU kernel grng_eps_pallas
//   (repro/kernels/clt_grng_kernel.py:103, body _grng_kernel :80).
//
// What it computes (all float32), for cell (k, n) at global coordinates
// (row0 + k, col0 + n) and sample r of R:
//   raw = 0; for j = 0..15 in order: raw += sel[r, j] * I(row, col, j)
//   raw += read_noise(row, col, sample0 + r)        (read_sigma > 0 only)
//   eps[r, k, n] = (raw - sum_mean) * inv_std        (inv_std = f32(1/sum_std))
// with I and read_noise the device helpers of hash.cuh, each step rounded
// to nearest, so the kernel gives the plain PyTorch version's bits.
//
// What bounds it on this card: bytes, nominally.  At Fig. 9's block
// (256 x 256, R = 8) it writes 2.1 MB (0.63 us at 3.35 TB/s) and does
// about 18 MFLOP (0.27 us at the float32 rate); but each cell also costs
// 16 hash3 evaluations (3 mix32 rounds each) and 64 integer-to-float
// conversions, integer work that the bound does not count and that may
// well set the pace.
//
// What the design does about it: one thread per cell, which hashes its
// 16 currents once into registers and reuses them for all R samples;
// the selection table (R x 16 floats) is read through the read-only
// cache, the same words by every thread.  Stores go out along n, so a
// warp writes 128 contiguous bytes per sample.  Ragged K and N are
// masked: the output is never padded.  No shared state, no atomics: two
// launches give the same bits.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hash.cuh"

namespace {

using repro_torch::GrngParams;

constexpr int kTileN = 32;
constexpr int kTileK = 8;
constexpr int kDevices = 16;

__global__ void __launch_bounds__(kTileN * kTileK)
grng_eps_kernel(const float* __restrict__ sel, float* __restrict__ out,
                int R, int K, int N, uint32_t row0, uint32_t col0,
                uint32_t sample0, GrngParams p) {
  const int n = blockIdx.x * kTileN + threadIdx.x;
  const int k = blockIdx.y * kTileK + threadIdx.y;
  if (n >= N || k >= K) return;
  const uint32_t row = row0 + static_cast<uint32_t>(k);
  const uint32_t col = col0 + static_cast<uint32_t>(n);

  float cur[kDevices];
#pragma unroll
  for (int j = 0; j < kDevices; ++j)
    cur[j] = repro_torch::device_current(row, col, j, p);

  const size_t plane = static_cast<size_t>(K) * N;
  float* dst = out + static_cast<size_t>(k) * N + n;
  for (int r = 0; r < R; ++r) {
    const float* s = sel + r * kDevices;
    float raw = 0.f;
#pragma unroll
    for (int j = 0; j < kDevices; ++j)
      raw = __fadd_rn(raw, __fmul_rn(__ldg(s + j), cur[j]));
    if (p.read_sigma != 0.f)
      raw = __fadd_rn(raw, repro_torch::read_noise(row, col, sample0 + r, p));
    dst[r * plane] = __fmul_rn(__fsub_rn(raw, p.sum_mean), p.inv_std);
  }
}

}  // namespace

// Launches one block of eps on ``stream`` without synchronising; ``p``
// is a host pointer, copied into the launch.  Returns the launch's
// cudaError_t (0 = cudaSuccess); the Python wrapper raises on anything
// else.  The wrapper has checked devices, types, shapes and contiguity.
extern "C" int grng_eps_launch(const float* sel, float* out, int R, int K,
                               int N, unsigned int row0, unsigned int col0,
                               unsigned int sample0, const GrngParams* p,
                               void* stream) {
  if (R < 1 || K < 1 || N < 1 || p == nullptr) return cudaErrorInvalidValue;
  const dim3 block(kTileN, kTileK);
  const dim3 grid((N + kTileN - 1) / kTileN, (K + kTileK - 1) / kTileK);
  if (grid.y > 65535u) return cudaErrorInvalidValue;
  grng_eps_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      sel, out, R, K, N, row0, col0, sample0, *p);
  return static_cast<int>(cudaGetLastError());
}
