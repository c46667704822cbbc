// Chunked-ADC CIM matrix product for Hopper (sm_90a): the conv trunk of a
// bound chip instance, run on the die's µ-only subarrays.
//
// Replaces: the Pallas TPU kernel cim_mvm_pallas
//   (repro/kernels/cim_mvm.py:72, body _cim_kernel :27).
//
// What it computes (all float32), for out[M,N] = x[M,K] · w[K,N] with K a
// multiple of 64 (the physical tile depth):
//   lsb = fs / 31                                 (6-bit ADC, fs on device)
//   for each 64-deep chunk c, in order c = 0, 1, …:
//     psum = Σ_{k in chunk c} x[m,k]·w[k,n]       (the analog column sum)
//     v    = gain[n]·psum + off[n]·lsb            (column front end)
//     code = clip(rint(v / lsb), -32, 31)          (round half to even)
//     out[m,n] += code·lsb                         (digital accumulation)
//   gain = 1, off = 0 when no front end is given (the ideal ADC).
//
// What bounds it on this card: neither bytes nor operations at the main
// path's shapes, but its launch.  The largest trunk product (M=7200, K=64,
// N=16) moves 2.3 MB, about 0.7 µs at 3.35 TB/s, and does 15 MFLOP, about
// 0.2 µs at the float32 rate; a launch costs a few µs.
//
// What the design does about it: one launch per product, nothing staged in
// device memory between chunks.  The TPU's sequential k grid axis becomes a
// loop inside the block, which owns a 32×32 output tile and carries its
// accumulators in registers across the K/64 chunks:
//   per chunk  the x[32, 64] and w[64, 32] tiles go to shared memory; each
//              of the 256 threads takes 4 outputs (rows ty, ty+8, ty+16,
//              ty+24 of column tx), sums their 64 products in order
//              k = 0…63, then applies the front end and the ADC and adds
//              code·lsb to its accumulator.
//   edges      ragged M and N are masked (zero tiles, no stores); there are
//              no pad chunks, the wrapper refuses K % 64 != 0.
// The front end, the division and the accumulation are written with
// round-to-nearest intrinsics so that nvcc cannot contract them into an
// FMA: they then round exactly as the plain PyTorch version does, and only
// the order of the 64-term sum differs from it.  No atomics: two launches
// on the same inputs give the same bits.  wgmma, TMA and int8 operands are
// later work.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kChunk = 64;     // analog accumulation depth (tile rows)
constexpr int kTileM = 32;
constexpr int kTileN = 32;
constexpr int kThreads = 256;
constexpr int kRowsPerThread = kTileM * kTileN / kThreads;   // 4
constexpr int kRowStride = kThreads / kTileN;                // 8

__global__ void __launch_bounds__(kThreads)
cim_mvm_kernel(const float* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ fs, const float* __restrict__ gain,
               const float* __restrict__ offset, float* __restrict__ out,
               int M, int K, int N, int levels) {
  __shared__ float xs[kTileM][kChunk];
  __shared__ float ws[kChunk][kTileN];

  const int tid = threadIdx.x;
  const int tx = tid % kTileN;
  const int ty = tid / kTileN;
  const int m0 = blockIdx.y * kTileM;
  const int n0 = blockIdx.x * kTileN;
  const int n = n0 + tx;

  const float lsb = __fdiv_rn(fs[0], static_cast<float>(levels));
  const float g = (gain != nullptr && n < N) ? gain[n] : 1.f;
  const float off_lsb =
      __fmul_rn((offset != nullptr && n < N) ? offset[n] : 0.f, lsb);
  const float lo = static_cast<float>(-levels - 1);
  const float hi = static_cast<float>(levels);

  float acc[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kChunk) {
    for (int i = tid; i < kTileM * kChunk; i += kThreads) {
      const int r = i / kChunk, c = i % kChunk;
      const int m = m0 + r;
      xs[r][c] = m < M ? x[static_cast<size_t>(m) * K + k0 + c] : 0.f;
    }
    for (int i = tid; i < kChunk * kTileN; i += kThreads) {
      const int r = i / kTileN, c = i % kTileN;
      const int nn = n0 + c;
      ws[r][c] = nn < N ? w[static_cast<size_t>(k0 + r) * N + nn] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int r = ty + i * kRowStride;
      float psum = 0.f;
#pragma unroll 16
      for (int k = 0; k < kChunk; ++k) psum = fmaf(xs[r][k], ws[k][tx], psum);
      const float v = __fadd_rn(__fmul_rn(g, psum), off_lsb);
      const float code = fminf(fmaxf(rintf(__fdiv_rn(v, lsb)), lo), hi);
      acc[i] = __fadd_rn(acc[i], __fmul_rn(code, lsb));
    }
    __syncthreads();
  }

  if (n < N) {
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int m = m0 + ty + i * kRowStride;
      if (m < M) out[static_cast<size_t>(m) * N + n] = acc[i];
    }
  }
}

}  // namespace

// Launches one product on ``stream`` without synchronising.  Returns the
// launch's cudaError_t (0 = cudaSuccess); the Python wrapper raises on
// anything else.  The wrapper has checked devices, types, shapes and
// contiguity; ``gain`` and ``offset`` may both be null (the ideal ADC).
extern "C" int cim_mvm_launch(const float* x, const float* w, const float* fs,
                              const float* gain, const float* offset,
                              float* out, int M, int K, int N, int levels,
                              void* stream) {
  if (M < 1 || N < 1 || K < kChunk || K % kChunk != 0 || levels < 1)
    return cudaErrorInvalidValue;
  const dim3 grid((N + kTileN - 1) / kTileN, (M + kTileM - 1) / kTileM);
  cim_mvm_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, w, fs, gain, offset, out, M, K, N, levels);
  return static_cast<int>(cudaGetLastError());
}
