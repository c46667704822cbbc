// Fused Bayesian head for Hopper (sm_90a): R logit samples
//   Y_r = x . (mu' + sigma (.) eps_r)
// of the weight-decomposition head, with eps never stored: the device
// currents are hashed at the point of use, as the paper's write-free
// GRNG generates them in the sigma-eps subarray.
//
// Replaces: the Pallas TPU kernel bayes_mvm_pallas
//   (repro/kernels/bayes_mvm.py:202), both of its modes:
//   bayes_rank16  mode 'rank16', body _rank16_kernel :58 (call :226)
//   bayes_paper   mode 'paper',  body _paper_kernel  :130 (call :248)
//
// What they compute (all float32; x [B,K], mu/sigma [K,N] float32 or
// bfloat16, loaded as float32; sel [R,16]; out [R,B,N]):
//   rank16  y = x.mu, xs = x.sigma, m_j = x.(sigma (.) I_j) for the 16
//           devices, xq = (x^2).(sigma^2) when read_sigma > 0; then
//           out[r] = y + (sum_j sel[r,j] m_j - sum_mean xs
//                    + read_sigma sqrt(max(xq,0))
//                      gauss(hash3(sample0+r, b, col0+n, noise_seed)))
//                    * inv_std
//           (the read noise as its exact logit-level projection,
//           bayes_mvm.py:96-124).
//   paper   eps_r[k,n] = ((sum_j sel[r,j] I_j) + read_noise(k,n,sample0+r)
//                        - sum_mean) * inv_std, the grng_eps kernel's
//           arithmetic; out[r] = x.mu + x.(sigma (.) eps_r).  With the
//           6-bit ADC (levels = 31) each 64-row partial sum, of x.mu and
//           of every x.(sigma eps_r) separately, becomes
//           clip(rint(psum / lsb), -32, 31) * lsb, lsb = fs / 31 (fs[0]
//           for mu, fs[1] for sigma-eps, read on the device), and the
//           codes accumulate in chunk order; the chunks are rows
//           64c .. 64c+63 of x (bayes_mvm.py:153-169).
//
// What bounds them on this card: operations.  At kernel_bench's head
// (B=8, K=512, N=2048) they move about 9.7 MB (2.9 us at 3.35 TB/s);
// rank16 does ~0.4 GFLOP (18 products of 2BKN plus the currents and the
// mix, ~6 us at the float32 rate) and paper at R=20 ~1.1 GFLOP (~16 us).
// Both hash 16.8 M device currents (K N 16), integer work beside the
// float count that may well set the pace.
//
// What the design does about it: one block owns a 16-column x 8-row
// output tile and walks K in steps of 16 rows, the TPU's sequential k
// grid axis as a loop inside the block.  Per step, every (k, n) cell's
// 16 currents are hashed once, by one thread, and reused by all B rows
// and all R samples of the block: rank16 stores sigma (.) I_j for the 16
// devices in shared memory, paper stores sigma (.) eps_r for the block's
// samples.  Then each of the 128 threads accumulates its (b, n) output:
// rank16 its 19 sums, paper its RC sample sums (and RC chunk sums with
// the ADC) in registers.  R above the block's RC (a template: 4, 8, 16,
// 24 or 32) is split over the grid's z axis, which re-hashes the
// currents for each R chunk rather than spilling accumulators.  The
// currents, eps, ADC and epilogue are written with round-to-nearest
// intrinsics (no FMA contraction), as the plain PyTorch versions round
// them; only the K sums' order differs.  No atomics: two launches give
// the same bits.  Tensor cores, TMA and a split over K are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hash.cuh"

namespace {

using repro_torch::GrngParams;

constexpr int kTileN = 16;     // output columns a block
constexpr int kTileB = 8;      // output rows (batch) a block
constexpr int kTileK = 16;     // K rows a step
constexpr int kThreads = kTileN * kTileB;            // 128
constexpr int kCells = kTileK * kTileN;              // 256 a step
constexpr int kDevices = 16;
constexpr int kChunk = 64;     // ADC accumulation depth
static_assert(kChunk % kTileK == 0, "a step must not straddle ADC chunks");
static_assert(kTileB * kTileK == kThreads, "one x element a thread");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// The x tile [kTileB][kTileK] of step k0, zero outside [B, K].
template <typename TX>
__device__ __forceinline__ void load_x(const TX* __restrict__ x,
                                       float (*xs)[kTileK], int tid, int b0,
                                       int k0, int B, int K) {
  const int bb = tid / kTileK, kk = tid % kTileK;
  const int gb = b0 + bb, gk = k0 + kk;
  xs[bb][kk] = (gb < B && gk < K)
                   ? to_f32(x[static_cast<size_t>(gb) * K + gk]) : 0.f;
}

template <typename TX, typename TW>
__global__ void __launch_bounds__(kThreads)
bayes_rank16_kernel(const TX* __restrict__ x, const TW* __restrict__ mu,
                    const TW* __restrict__ sigma,
                    const float* __restrict__ sel, float* __restrict__ out,
                    int B, int K, int N, int R, uint32_t row0, uint32_t col0,
                    uint32_t sample0, GrngParams p) {
  __shared__ float xs[kTileB][kTileK];
  __shared__ float mus[kTileK][kTileN];
  __shared__ float sgs[kTileK][kTileN];
  __shared__ float basis[kDevices][kTileK][kTileN];

  const int tid = threadIdx.x;
  const int tx = tid % kTileN, ty = tid / kTileN;
  const int n0 = blockIdx.x * kTileN, b0 = blockIdx.y * kTileB;
  const bool noisy = p.read_sigma != 0.f;

  float acc_mu = 0.f, acc_xs = 0.f, acc_xq = 0.f;
  float acc[kDevices];
#pragma unroll
  for (int j = 0; j < kDevices; ++j) acc[j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kTileK) {
    load_x(x, xs, tid, b0, k0, B, K);
    for (int c = tid; c < kCells; c += kThreads) {
      const int kk = c / kTileN, nn = c % kTileN;
      const int gk = k0 + kk, gn = n0 + nn;
      const bool valid = gk < K && gn < N;
      const size_t at = static_cast<size_t>(gk) * N + gn;
      const float s = valid ? to_f32(sigma[at]) : 0.f;
      mus[kk][nn] = valid ? to_f32(mu[at]) : 0.f;
      sgs[kk][nn] = s;
#pragma unroll
      for (int j = 0; j < kDevices; ++j)
        basis[j][kk][nn] =
            valid ? __fmul_rn(s, repro_torch::device_current(
                                     row0 + gk, col0 + gn, j, p))
                  : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kTileK; ++kk) {
      const float xv = xs[ty][kk];
      const float s = sgs[kk][tx];
      acc_mu = fmaf(xv, mus[kk][tx], acc_mu);
      acc_xs = fmaf(xv, s, acc_xs);
      if (noisy) acc_xq = fmaf(__fmul_rn(xv, xv), __fmul_rn(s, s), acc_xq);
#pragma unroll
      for (int j = 0; j < kDevices; ++j)
        acc[j] = fmaf(xv, basis[j][kk][tx], acc[j]);
    }
    __syncthreads();
  }

  const int b = b0 + ty, n = n0 + tx;
  if (b >= B || n >= N) return;
  const float sigma_read =
      noisy ? __fmul_rn(p.read_sigma, sqrtf(fmaxf(acc_xq, 0.f))) : 0.f;
  const float mean_xs = __fmul_rn(p.sum_mean, acc_xs);
  for (int r = 0; r < R; ++r) {
    const float* s = sel + r * kDevices;
    float mixed = 0.f;
#pragma unroll
    for (int j = 0; j < kDevices; ++j)
      mixed = __fadd_rn(mixed, __fmul_rn(__ldg(s + j), acc[j]));
    float num = __fsub_rn(mixed, mean_xs);
    if (noisy)
      num = __fadd_rn(num, __fmul_rn(repro_torch::gauss_of(repro_torch::hash3(
                                         sample0 + r, b, col0 + n,
                                         p.noise_seed)),
                                     sigma_read));
    out[(static_cast<size_t>(r) * B + b) * N + n] =
        __fadd_rn(acc_mu, __fmul_rn(num, p.inv_std));
  }
}

__device__ __forceinline__ float adc(float v, float lsb, float lo, float hi) {
  const float code = fminf(fmaxf(rintf(__fdiv_rn(v, lsb)), lo), hi);
  return __fmul_rn(code, lsb);
}

template <typename TX, typename TW, int RC>
__global__ void __launch_bounds__(kThreads)
bayes_paper_kernel(const TX* __restrict__ x, const TW* __restrict__ mu,
                   const TW* __restrict__ sigma,
                   const float* __restrict__ sel,
                   const float* __restrict__ fs, float* __restrict__ out,
                   int B, int K, int N, int R, uint32_t row0, uint32_t col0,
                   uint32_t sample0, int levels, GrngParams p) {
  __shared__ float xs[kTileB][kTileK];
  __shared__ float mus[kTileK][kTileN];
  __shared__ float sels[RC][kDevices];
  __shared__ float se[RC][kTileK][kTileN];

  const int tid = threadIdx.x;
  const int tx = tid % kTileN, ty = tid / kTileN;
  const int n0 = blockIdx.x * kTileN, b0 = blockIdx.y * kTileB;
  const int r0 = blockIdx.z * RC;
  const int rc = min(RC, R - r0);
  const bool noisy = p.read_sigma != 0.f;
  for (int i = tid; i < RC * kDevices; i += kThreads)
    sels[i / kDevices][i % kDevices] =
        i < rc * kDevices ? sel[r0 * kDevices + i] : 0.f;

  float lsb_mu = 0.f, lsb_se = 0.f;
  const float lo = static_cast<float>(-levels - 1);
  const float hi = static_cast<float>(levels);
  if (levels > 0) {
    lsb_mu = __fdiv_rn(fs[0], static_cast<float>(levels));
    lsb_se = __fdiv_rn(fs[1], static_cast<float>(levels));
  }

  float ps_mu = 0.f, acc_mu = 0.f;
  float ps[RC], acc[RC];
#pragma unroll
  for (int r = 0; r < RC; ++r) ps[r] = acc[r] = 0.f;

  __syncthreads();
  for (int k0 = 0; k0 < K; k0 += kTileK) {
    load_x(x, xs, tid, b0, k0, B, K);
    for (int c = tid; c < kCells; c += kThreads) {
      const int kk = c / kTileN, nn = c % kTileN;
      const int gk = k0 + kk, gn = n0 + nn;
      const bool valid = gk < K && gn < N;
      const size_t at = static_cast<size_t>(gk) * N + gn;
      mus[kk][nn] = valid ? to_f32(mu[at]) : 0.f;
      int r = 0;
      if (valid) {
        const float s = to_f32(sigma[at]);
        const uint32_t row = row0 + gk, col = col0 + gn;
        float cur[kDevices];
#pragma unroll
        for (int j = 0; j < kDevices; ++j)
          cur[j] = repro_torch::device_current(row, col, j, p);
        for (; r < rc; ++r) {
          float raw = 0.f;
#pragma unroll
          for (int j = 0; j < kDevices; ++j)
            raw = __fadd_rn(raw, __fmul_rn(sels[r][j], cur[j]));
          if (noisy)
            raw = __fadd_rn(raw, repro_torch::read_noise(
                                     row, col, sample0 + r0 + r, p));
          const float eps = __fmul_rn(__fsub_rn(raw, p.sum_mean), p.inv_std);
          se[r][kk][nn] = __fmul_rn(s, eps);
        }
      }
      for (; r < RC; ++r) se[r][kk][nn] = 0.f;
    }
    __syncthreads();
#pragma unroll 2
    for (int kk = 0; kk < kTileK; ++kk) {
      const float xv = xs[ty][kk];
      ps_mu = fmaf(xv, mus[kk][tx], ps_mu);
#pragma unroll
      for (int r = 0; r < RC; ++r) ps[r] = fmaf(xv, se[r][kk][tx], ps[r]);
    }
    __syncthreads();
    const bool chunk_end = (k0 + kTileK) % kChunk == 0 || k0 + kTileK >= K;
    if (levels > 0 && chunk_end) {
      acc_mu = __fadd_rn(acc_mu, adc(ps_mu, lsb_mu, lo, hi));
      ps_mu = 0.f;
#pragma unroll
      for (int r = 0; r < RC; ++r) {
        acc[r] = __fadd_rn(acc[r], adc(ps[r], lsb_se, lo, hi));
        ps[r] = 0.f;
      }
    }
  }

  const int b = b0 + ty, n = n0 + tx;
  if (b >= B || n >= N) return;
  if (levels == 0) {
    acc_mu = ps_mu;
#pragma unroll
    for (int r = 0; r < RC; ++r) acc[r] = ps[r];
  }
#pragma unroll
  for (int r = 0; r < RC; ++r)
    if (r < rc)
      out[(static_cast<size_t>(r0 + r) * B + b) * N + n] =
          __fadd_rn(acc_mu, acc[r]);
}

// The samples a paper-mode block carries: the least RC >= R, or 32 (and
// R split over grid z).
int paper_rc(int R) {
  static const int kRcs[] = {4, 8, 16, 24};
  for (int rc : kRcs) if (R <= rc) return rc;
  return 32;
}

template <typename TX, typename TW>
int launch_paper(const void* x, const void* mu, const void* sigma,
                 const float* sel, const float* fs, float* out, int B, int K,
                 int N, int R, uint32_t row0, uint32_t col0, uint32_t sample0,
                 int levels, const GrngParams& p, cudaStream_t stream) {
  const int rc = paper_rc(R);
  const dim3 grid((N + kTileN - 1) / kTileN, (B + kTileB - 1) / kTileB,
                  (R + rc - 1) / rc);
  if (grid.y > 65535u || grid.z > 65535u) return cudaErrorInvalidValue;
  const auto* xx = static_cast<const TX*>(x);
  const auto* mm = static_cast<const TW*>(mu);
  const auto* ss = static_cast<const TW*>(sigma);
#define REPRO_PAPER(RCV)                                                   \
  bayes_paper_kernel<TX, TW, RCV><<<grid, kThreads, 0, stream>>>(          \
      xx, mm, ss, sel, fs, out, B, K, N, R, row0, col0, sample0, levels, p)
  switch (rc) {
    case 4: REPRO_PAPER(4); break;
    case 8: REPRO_PAPER(8); break;
    case 16: REPRO_PAPER(16); break;
    case 24: REPRO_PAPER(24); break;
    default: REPRO_PAPER(32); break;
  }
#undef REPRO_PAPER
  return static_cast<int>(cudaGetLastError());
}

template <typename TX, typename TW>
int launch_rank16(const void* x, const void* mu, const void* sigma,
                  const float* sel, float* out, int B, int K, int N, int R,
                  uint32_t row0, uint32_t col0, uint32_t sample0,
                  const GrngParams& p, cudaStream_t stream) {
  const dim3 grid((N + kTileN - 1) / kTileN, (B + kTileB - 1) / kTileB);
  if (grid.y > 65535u) return cudaErrorInvalidValue;
  bayes_rank16_kernel<TX, TW><<<grid, kThreads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(mu),
      static_cast<const TW*>(sigma), sel, out, B, K, N, R, row0, col0,
      sample0, p);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int B, int K, int N, int R, const GrngParams* p) {
  return B < 1 || K < 1 || N < 1 || R < 1 || p == nullptr;
}

}  // namespace

// Launch entry points: one head product on ``stream`` without
// synchronising; ``p`` is a host pointer, copied into the launch.
// ``x_bf16``/``w_bf16`` select bfloat16 for x and for mu/sigma (else
// float32).  Each returns the launch's cudaError_t (0 = cudaSuccess); the
// Python wrapper raises on anything else.  The wrapper has checked
// devices, types, shapes and contiguity.
extern "C" int bayes_rank16_launch(const void* x, const void* mu,
                                   const void* sigma, const float* sel,
                                   float* out, int B, int K, int N, int R,
                                   unsigned int row0, unsigned int col0,
                                   unsigned int sample0, int x_bf16,
                                   int w_bf16, const GrngParams* p,
                                   void* stream) {
  if (bad_shape(B, K, N, R, p)) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  using BF = __nv_bfloat16;
  if (x_bf16 && w_bf16)
    return launch_rank16<BF, BF>(x, mu, sigma, sel, out, B, K, N, R, row0,
                                 col0, sample0, *p, st);
  if (x_bf16)
    return launch_rank16<BF, float>(x, mu, sigma, sel, out, B, K, N, R, row0,
                                    col0, sample0, *p, st);
  if (w_bf16)
    return launch_rank16<float, BF>(x, mu, sigma, sel, out, B, K, N, R, row0,
                                    col0, sample0, *p, st);
  return launch_rank16<float, float>(x, mu, sigma, sel, out, B, K, N, R,
                                     row0, col0, sample0, *p, st);
}

// ``levels``: 0 for no ADC, else the ADC's largest code (31 at 6 bits);
// ``fs`` [2] on the device then holds the mu and sigma-eps full scales.
extern "C" int bayes_paper_launch(const void* x, const void* mu,
                                  const void* sigma, const float* sel,
                                  const float* fs, float* out, int B, int K,
                                  int N, int R, unsigned int row0,
                                  unsigned int col0, unsigned int sample0,
                                  int levels, int x_bf16, int w_bf16,
                                  const GrngParams* p, void* stream) {
  if (bad_shape(B, K, N, R, p) || levels < 0 || (levels > 0 && !fs))
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  using BF = __nv_bfloat16;
  if (x_bf16 && w_bf16)
    return launch_paper<BF, BF>(x, mu, sigma, sel, fs, out, B, K, N, R, row0,
                                col0, sample0, levels, *p, st);
  if (x_bf16)
    return launch_paper<BF, float>(x, mu, sigma, sel, fs, out, B, K, N, R,
                                   row0, col0, sample0, levels, *p, st);
  if (w_bf16)
    return launch_paper<float, BF>(x, mu, sigma, sel, fs, out, B, K, N, R,
                                   row0, col0, sample0, levels, *p, st);
  return launch_paper<float, float>(x, mu, sigma, sel, fs, out, B, K, N, R,
                                    row0, col0, sample0, levels, *p, st);
}
