// Fused decision update for Hopper (sm_90a): one escalation round of the
// SAR triage engine, from the rank-16 activation basis to the masked
// deltas of the running predictive statistics.
//
// Replaces: the Pallas TPU kernel decision_stats_pallas
//   (repro/kernels/decision_kernel.py:165, body _decision_kernel :98,
//    helper _mix_logits :69).
//
// What it computes, per slot b and sample r (all float32):
//   logit[r,n] = y_mu[b,n] + (sel[r,b,:]·m[b,n,:] - sum_mean*x_sigma[b,n]
//                + gauss(hash3(idx[r,b], row[b], n, seed))
//                  * read_sigma * sqrt(max(x_sigsq[b,n], 0))) / sum_std
//   (the read-noise term only when read_sigma > 0), then
//   p = softmax_n(logit), ent[r] = -sum_n p*log p, and writes
//   sum_p[b,n] = sum_r p, sum_psq[b,n] = sum_r p^2,
//   sum_ent[b] = sum_r ent, sum_entsq[b] = sum_r ent^2,
//   all zero for a slot whose mask is 0.
//
// What bounds it on this card: bytes.  At the main path's shape (B=32
// slots, N=2 classes, R=4 samples) a round reads y_mu, x_sigma [32,2],
// m [32,2,16], sel [4,32,16] and mask [32] and writes four small stat
// arrays: about 14 KB, some 4 ns at 3.35 TB/s, against a few thousand
// flops.  In practice the launch itself dominates.
//
// What the design does about it: each input byte is read from device
// memory once per phase (the re-reads of m hit L1), the [R,B,N] logits
// never exist in global memory, and one launch does the whole round.
// One thread block per slot: nothing carries over between blocks, so
// the TPU's sequential (nb, 2, nn) grid becomes loops inside the block.
//   pass 1  each warp takes samples r; its lanes stride over N keeping
//           an online (max, sumexp), reduced across the warp by shuffles
//           into lse[r] in shared memory;
//   pass 2  each warp recomputes its samples' logits against lse[r] and
//           reduces the entropy; each thread accumulates sum_p and
//           sum_psq of its columns over r in registers;
//   end     thread 0 sums ent[r] and ent[r]^2 over r in order.
// Every reduction has a fixed order and there are no atomics, so two
// launches on the same inputs give the same bits.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hash.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxR = 64;
constexpr int kBasis = 16;
constexpr unsigned kFullMask = 0xFFFFFFFFu;

struct Params {
  const float* y_mu;         // [B, N]
  const float* x_sigma;      // [B, N]
  const float* m;            // [B, N, 16]
  const float* sel;          // [R, B, 16] or [R, 16]
  const uint8_t* mask;       // [B] bool, or null = all active
  const float* x_sigsq;      // [B, N] (read noise only)
  const int64_t* sample_idx; // [R, B] or [R] uint32 values (read noise only)
  const int64_t* rows;       // [B] uint32 values, or null = arange(B)
  float* sum_p;              // [B, N]
  float* sum_psq;            // [B, N]
  float* sum_ent;            // [B]
  float* sum_entsq;          // [B]
  int B, N, R;
  int sel_per_slot, idx_per_slot;
  float sum_mean, sum_std, read_sigma;
  uint32_t noise_seed;
};

__device__ __forceinline__ float logit_at(const Params& p, const float* sel_r,
                                          uint32_t key, uint32_t row, int b,
                                          int n) {
  const size_t bn = static_cast<size_t>(b) * p.N + n;
  const float4* m4 = reinterpret_cast<const float4*>(p.m + bn * kBasis);
  float mix = 0.f;
#pragma unroll
  for (int q = 0; q < kBasis / 4; ++q) {
    const float4 v = m4[q];
    mix += sel_r[4 * q + 0] * v.x;
    mix += sel_r[4 * q + 1] * v.y;
    mix += sel_r[4 * q + 2] * v.z;
    mix += sel_r[4 * q + 3] * v.w;
  }
  float num = mix - p.sum_mean * p.x_sigma[bn];
  if (p.read_sigma > 0.f) {
    const uint32_t h = repro_torch::hash3(key, row, static_cast<uint32_t>(n),
                                          p.noise_seed);
    num += repro_torch::gauss_of(h) *
           (p.read_sigma * sqrtf(fmaxf(p.x_sigsq[bn], 0.f)));
  }
  return p.y_mu[bn] + num / p.sum_std;
}

__global__ void __launch_bounds__(kThreads) decision_stats_kernel(Params p) {
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t row0 = static_cast<size_t>(b) * p.N;

  if (p.mask != nullptr && p.mask[b] == 0) {   // inactive slot: zero deltas
    for (int n = tid; n < p.N; n += kThreads) {
      p.sum_p[row0 + n] = 0.f;
      p.sum_psq[row0 + n] = 0.f;
    }
    if (tid == 0) {
      p.sum_ent[b] = 0.f;
      p.sum_entsq[b] = 0.f;
    }
    return;
  }

  __shared__ float sel_s[kMaxR * kBasis];
  __shared__ uint32_t key_s[kMaxR];
  __shared__ float lse_s[kMaxR];
  __shared__ float ent_s[kMaxR];

  for (int i = tid; i < p.R * kBasis; i += kThreads) {
    const int r = i / kBasis, j = i % kBasis;
    sel_s[i] = p.sel_per_slot
                   ? p.sel[(static_cast<size_t>(r) * p.B + b) * kBasis + j]
                   : p.sel[static_cast<size_t>(r) * kBasis + j];
  }
  const bool noisy = p.read_sigma > 0.f;
  for (int r = tid; r < p.R; r += kThreads) {
    // int64 -> uint32 keeps the value mod 2^32, as the reference's cast
    key_s[r] = !noisy ? 0u
               : static_cast<uint32_t>(
                     p.idx_per_slot ? p.sample_idx[static_cast<size_t>(r) * p.B + b]
                                    : p.sample_idx[r]);
  }
  const uint32_t row = (noisy && p.rows != nullptr)
                           ? static_cast<uint32_t>(p.rows[b])
                           : static_cast<uint32_t>(b);
  __syncthreads();

  // pass 1: online (max, sumexp) over N per sample -> lse[r]
  for (int r = warp; r < p.R; r += kWarps) {
    const float* sel_r = sel_s + r * kBasis;
    float mx = -INFINITY, s = 0.f;
    for (int n = lane; n < p.N; n += 32) {
      const float l = logit_at(p, sel_r, key_s[r], row, b, n);
      if (l > mx) {
        s = s * expf(mx - l) + 1.f;
        mx = l;
      } else {
        s += expf(l - mx);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float mo = __shfl_xor_sync(kFullMask, mx, off);
      const float so = __shfl_xor_sync(kFullMask, s, off);
      const float mn = fmaxf(mx, mo);
      s = (mn == -INFINITY) ? 0.f : s * expf(mx - mn) + so * expf(mo - mn);
      mx = mn;
    }
    if (lane == 0) lse_s[r] = mx + logf(s);
  }
  __syncthreads();

  // pass 2a: entropy of each sample, reduced across its warp
  for (int r = warp; r < p.R; r += kWarps) {
    const float* sel_r = sel_s + r * kBasis;
    const float lse = lse_s[r];
    float acc = 0.f;
    for (int n = lane; n < p.N; n += 32) {
      const float lp = logit_at(p, sel_r, key_s[r], row, b, n) - lse;
      acc += expf(lp) * lp;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(kFullMask, acc, off);
    if (lane == 0) ent_s[r] = -acc;
  }

  // pass 2b: per-column probability sums over the samples
  for (int n = tid; n < p.N; n += kThreads) {
    float sp = 0.f, spsq = 0.f;
    for (int r = 0; r < p.R; ++r) {
      const float pr =
          expf(logit_at(p, sel_s + r * kBasis, key_s[r], row, b, n) - lse_s[r]);
      sp += pr;
      spsq += pr * pr;
    }
    p.sum_p[row0 + n] = sp;
    p.sum_psq[row0 + n] = spsq;
  }
  __syncthreads();

  if (tid == 0) {
    float se = 0.f, se2 = 0.f;
    for (int r = 0; r < p.R; ++r) {
      se += ent_s[r];
      se2 += ent_s[r] * ent_s[r];
    }
    p.sum_ent[b] = se;
    p.sum_entsq[b] = se2;
  }
}

}  // namespace

// Launches one round on ``stream`` without synchronising.  Returns the
// launch's cudaError_t (0 = cudaSuccess); the Python wrapper raises on
// anything else.  The wrapper has checked shapes, types, devices,
// contiguity and 16-byte alignment of m.
extern "C" int decision_stats_launch(
    const float* y_mu, const float* x_sigma, const float* m, const float* sel,
    const uint8_t* mask, const float* x_sigsq, const int64_t* sample_idx,
    const int64_t* rows, float* sum_p, float* sum_psq, float* sum_ent,
    float* sum_entsq, int B, int N, int R, int sel_per_slot, int idx_per_slot,
    float sum_mean, float sum_std, float read_sigma, unsigned int noise_seed,
    void* stream) {
  if (B < 1 || N < 1 || R < 1 || R > kMaxR) return cudaErrorInvalidValue;
  if (read_sigma > 0.f && (x_sigsq == nullptr || sample_idx == nullptr))
    return cudaErrorInvalidValue;
  Params p{y_mu,      x_sigma,      m,        sel,       mask,
           x_sigsq,   sample_idx,   rows,     sum_p,     sum_psq,
           sum_ent,   sum_entsq,    B,        N,         R,
           sel_per_slot, idx_per_slot, sum_mean, sum_std, read_sigma,
           noise_seed};
  decision_stats_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
