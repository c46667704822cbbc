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
// What bounds it on this card: at the main path's shapes, the launch.
// A round at B=32 slots, N=2 classes, R=4 samples moves about 7 KB (2 ns
// at 3.35 TB/s) and does some 6,000 flops, while an empty kernel alone
// costs about 0.8 µs by graph replay on the H100 (PERF.md).  So what
// counts is the dependent chain inside a block: one round trip of loads
// and a few hundred cycles of arithmetic, not R times that.
//
// The design: one block per slot (nothing carries over between blocks,
// so the TPU's sequential (nb, 2, nn) grid becomes work inside a block);
// the [R,B,N] logits never reach device memory.  The launcher takes the
// variant from kernels/decision.py (decision_plan), which routes by N:
//   small N (N <= 32, SAR's N = 2): a thread per (r, n) pair, the N
//          columns of a sample on np = next_pow2(N) neighbouring lanes
//          (at R <= 64, N = 2: at most 128 threads; pairs beyond 1024
//          threads loop).  sel[r,(b)], m[b], y_mu, x_sigma, x_sigsq and
//          the sample keys are staged in shared memory (rows padded to
//          17 floats: no bank conflicts), every load issued before any
//          is used, so staging is one memory round trip after the mask
//          byte (a masked slot stops there).  Each thread
//          computes its logit once: the 16-term mix in four interleaved
//          partial sums, the read noise, the scale.  The sample's
//          log-sum-exp over its np lanes is a segmented shuffle (padding
//          lanes are -inf), then p, p*log p and the entropy (another
//          segmented shuffle).  sum_p, sum_psq, sum_ent and sum_entsq are
//          fixed-shape trees: xor shuffles over the lanes of a column,
//          then the warps' partials in warp order.  The same tree on
//          every launch and no atomics: relaunches are bit-identical.
//   streaming (N > 32, vocab-scale N later): the first design's three
//          passes — an online (max, sumexp) per sample over N by a
//          warp, the entropy per sample, then per column the sums over
//          r — with every reduction in a fixed order.
//
// The previous design, for comparison: the streaming kernel for every N; at
// N = 2 two lanes of a warp worked, every logit was computed three times,
// and two threads walked all R samples in series.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hash.cuh"

namespace {

constexpr int kThreads = 128;        // the streaming variant
constexpr int kWarps = kThreads / 32;
constexpr int kMaxR = 64;
constexpr int kBasis = 16;
constexpr int kMaxSmallN = 32;       // the small-N variant's widest N
constexpr int kMaxSmallThreads = 1024;
constexpr int kRowPad = kBasis + 1;  // a staged sel or m row, padded
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

// Zero deltas for an inactive slot.
__device__ __forceinline__ void write_masked(const Params& p, int b) {
  const size_t row0 = static_cast<size_t>(b) * p.N;
  for (int n = threadIdx.x; n < p.N; n += blockDim.x) {
    p.sum_p[row0 + n] = 0.f;
    p.sum_psq[row0 + n] = 0.f;
  }
  if (threadIdx.x == 0) {
    p.sum_ent[b] = 0.f;
    p.sum_entsq[b] = 0.f;
  }
}

// The sample key of (r, b): int64 -> uint32 keeps the value mod 2^32, as
// the reference's cast.
__device__ __forceinline__ uint32_t sample_key(const Params& p, int r, int b) {
  return static_cast<uint32_t>(
      p.idx_per_slot ? p.sample_idx[static_cast<size_t>(r) * p.B + b]
                     : p.sample_idx[r]);
}

// Where staged item i of slot b comes from and goes to.  Items are, in
// order: sel[r, (b), j] (R·16), m[b, n, j] (N·16), y_mu[b, n], x_sigma[b, n]
// and, with read noise, x_sigsq[b, n] (N each).
struct Staging {
  float* sel_s;
  float* m_s;
  float* vec_s;    // [3][kMaxSmallN]: y_mu, x_sigma, x_sigsq
};

__device__ __forceinline__ const float* staged_src(const Params& p, int b,
                                                   int i, float** dst,
                                                   const Staging& st) {
  const size_t row0 = static_cast<size_t>(b) * p.N;
  const int n_sel = p.R * kBasis, n_m = p.N * kBasis;
  if (i < n_sel) {
    const int r = i / kBasis, j = i % kBasis;
    *dst = st.sel_s + r * kRowPad + j;
    return p.sel_per_slot
               ? p.sel + (static_cast<size_t>(r) * p.B + b) * kBasis + j
               : p.sel + static_cast<size_t>(r) * kBasis + j;
  }
  i -= n_sel;
  if (i < n_m) {
    *dst = st.m_s + (i / kBasis) * kRowPad + i % kBasis;
    return p.m + row0 * kBasis + i;
  }
  i -= n_m;
  const int which = i / p.N, n = i % p.N;
  *dst = st.vec_s + which * kMaxSmallN + n;
  return (which == 0 ? p.y_mu : which == 1 ? p.x_sigma : p.x_sigsq) + row0 + n;
}

// Small-N variant (N <= 32): one thread per (r, n) pair, n on the low
// log2(np) bits of the pair index, so a sample's columns are np
// neighbouring lanes of one warp.  blockDim.x is a multiple of 32 and at
// least R.
__global__ void __launch_bounds__(kMaxSmallThreads)
decision_stats_small_n_kernel(Params p, int np) {
  constexpr int kBatch = 8;            // staged loads a thread has in flight
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nthreads = blockDim.x;

  __shared__ float sel_s[kMaxR * kRowPad];
  __shared__ float m_s[kMaxSmallN * kRowPad];
  __shared__ float vec_s[3 * kMaxSmallN];
  __shared__ uint32_t key_s[kMaxR];
  __shared__ float red_p[kMaxSmallThreads / 32][kMaxSmallN];
  __shared__ float red_psq[kMaxSmallThreads / 32][kMaxSmallN];
  __shared__ float red_e[kMaxSmallThreads / 32], red_e2[kMaxSmallThreads / 32];

  // An inactive slot reads its mask byte and writes zeros, nothing more:
  // after round 0 most rounds of a dispatch find every slot decided.
  if (p.mask != nullptr && p.mask[b] == 0) {
    write_masked(p, b);
    return;
  }
  // Every other global load of the block (the keys, the slot id and the
  // staged rows) is issued before any is used, so staging costs one
  // memory round trip, not one per array.
  const bool noisy = p.read_sigma > 0.f;
  const uint32_t key = (noisy && tid < p.R) ? sample_key(p, tid, b) : 0u;
  const uint32_t row = (noisy && p.rows != nullptr)
                           ? static_cast<uint32_t>(p.rows[b])
                           : static_cast<uint32_t>(b);
  const Staging st{sel_s, m_s, vec_s};
  const int items = p.R * kBasis + p.N * (kBasis + (noisy ? 3 : 2));
  for (int base = 0; base < items; base += kBatch * nthreads) {
    float v[kBatch];
    float* dst[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = base + j * nthreads + tid;
      v[j] = i < items ? __ldg(staged_src(p, b, i, &dst[j], st)) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (base + j * nthreads + tid < items) *dst[j] = v[j];
  }
  if (tid < p.R) key_s[tid] = key;
  __syncthreads();
  const float* ymu_s = vec_s;
  const float* xsig_s = vec_s + kMaxSmallN;
  const float* xsq_s = vec_s + 2 * kMaxSmallN;
  const size_t row0 = static_cast<size_t>(b) * p.N;

  float sp = 0.f, spsq = 0.f, se = 0.f, se2 = 0.f;
  const int pairs = p.R * np;
  const int np_log2 = __ffs(np) - 1;
  for (int base = 0; base < pairs; base += nthreads) {   // uniform trip count
    const int pair = base + tid;
    const int r = pair >> np_log2, n = pair & (np - 1);
    const bool live = r < p.R;                 // a sample of this round
    const bool valid = live && n < p.N;        // and one of its columns
    float l = -INFINITY;
    if (valid) {
      const float* s = sel_s + r * kRowPad;
      const float* mm = m_s + n * kRowPad;
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
      for (int j = 0; j < kBasis; j += 4) {
        a0 = fmaf(s[j + 0], mm[j + 0], a0);
        a1 = fmaf(s[j + 1], mm[j + 1], a1);
        a2 = fmaf(s[j + 2], mm[j + 2], a2);
        a3 = fmaf(s[j + 3], mm[j + 3], a3);
      }
      float num = ((a0 + a1) + (a2 + a3)) - p.sum_mean * xsig_s[n];
      if (noisy) {
        const uint32_t h = repro_torch::hash3(
            key_s[r], row, static_cast<uint32_t>(n), p.noise_seed);
        num += repro_torch::gauss_of(h) *
               (p.read_sigma * sqrtf(fmaxf(xsq_s[n], 0.f)));
      }
      l = ymu_s[n] + num / p.sum_std;
    }
    float mx = l;                              // segmented max over np lanes
    for (int off = np >> 1; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, off));
    float e = valid ? expf(l - mx) : 0.f;
    for (int off = np >> 1; off > 0; off >>= 1)
      e += __shfl_xor_sync(kFullMask, e, off);
    const float lp = valid ? l - (mx + logf(e)) : 0.f;
    const float pr = valid ? expf(lp) : 0.f;
    float plp = pr * lp;
    for (int off = np >> 1; off > 0; off >>= 1)
      plp += __shfl_xor_sync(kFullMask, plp, off);
    sp += pr;
    spsq += pr * pr;
    if (live && n == 0) {                      // one lane per sample
      se -= plp;
      se2 += plp * plp;
    }
  }
  // sums over r: first the lanes of a column within the warp ...
  for (int off = 16; off >= np; off >>= 1) {
    sp += __shfl_xor_sync(kFullMask, sp, off);
    spsq += __shfl_xor_sync(kFullMask, spsq, off);
  }
  for (int off = 16; off > 0; off >>= 1) {
    se += __shfl_xor_sync(kFullMask, se, off);
    se2 += __shfl_xor_sync(kFullMask, se2, off);
  }
  if (lane < np && lane < p.N) {
    red_p[warp][lane] = sp;
    red_psq[warp][lane] = spsq;
  }
  if (lane == 0) {
    red_e[warp] = se;
    red_e2[warp] = se2;
  }
  __syncthreads();
  // ... then the warps' partials in warp order.
  const int warps = nthreads >> 5;
  if (tid < p.N) {
    float a = 0.f, a2 = 0.f;
    for (int w = 0; w < warps; ++w) {
      a += red_p[w][tid];
      a2 += red_psq[w][tid];
    }
    p.sum_p[row0 + tid] = a;
    p.sum_psq[row0 + tid] = a2;
  }
  if (tid == 0) {
    float a = 0.f, a2 = 0.f;
    for (int w = 0; w < warps; ++w) {
      a += red_e[w];
      a2 += red_e2[w];
    }
    p.sum_ent[b] = a;
    p.sum_entsq[b] = a2;
  }
}

// Streaming variant (any N; routed N > 32): three passes over N.
__global__ void __launch_bounds__(kThreads)
decision_stats_streaming_kernel(Params p) {
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t row0 = static_cast<size_t>(b) * p.N;

  if (p.mask != nullptr && p.mask[b] == 0) {   // inactive slot: zero deltas
    write_masked(p, b);
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
  for (int r = tid; r < p.R; r += kThreads)
    key_s[r] = noisy ? sample_key(p, r, b) : 0u;
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

// Launches one round on ``stream`` without synchronising, as the plan of
// kernels/decision.py says: ``np`` = 0 runs the streaming variant on
// 128 threads; ``np`` > 0 (a power of two, N <= np <= 32) the small-N
// variant on ``threads`` (a multiple of 32, at least R).  Returns the
// launch's cudaError_t (0 = cudaSuccess); cudaErrorInvalidValue for what
// the kernels do not take.  The wrapper has checked shapes, types, devices,
// contiguity and 16-byte alignment of m.
extern "C" int decision_stats_launch(
    const float* y_mu, const float* x_sigma, const float* m, const float* sel,
    const uint8_t* mask, const float* x_sigsq, const int64_t* sample_idx,
    const int64_t* rows, float* sum_p, float* sum_psq, float* sum_ent,
    float* sum_entsq, int B, int N, int R, int sel_per_slot, int idx_per_slot,
    float sum_mean, float sum_std, float read_sigma, unsigned int noise_seed,
    int np, int threads, void* stream) {
  if (B < 1 || N < 1 || R < 1 || R > kMaxR) return cudaErrorInvalidValue;
  if (np != 0 && (np < N || np > kMaxSmallN || (np & (np - 1)) != 0 ||
                  threads < 32 || threads > kMaxSmallThreads ||
                  threads % 32 != 0 || threads < R))  // a key_s[r] each
    return cudaErrorInvalidValue;
  if (np == 0 && threads != kThreads) return cudaErrorInvalidValue;
  if (read_sigma > 0.f && (x_sigsq == nullptr || sample_idx == nullptr))
    return cudaErrorInvalidValue;
  Params p{y_mu,      x_sigma,      m,        sel,       mask,
           x_sigsq,   sample_idx,   rows,     sum_p,     sum_psq,
           sum_ent,   sum_entsq,    B,        N,         R,
           sel_per_slot, idx_per_slot, sum_mean, sum_std, read_sigma,
           noise_seed};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (np != 0)
    decision_stats_small_n_kernel<<<B, threads, 0, s>>>(p, np);
  else
    decision_stats_streaming_kernel<<<B, kThreads, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}
