// Fused decision update for Hopper (sm_90a): one escalation round of the
// SAR triage engine (and of an LM's token decision), from the rank-16
// activation basis to the masked deltas of the running predictive
// statistics.
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
//   p = softmax_n(logit), ent[r] = -sum_n p*log p, and writes the deltas
//   sum_p[b,n] = sum_r p, sum_psq[b,n] = sum_r p^2,
//   sum_ent[b] = sum_r ent, sum_entsq[b] = sum_r ent^2,
//   all zero for a slot whose mask is 0.  row[b] is rows[b], or row0 + b:
//   a slot shard hashes its read noise with its global slot ids.
//
// Accumulate epilogue (``accumulate`` = 1, the wrapper's ``out=stats``):
//   the four outputs are the running statistics, and an active slot adds
//   each delta into them in place, one float32 add an element
//   (__fadd_rn: never contracted), exactly as ``stats[key] += delta[key]``
//   after a delta launch; a masked slot writes nothing.  The small-N
//   variant loads the sums it adds into with its staged operands, so the
//   read-modify-write adds no memory round trip at the end.  One launch then
//   folds a round into statistics that stay on the launch's device: no
//   delta buffers, no add kernels after it, and a slot shard (a range of
//   slots on one device, ``row0`` its first global slot, the selections
//   and stream indices read through their leading strides ``sel_ld`` and
//   ``idx_ld`` without a copy) needs no concatenation.
//
// The launcher takes the variant from kernels/decision.py
// (decision_plan), which routes by N.  Every reduction below is a
// fixed-shape tree or a fixed order and no sum uses an atomic, so
// relaunches are bit-identical; nothing is allocated or synchronised
// here, so a round is capturable in a CUDA graph.
//
// small N (N <= 32, SAR's N = 2).  What bounds it: the launch.  A round
//   at B=32 slots, N=2 classes, R=4 samples moves about 7 KB (2 ns at
//   3.35 TB/s) and does some 6,000 flops, while an empty kernel alone
//   costs about 1 µs by graph replay on the H100 (PERF.md).  So what
//   counts is the dependent chain inside a block: one round trip of
//   loads and a few hundred cycles of arithmetic.  One block per slot,
//   a thread per (r, n) pair, the N columns of a sample on np =
//   next_pow2(N) neighbouring lanes (at R <= 64, N = 2: at most 128
//   threads; pairs beyond 1024 threads loop).  sel[r,(b)], m[b], y_mu,
//   x_sigma, x_sigsq and the sample keys are staged in shared memory
//   (rows padded to 17 floats: no bank conflicts), every load issued
//   before any is used, so staging is one memory round trip after the
//   mask byte (a masked slot stops there).  Each thread computes its
//   logit once: the 16-term mix in four interleaved partial sums, the
//   read noise, the scale.  The sample's log-sum-exp over its np lanes
//   is a segmented shuffle (padding lanes are -inf), then p, p*log p and
//   the entropy (another segmented shuffle).  sum_p, sum_psq, sum_ent
//   and sum_entsq are fixed-shape trees: xor shuffles over the lanes of
//   a column, then the warps' partials in warp order.
//
// tiled (N > 32; an LM's vocabulary, N = 152,064).  What bounds it: the
//   bytes of the basis (m is 64 B a column: 48.7 MB at B 4) against
//   3.35 TB/s, ~15 µs; at R = 20 the float work (535 MFLOP, 8 µs at
//   67 TFLOP/s) comes close.  So the round has to run on every SM at any
//   B, read each column's operands once a phase, and spend few
//   instructions a logit beyond its 16 multiply-adds and one exp.
//   Hence N is split into tiles of 256 columns, two a thread, and three
//   kernels run on the stream.  At the LM's B 4 that is 594 tiles a slot,
//   2,376 blocks, about 18 a SM; of the widths 128, 256 and 512 timed
//   there (PERF.md), 256 was the fastest.
//   A (partials), grid (tiles, B) of 128 threads: a thread holds its 2
//     columns' operands in registers (m as four float4 loads, y_mu,
//     sum_mean·x_sigma and, on a die, the read-noise scale and the two
//     of hash3's three mixes that do not depend on r: one mix32 a
//     (r, n)).  For each group of 4 samples it computes its 4·2 logits
//     (no branch, so the chains interleave; the 16-term mix in four
//     partial sums), the warp's max of each sample, then S1 = Σ e^(l-max)
//     and S2 = Σ e^(l-max)·(l-max), both by transposed xor trees: each
//     exchange halves the samples a lane keeps, so four samples cost
//     about the shuffles of two.  The trees, and every sum after them,
//     are float64: the standard errors the engine derives from sum_ent
//     and sum_entsq difference squares of ~6, and an entropy off by one
//     float32 ulp moves them by ~1e-4 (chip_smoke.py lm_card_vs_cpu
//     holds them to 1e-4); in float64 the card lands where a float64
//     plain version does.  One thread per sample folds the four warps'
//     (max, S1, S2) in warp order into the tile's and writes it to a
//     scratch buffer the wrapper allocates.
//   M (merge), grid (R, B) of 256 threads: the row's max M over the
//     tiles' maxima, then each tile's sums scaled to it and added, in
//     float64 (thread t takes tiles t, t+256, ... in order, then an xor
//     butterfly in each warp, then the warps in order), give
//     Z = Σ e^(l-M) and S2 = Σ e^(l-M)·(l-M), a tile (m_t, S1_t, S2_t)
//     adding e^d·S1_t and e^d·(S2_t + d·S1_t), d = m_t - M (kernel A
//     folds its warps the same way, a pair at a time).  lse = M + log Z
//     and ent = log Z - S2/Z, since
//     Σ p·log p = (1/Z)·Σ e^(l-M)·((l-M) - log Z) = S2/Z - log Z.  So
//     the entropy needs no second pass over N; both of its terms are
//     >= 0, and S2 stays shifted by the max because the unshifted
//     Σ e^(l-M)·l cancels in float32.
//   B (sums), A's grid walked backwards (last slot, last tile first, so
//     the columns A read last may still be in L2, and the next round's
//     A starts where this one ends): each thread recomputes its
//     columns' logits from the same loads, p = e^(l - lse[r]) for r in
//     order, and writes sum_p and sum_psq: no reduction across threads.
//     Grid column 0's block also folds its slot's entropies in sample
//     order into sum_ent and sum_entsq, in float64 rounded once.  The
//     logits are recomputed, not kept: at R = 20, B 4 they are 48.7 MB,
//     more than the card's shared memory, and writing them out moves
//     more bytes than reading m again.
//   Three launches, not a cooperative grid barrier (2,376 blocks at B 4
//   would have to be co-resident) nor a last-block election (its
//   counter would need zeroing every call, and a stale one fails
//   silently); an extra graph node costs about 1 µs.  A masked slot's
//   blocks read its mask byte and stop; B's write its zeros (nothing
//   when accumulating).  Every
//   float32 exponential is expf, as the plain version's (the SFU's
//   ex2.approx alone would add up to ~1e-6 of relative error a term,
//   its argument's rounding scaled by |l - M|).  The logit scales by
//   1/sum_std (a multiply, within 1 ulp of the plain version's
//   division).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hash.cuh"

namespace {

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
  const int64_t* rows;       // [B] uint32 values, or null = row0 + arange(B)
  float* sum_p;              // [B, N] deltas, or the running sums (accumulate)
  float* sum_psq;            // [B, N]
  float* sum_ent;            // [B]
  float* sum_entsq;          // [B]
  int B, N, R;
  int sel_per_slot, idx_per_slot;
  int sel_ld, idx_ld;        // slots between samples' rows of sel / sample_idx
  float sum_mean, sum_std, read_sigma;
  uint32_t noise_seed;
  uint32_t row0;             // the global slot id of slot 0
  int accumulate;
};

// Writes one statistic: the delta, or (accumulate) the running sum plus
// the delta, rounded once.
__device__ __forceinline__ void put(const Params& p, float* dst, float v) {
  *dst = p.accumulate ? __fadd_rn(*dst, v) : v;
}

// The read-noise row of slot b.
__device__ __forceinline__ uint32_t slot_row(const Params& p, int b) {
  return p.rows != nullptr ? static_cast<uint32_t>(p.rows[b])
                           : p.row0 + static_cast<uint32_t>(b);
}

// Zero deltas for an inactive slot (a delta launch only: an accumulating
// one leaves its statistics as they are).
__device__ __forceinline__ void write_masked(const Params& p, int b) {
  if (p.accumulate) return;
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
      p.idx_per_slot ? p.sample_idx[static_cast<size_t>(r) * p.idx_ld + b]
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
               ? p.sel + (static_cast<size_t>(r) * p.sel_ld + b) * kBasis + j
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

  // An inactive slot reads its mask byte and writes zeros (nothing when
  // accumulating), nothing more: after round 0 most rounds of a dispatch
  // find every slot decided.
  if (p.mask != nullptr && p.mask[b] == 0) {
    write_masked(p, b);
    return;
  }
  // Every other global load of the block (the keys, the slot id and the
  // staged rows) is issued before any is used, so staging costs one
  // memory round trip, not one per array.
  const bool noisy = p.read_sigma > 0.f;
  const uint32_t key = (noisy && tid < p.R) ? sample_key(p, tid, b) : 0u;
  const uint32_t row = noisy ? slot_row(p, b) : 0u;
  // Accumulating, the running sums this thread adds into at the end are
  // loaded here with the rest, so their round trip hides behind staging.
  const size_t row0 = static_cast<size_t>(b) * p.N;
  float old_p = 0.f, old_psq = 0.f, old_e = 0.f, old_e2 = 0.f;
  if (p.accumulate && tid < p.N) {
    old_p = p.sum_p[row0 + tid];
    old_psq = p.sum_psq[row0 + tid];
  }
  if (p.accumulate && tid == 0) {
    old_e = p.sum_ent[b];
    old_e2 = p.sum_entsq[b];
  }
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
    p.sum_p[row0 + tid] = p.accumulate ? __fadd_rn(old_p, a) : a;
    p.sum_psq[row0 + tid] = p.accumulate ? __fadd_rn(old_psq, a2) : a2;
  }
  if (tid == 0) {
    float a = 0.f, a2 = 0.f;
    for (int w = 0; w < warps; ++w) {
      a += red_e[w];
      a2 += red_e2[w];
    }
    p.sum_ent[b] = p.accumulate ? __fadd_rn(old_e, a) : a;
    p.sum_entsq[b] = p.accumulate ? __fadd_rn(old_e2, a2) : a2;
  }
}

// ---------------------------------------------------------------------
// Tiled variant (N > 32): partials, merge, sums.
// ---------------------------------------------------------------------
constexpr int kTiledThreads = 128;   // a block of kernels A and B
constexpr int kCols = 2;             // columns a thread of kernels A and B
constexpr int kTile = kCols * kTiledThreads;   // columns a tile
constexpr int kTiledWarps = kTiledThreads / 32;
constexpr int kGroup = 4;            // samples a reduction of kernel A takes
static_assert(kGroup == 4, "kernel A's transposed trees are written for 4");
constexpr int kMergeThreads = 256;

// (max, Σ e^(l-max), Σ e^(l-max)·(l-max)) over some logits of one
// sample, the sums in float64; m = -inf when empty.
struct Part {
  float m;
  double s1, s2;
};

__device__ __forceinline__ Part merge_part(const Part& a, const Part& b) {
  const float mn = fmaxf(a.m, b.m);
  Part o{mn, 0.0, 0.0};
  if (a.m != -INFINITY) {
    const double d = static_cast<double>(a.m) - mn, e = exp(d);
    o.s1 = e * a.s1;
    o.s2 = e * (a.s2 + d * a.s1);
  }
  if (b.m != -INFINITY) {
    const double d = static_cast<double>(b.m) - mn, e = exp(d);
    o.s1 += e * b.s1;
    o.s2 += e * (b.s2 + d * b.s1);
  }
  return o;
}

// The operands of a thread's kCols columns n = n0 + q*128 + threadIdx.x;
// columns past N hold zeros (their logits are computed and dropped).
template <bool kNoisy>
struct Columns {
  float4 m[kCols][kBasis / 4];
  float y[kCols];       // y_mu
  float smx[kCols];     // sum_mean * x_sigma, rounded as the plain version
  float sr[kCols];      // read_sigma * sqrt(max(x_sigsq, 0))
  uint32_t pre[kCols];  // hash3's mixes of (column, row): one left per r
  bool valid[kCols];    // n < N
};

template <bool kNoisy>
__device__ __forceinline__ void load_columns(const Params& p, int b, int n0,
                                             Columns<kNoisy>& c) {
  const uint32_t row = kNoisy ? slot_row(p, b) : 0u;
#pragma unroll
  for (int q = 0; q < kCols; ++q) {
    const int n = n0 + q * kTiledThreads + static_cast<int>(threadIdx.x);
    c.valid[q] = n < p.N;
    c.y[q] = c.smx[q] = c.sr[q] = 0.f;
    c.pre[q] = 0u;
#pragma unroll
    for (int j = 0; j < kBasis / 4; ++j) c.m[q][j] = make_float4(0, 0, 0, 0);
    if (!c.valid[q]) continue;
    const size_t bn = static_cast<size_t>(b) * p.N + n;
    const float4* m4 = reinterpret_cast<const float4*>(p.m + bn * kBasis);
#pragma unroll
    for (int j = 0; j < kBasis / 4; ++j) c.m[q][j] = __ldg(m4 + j);
    c.y[q] = __ldg(p.y_mu + bn);
    c.smx[q] = p.sum_mean * __ldg(p.x_sigma + bn);
    if (kNoisy) {
      c.sr[q] = p.read_sigma * sqrtf(fmaxf(__ldg(p.x_sigsq + bn), 0.f));
      c.pre[q] = repro_torch::col_prefix(row, static_cast<uint32_t>(n),
                                         p.noise_seed);
    }
  }
}

// Logit of column q for the sample of selection row s and key ``key``:
// the 16-term mix in four interleaved partial sums; the read noise by
// hash3(key, row, n, seed) = row_hash(key, col_prefix(row, n, seed)).
// No branch: a thread's kCols columns (and kernel A's samples) interleave.
template <bool kNoisy>
__device__ __forceinline__ float tiled_logit(const Columns<kNoisy>& c,
                                             int q,
                                             const float4 (&s)[kBasis / 4],
                                             uint32_t key, float inv_std) {
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
  for (int j = 0; j < kBasis / 4; ++j) {
    a0 = fmaf(s[j].x, c.m[q][j].x, a0);
    a1 = fmaf(s[j].y, c.m[q][j].y, a1);
    a2 = fmaf(s[j].z, c.m[q][j].z, a2);
    a3 = fmaf(s[j].w, c.m[q][j].w, a3);
  }
  float num = ((a0 + a1) + (a2 + a3)) - c.smx[q];
  if (kNoisy) {
    num += repro_torch::gauss_of(repro_torch::row_hash(key, c.pre[q])) *
           c.sr[q];
  }
  return c.y[q] + num * inv_std;
}

// The round's selection rows of slot b and, with read noise, its sample
// keys, into shared memory.
template <bool kNoisy>
__device__ __forceinline__ void stage_round(const Params& p, int b,
                                            float* sel_s, uint32_t* key_s) {
  for (int i = threadIdx.x; i < p.R * kBasis; i += blockDim.x) {
    const int r = i / kBasis, j = i % kBasis;
    sel_s[i] = p.sel_per_slot
                   ? p.sel[(static_cast<size_t>(r) * p.sel_ld + b) * kBasis + j]
                   : p.sel[static_cast<size_t>(r) * kBasis + j];
  }
  if (kNoisy)
    for (int r = threadIdx.x; r < p.R; r += blockDim.x)
      key_s[r] = sample_key(p, r, b);
}

__device__ __forceinline__ void load_sel(const float* sel_s, int r,
                                         float4 (&s)[kBasis / 4]) {
  const float4* s4 = reinterpret_cast<const float4*>(sel_s + r * kBasis);
#pragma unroll
  for (int j = 0; j < kBasis / 4; ++j) s[j] = s4[j];
}

// A: the (max, S1, S2) of every (slot, tile, sample) into pm[B][R][tiles]
// (float) and ps[2][B][R][tiles] (float64).  Grid (tiles, B), 128
// threads.  Samples go in
// groups of kGroup: the warp's max and sums of a group's samples are
// transposed xor trees (each exchange halves the samples a lane keeps,
// so kGroup samples cost about as many shuffles as two), after which
// lanes 8g..8g+7 hold sample g's.
template <bool kNoisy>
__global__ void __launch_bounds__(kTiledThreads)
decision_tiled_partials_kernel(Params p, float* pm, double* ps,
                               int tiles) {
  const int tile = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (p.mask != nullptr && p.mask[b] == 0) return;   // no partials needed

  __shared__ __align__(16) float sel_s[kMaxR * kBasis];
  __shared__ uint32_t key_s[kMaxR];
  __shared__ float wmax[kTiledWarps][kMaxR];
  __shared__ double wsum[2][kTiledWarps][kMaxR];

  Columns<kNoisy> c;
  load_columns<kNoisy>(p, b, tile * kTile, c);
  stage_round<kNoisy>(p, b, sel_s, key_s);
  __syncthreads();
  const float inv_std = 1.f / p.sum_std;
  const bool hi16 = lane & 16, hi8 = lane & 8;
  const int mine = lane >> 3;              // the sample a lane ends with

  for (int r0 = 0; r0 < p.R; r0 += kGroup) {
    float l[kGroup][kCols], mx[kGroup];
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      const bool live = r0 + g < p.R;
      const int r = live ? r0 + g : r0;
      float4 s[kBasis / 4];
      load_sel(sel_s, r, s);
      const uint32_t key = kNoisy ? key_s[r] : 0u;
      mx[g] = -INFINITY;
#pragma unroll
      for (int q = 0; q < kCols; ++q) {
        const float v = tiled_logit<kNoisy>(c, q, s, key, inv_std);
        l[g][q] = (live && c.valid[q]) ? v : -INFINITY;
        mx[g] = fmaxf(mx[g], l[g][q]);
      }
    }
    // the warp's max of each sample: scatter to lanes 8g.., then gather
    float k0 = hi16 ? mx[2] : mx[0], k1 = hi16 ? mx[3] : mx[1];
    k0 = fmaxf(k0, __shfl_xor_sync(kFullMask, hi16 ? mx[0] : mx[2], 16));
    k1 = fmaxf(k1, __shfl_xor_sync(kFullMask, hi16 ? mx[1] : mx[3], 16));
    float k = hi8 ? k1 : k0;
    k = fmaxf(k, __shfl_xor_sync(kFullMask, hi8 ? k0 : k1, 8));
#pragma unroll
    for (int off = 4; off > 0; off >>= 1)
      k = fmaxf(k, __shfl_xor_sync(kFullMask, k, off));
    // S1 and S2 against the warp's max; a dropped logit (-inf, or a warp
    // past N whose max is -inf) has d = -1e30, e = 0
    float s1[kGroup], s2[kGroup];
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      const float wm = __shfl_sync(kFullMask, k, 8 * g);
      s1[g] = s2[g] = 0.f;
#pragma unroll
      for (int q = 0; q < kCols; ++q) {
        const float d = fmaxf(l[g][q] - wm, -1e30f), e = expf(d);
        s1[g] += e;
        s2[g] = fmaf(e, d, s2[g]);
      }
    }
    // the warp's sums of each sample, scattered the same way, in
    // float64: the entropy log Z - S2/Z has to stay within a fraction of
    // an ulp for the standard errors' cancelling differences
    double a0 = hi16 ? s1[2] : s1[0], a1 = hi16 ? s1[3] : s1[1];
    double b0 = hi16 ? s2[2] : s2[0], b1 = hi16 ? s2[3] : s2[1];
    a0 += __shfl_xor_sync(kFullMask, double(hi16 ? s1[0] : s1[2]), 16);
    a1 += __shfl_xor_sync(kFullMask, double(hi16 ? s1[1] : s1[3]), 16);
    b0 += __shfl_xor_sync(kFullMask, double(hi16 ? s2[0] : s2[2]), 16);
    b1 += __shfl_xor_sync(kFullMask, double(hi16 ? s2[1] : s2[3]), 16);
    double u = hi8 ? a1 : a0, v = hi8 ? b1 : b0;
    u += __shfl_xor_sync(kFullMask, hi8 ? a0 : a1, 8);
    v += __shfl_xor_sync(kFullMask, hi8 ? b0 : b1, 8);
#pragma unroll
    for (int off = 4; off > 0; off >>= 1) {
      u += __shfl_xor_sync(kFullMask, u, off);
      v += __shfl_xor_sync(kFullMask, v, off);
    }
    if ((lane & 7) == 0 && r0 + mine < p.R) {
      wmax[warp][r0 + mine] = k;
      wsum[0][warp][r0 + mine] = u;
      wsum[1][warp][r0 + mine] = v;
    }
  }
  __syncthreads();
  const size_t plane = static_cast<size_t>(p.B) * p.R * tiles;
  for (int r = tid; r < p.R; r += kTiledThreads) {
    Part t{-INFINITY, 0.0, 0.0};
#pragma unroll
    for (int w = 0; w < kTiledWarps; ++w)
      t = merge_part(t, Part{wmax[w][r], wsum[0][w][r], wsum[1][w][r]});
    const size_t i = (static_cast<size_t>(b) * p.R + r) * tiles + tile;
    pm[i] = t.m;
    ps[i] = t.s1;
    ps[plane + i] = t.s2;
  }
}

// M: lse[b][r] (float) and ent[b][r] (float64) from sample r's tile
// partials.  Grid (R, B), kMergeThreads threads.  First the row's max M
// over the tiles (exact: thread t takes tiles t, t + 256, ..., then a
// warp butterfly, then the warps); then thread t sums its tiles'
// e^(m_t - M)·S1_t and e^(m_t - M)·(S2_t + (m_t - M)·S1_t) in order, an
// xor butterfly in each warp and the warps in order add them: one
// float64 exp a tile and no dependent chain of them.
__global__ void __launch_bounds__(kMergeThreads)
decision_tiled_merge_kernel(Params p, const float* pm, const double* ps,
                            float* lse, double* ent, int tiles) {
  constexpr int kWarps = kMergeThreads / 32;
  const int r = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (p.mask != nullptr && p.mask[b] == 0) return;
  __shared__ float wm[kWarps];
  __shared__ double ws[2][kWarps];
  const size_t plane = static_cast<size_t>(p.B) * p.R * tiles;
  const size_t row0 = (static_cast<size_t>(b) * p.R + r) * tiles;
  float mx = -INFINITY;
  for (int t = tid; t < tiles; t += kMergeThreads)
    mx = fmaxf(mx, pm[row0 + t]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, off));
  if (lane == 0) wm[warp] = mx;
  __syncthreads();
  float big_m = wm[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) big_m = fmaxf(big_m, wm[w]);
  double z = 0.0, s2 = 0.0;
  for (int t = tid; t < tiles; t += kMergeThreads) {
    const double d = static_cast<double>(pm[row0 + t]) - big_m;
    const double e = exp(d), s1 = ps[row0 + t];
    z += e * s1;
    s2 += e * (ps[plane + row0 + t] + d * s1);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    z += __shfl_xor_sync(kFullMask, z, off);
    s2 += __shfl_xor_sync(kFullMask, s2, off);
  }
  if (lane == 0) {
    ws[0][warp] = z;
    ws[1][warp] = s2;
  }
  __syncthreads();
  if (tid == 0) {
    z = s2 = 0.0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      z += ws[0][w];
      s2 += ws[1][w];
    }
    const double log_z = log(z);
    const size_t i = static_cast<size_t>(b) * p.R + r;
    lse[i] = static_cast<float>(big_m + log_z);
    ent[i] = log_z - s2 / z;
  }
}

// B: sum_p and sum_psq of a tile's columns, samples in order; the block
// of grid column 0 also folds its slot's entropies in sample order.
// Grid (tiles, B), 128 threads, walked in the reverse of A's order
// (last slot, last tile first): the columns A read last are likeliest
// still in L2, and the next round's A, in A's order, starts where this
// one ends.
template <bool kNoisy>
__global__ void __launch_bounds__(kTiledThreads)
decision_tiled_sums_kernel(Params p, const float* lse, const double* ent) {
  const int tile = gridDim.x - 1 - blockIdx.x;
  const int b = gridDim.y - 1 - blockIdx.y;
  const int n0 = tile * kTile;
  const size_t row0 = static_cast<size_t>(b) * p.N;
  const bool active = p.mask == nullptr || p.mask[b] != 0;
  if (blockIdx.x == 0 && threadIdx.x == 0 && (active || !p.accumulate)) {
    double se = 0.0, se2 = 0.0;                   // rounded to float once
    for (int r = 0; active && r < p.R; ++r) {
      const double e = ent[static_cast<size_t>(b) * p.R + r];
      se += e;
      se2 += e * e;
    }
    put(p, p.sum_ent + b, static_cast<float>(se));
    put(p, p.sum_entsq + b, static_cast<float>(se2));
  }
  if (!active) {          // inactive slot: zeros, or nothing (accumulate)
    if (p.accumulate) return;
#pragma unroll
    for (int q = 0; q < kCols; ++q) {
      const int n = n0 + q * kTiledThreads + static_cast<int>(threadIdx.x);
      if (n < p.N) {
        p.sum_p[row0 + n] = 0.f;
        p.sum_psq[row0 + n] = 0.f;
      }
    }
    return;
  }
  __shared__ __align__(16) float sel_s[kMaxR * kBasis];
  __shared__ uint32_t key_s[kMaxR];
  __shared__ float lse_s[kMaxR];

  Columns<kNoisy> c;
  load_columns<kNoisy>(p, b, n0, c);
  stage_round<kNoisy>(p, b, sel_s, key_s);
  for (int r = threadIdx.x; r < p.R; r += kTiledThreads)
    lse_s[r] = lse[static_cast<size_t>(b) * p.R + r];
  __syncthreads();
  const float inv_std = 1.f / p.sum_std;

  float sp[kCols], spsq[kCols];
#pragma unroll
  for (int q = 0; q < kCols; ++q) sp[q] = spsq[q] = 0.f;
  for (int r = 0; r < p.R; ++r) {
    float4 s[kBasis / 4];
    load_sel(sel_s, r, s);
    const uint32_t key = kNoisy ? key_s[r] : 0u;
    const float lr = lse_s[r];
#pragma unroll
    for (int q = 0; q < kCols; ++q) {
      const float pr =
          expf(tiled_logit<kNoisy>(c, q, s, key, inv_std) - lr);
      sp[q] += pr;
      spsq[q] = fmaf(pr, pr, spsq[q]);
    }
  }
#pragma unroll
  for (int q = 0; q < kCols; ++q) {
    if (c.valid[q]) {
      const int n = n0 + q * kTiledThreads + static_cast<int>(threadIdx.x);
      put(p, p.sum_p + row0 + n, sp[q]);
      put(p, p.sum_psq + row0 + n, spsq[q]);
    }
  }
}

template <bool kNoisy>
int launch_tiled_kernels(const Params& p, float* scratch, cudaStream_t s) {
  const int tiles = (p.N + kTile - 1) / kTile;
  const size_t br = static_cast<size_t>(p.B) * p.R;
  double* ps = reinterpret_cast<double*>(scratch);     // [2][B][R][tiles]
  double* ent = ps + 2 * br * tiles;                   // [B][R]
  float* pm = reinterpret_cast<float*>(ent + br);      // [B][R][tiles]
  float* lse = pm + br * tiles;                        // [B][R]
  const dim3 grid(tiles, p.B);
  decision_tiled_partials_kernel<kNoisy>
      <<<grid, kTiledThreads, 0, s>>>(p, pm, ps, tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decision_tiled_merge_kernel<<<dim3(p.R, p.B), kMergeThreads, 0, s>>>(
      p, pm, ps, lse, ent, tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decision_tiled_sums_kernel<kNoisy>
      <<<grid, kTiledThreads, 0, s>>>(p, lse, ent);
  return static_cast<int>(cudaGetLastError());
}

int launch_tiled(const Params& p, float* scratch, cudaStream_t s) {
  return p.read_sigma > 0.f ? launch_tiled_kernels<true>(p, scratch, s)
                            : launch_tiled_kernels<false>(p, scratch, s);
}

}  // namespace

// Launches one round on ``stream`` without synchronising, as the plan of
// kernels/decision.py says: ``tile`` > 0 runs the tiled variant's three
// kernels over tiles of ``tile`` = 256 columns on
// ``threads`` = 128, with ``scratch`` (8-byte aligned) holding
// 5·B·R·tiles + 3·B·R floats (tiles = ceil(N / tile)); ``tile`` = 0
// runs the small-N variant:
// ``np`` a power of two, N <= np <= 32, on ``threads`` (a multiple of
// 32, at least R).  ``sel_ld`` / ``idx_ld``: slots between consecutive
// samples' rows of per-slot selections / stream indices (B when
// contiguous; a slot shard's view of a wider round passes the round's);
// ``row0``: the read-noise row of slot 0 when ``rows`` is null;
// ``accumulate``: add the deltas of active slots into sum_* in place.
// Returns the first launch's cudaError_t that is not cudaSuccess (0);
// cudaErrorInvalidValue for what the kernels do not take.  The wrapper
// has checked shapes, types, devices, strides and 16-byte alignment of m.
extern "C" int decision_stats_launch(
    const float* y_mu, const float* x_sigma, const float* m, const float* sel,
    const uint8_t* mask, const float* x_sigsq, const int64_t* sample_idx,
    const int64_t* rows, float* sum_p, float* sum_psq, float* sum_ent,
    float* sum_entsq, int B, int N, int R, int sel_per_slot, int idx_per_slot,
    int sel_ld, int idx_ld, float sum_mean, float sum_std, float read_sigma,
    unsigned int noise_seed, unsigned int row0, int accumulate, int np,
    int threads, int tile, float* scratch, void* stream) {
  if (B < 1 || N < 1 || R < 1 || R > kMaxR) return cudaErrorInvalidValue;
  if ((sel_per_slot && sel_ld < B) || (idx_per_slot && idx_ld < B))
    return cudaErrorInvalidValue;
  if (tile == 0 && (np < N || np > kMaxSmallN || (np & (np - 1)) != 0 ||
                    threads < 32 || threads > kMaxSmallThreads ||
                    threads % 32 != 0 || threads < R))  // a key_s[r] each
    return cudaErrorInvalidValue;
  if (tile != 0 && (threads != kTiledThreads || scratch == nullptr ||
                    reinterpret_cast<uintptr_t>(scratch) % 8 != 0 ||
                    B > 65535))                 // grid.y
    return cudaErrorInvalidValue;
  if (read_sigma > 0.f && (x_sigsq == nullptr || sample_idx == nullptr))
    return cudaErrorInvalidValue;
  Params p{y_mu,      x_sigma,      m,        sel,        mask,
           x_sigsq,   sample_idx,   rows,     sum_p,      sum_psq,
           sum_ent,   sum_entsq,    B,        N,          R,
           sel_per_slot, idx_per_slot, sel_ld, idx_ld,   sum_mean,
           sum_std,   read_sigma,   noise_seed, row0,     accumulate};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 0:
      decision_stats_small_n_kernel<<<B, threads, 0, s>>>(p, np);
      return static_cast<int>(cudaGetLastError());
    case kTile: return launch_tiled(p, scratch, s);
    default: return cudaErrorInvalidValue;
  }
}
