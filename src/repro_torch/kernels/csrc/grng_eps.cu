// Write-free CLT-GRNG block for Hopper (sm_90a): the standardized subset
// sums eps[r, k, n] of a weight block, from the hashed virtual devices.
//
// Replaces: the Pallas TPU kernel grng_eps_pallas
//   (repro/kernels/clt_grng_kernel.py:103, body _grng_kernel :80).
//
// What it computes (all float32), for cell (k, n) at global coordinates
// (row, col) = (row0 + k, col0 + n) and sample r of R:
//   raw = 0; for j = 0..15 in order: raw += sel[r, j] * I(row, col, j)
//   raw += read_sigma * gauss(hash3(row, col, sample0 + r, noise_seed))
//                                                  (read_sigma > 0 only)
//   eps[r, k, n] = (raw - sum_mean) * inv_std      (f32(1 / sum_std))
// with I the device current of hash.cuh, each step rounded to nearest,
// so the kernel gives the plain PyTorch version's bits.
//
// What bounds it on this card: bytes, nominally.  At Fig. 9's block
// (256 x 256, R = 8) it writes 2.1 MB (0.63 us at 3.35 TB/s, less than a
// launch); at 512 x 2048, R = 20, 84 MB (25 us).  Beside them is integer
// work with no peak in the float table: 16 hashed currents a cell and, on
// a noisy die, one hashed draw an eps, each a chain of dependent integer
// operations on the half-rate integer pipes.  At Fig. 9's block a block
// hashes, then stores, so the two do not overlap: the kernel is the
// launch, the hashing and the stores at the write bandwidth in a row.
//
// The design.  A block owns 32 columns (a warp's, so a warp stores 128
// contiguous bytes a row) by 16 rows; a thread owns two cells of its
// column, rows k and k + 8.
//   prefixes  hash3(k, n, j, seed) = row_hash(k, col_prefix(n, j, seed))
//             (hash.cuh): the block computes the column prefixes of its
//             32 columns once, for the 16 devices (and the imprint seed
//             on an aged die) and for the staged samples' read noise,
//             each key prefix once a warp, lane-parallel; a current or a
//             noise draw then costs one mix32: 16 + R a cell on a noisy
//             die, 48 + 3R before.
//   tables    a current is a function of its hash's top bit and byte sum
//             b0 + b1 + b2 alone (gauss is (sum - 382.5) * scale), so the
//             block tabulates the 2 x 766 currents, and imprint * gauss
//             and read_sigma * gauss by byte sum, with hash.cuh's
//             arithmetic; a hash word gives its table's byte offset in one
//             dp4a (4 sum + 3072 bit).  A current is then a mix32, a dp4a
//             and a shared load, with the bits of the formula.
//   currents  a thread hashes its two cells' 32 currents once, independent
//             chains, into registers, and reuses them for every sample.
//   sum       a stage whose selection rows hold only 0.0 and 1.0 (what
//             core/lfsr's swapper gives: eight ones a sample) sums a cell
//             as 16 fused multiply-adds raw = fma(sel_j, I_j, raw): the
//             product sel_j I_j is exact (I_j or a zero), so the one
//             rounding of the fused add is the rounding of the separate
//             add, and the sum has the product chain's bits with half its
//             operations.  A stage with any other value takes the product
//             chain: the same function computed the same way, not a
//             fallback.  The block learns which when it stages the rows
//             (__syncthreads_and), so the branch is uniform.
//   samples   the selections and the noise prefixes of up to 64 samples
//             are staged in shared memory at a time; the first stage's
//             loads are issued before the tables, which hide their
//             latency.  R > 64 takes further stages with the currents
//             kept in registers.
//   stores    streaming (st.global.cs): eps is written once, never read
//             back here.  Each value is computed whether or not its cell
//             is inside K x N and only the store is predicated, so the
//             compiler keeps no divergent region around a sample.  Ragged
//             K and N are masked: the output is never padded.
// No atomics and no order that depends on the schedule: two launches
// give the same bits.
//
// The previous design, for comparison: a thread a cell on a grid of
// 32 x 8 cells, each current a full hash3 chain (3 mix32), bytes through
// int->float conversions, per sample 16 separately rounded multiplies and
// adds and a full hash3 for the read noise.  Times of both: PERF.md.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hash.cuh"

namespace {

using repro_torch::col_hash;
using repro_torch::current_of;
using repro_torch::gauss_of_sum;
using repro_torch::GrngParams;
using repro_torch::key_prefix;
using repro_torch::row_hash;

constexpr int kCols = 32;              // a block's columns: one warp wide
constexpr int kWarps = 8;              // a block's rows a pass: one a warp
constexpr int kCells = 2;              // rows a thread: k and k + kWarps
constexpr int kThreads = kCols * kWarps;
constexpr int kDevices = 16;
constexpr int kStage = 64;             // samples staged at a time
constexpr int kSums = 768;             // byte sums 0..765, padded
constexpr int kLoads = kStage * kDevices / kThreads;

struct Shared {
  float sel[kStage][kDevices];         // the staged selection rows
  uint32_t noise[kStage][kCols];       // read-noise prefixes [r][column]
  uint32_t cur[kDevices][kCols];       // current prefixes [j][column]
  uint32_t imp[kDevices][kCols];       // imprint prefixes [j][column]
  float cur_tab[2 * kSums];            // current by (top bit, byte sum)
  float imp_tab[kSums];                // imprint * gauss by byte sum
  float noise_tab[kSums];              // read_sigma * gauss by byte sum
};

// A table's entry at a byte offset: 4 (b0 + b1 + b2) of a hash word, and
// 4 * kSums more when its top bit is set (cur_offset).
__device__ __forceinline__ float entry(const float* table, uint32_t offset) {
  return *reinterpret_cast<const float*>(
      reinterpret_cast<const char*>(table) + offset);
}
__device__ __forceinline__ uint32_t cur_offset(uint32_t h) {
  return __dp4a(h & 0x80FFFFFFu, 0x18040404u, 0u);
}
__device__ __forceinline__ uint32_t sum_offset(uint32_t h) {
  return __dp4a(h, 0x00040404u, 0u);
}

// st.global.cs under a predicate, the value computed either way.
__device__ __forceinline__ void store_if(float* ptr, float v, bool on) {
  asm volatile(
      "{\n .reg .pred q;\n setp.ne.b32 q, %2, 0;\n"
      " @q st.global.cs.f32 [%0], %1;\n}\n" ::"l"(ptr),
      "f"(v), "r"(static_cast<int>(on)));
}

// A stage's selection rows, rc of them from row r0: load issues this
// thread's elements, store puts them in shared memory and says whether
// all of them are 0.0 or 1.0.
__device__ __forceinline__ void load_sel(float (&v)[kLoads], const float* sel,
                                         int r0, int rc) {
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    v[i] = e < rc * kDevices
               ? __ldg(sel + static_cast<size_t>(r0) * kDevices + e)
               : 0.f;
  }
}
__device__ __forceinline__ bool store_sel(Shared& s, const float (&v)[kLoads],
                                          int rc) {
  bool fused = true;
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    if (e < rc * kDevices) {
      (&s.sel[0][0])[e] = v[i];
      fused = fused && (v[i] == 0.f || v[i] == 1.f);
    }
  }
  return fused;
}

// The read-noise prefixes col_prefix(col, sample0 + r, noise_seed) of a
// stage's samples, each sample's key prefix computed lane-parallel.
template <bool kNoisy>
__device__ __forceinline__ void noise_prefixes(Shared& s, int r0, int rc,
                                               uint32_t col, uint32_t sample0,
                                               const GrngParams& p) {
  if constexpr (kNoisy) {
    const int lane = threadIdx.x & (kCols - 1), warp = threadIdx.x / kCols;
    const uint32_t first = sample0 + static_cast<uint32_t>(r0);
    const uint32_t key_lo = key_prefix(first + lane, p.noise_seed);
    const uint32_t key_hi =
        rc > kCols ? key_prefix(first + kCols + lane, p.noise_seed) : 0u;
    for (int r = warp; r < rc; r += kWarps) {  // r is uniform in the warp
      const uint32_t key =
          __shfl_sync(0xFFFFFFFFu, r < kCols ? key_lo : key_hi, r & 31);
      s.noise[r][lane] = col_hash(col, key);
    }
  }
}

// One sample's sum of a cell's 16 currents, in order j = 0..15.
template <bool kFused>
__device__ __forceinline__ float mix(const float4* s4, const float* cur) {
  float raw = 0.f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float4 v = s4[q];
    if constexpr (kFused) {
      raw = fmaf(v.x, cur[4 * q], raw);
      raw = fmaf(v.y, cur[4 * q + 1], raw);
      raw = fmaf(v.z, cur[4 * q + 2], raw);
      raw = fmaf(v.w, cur[4 * q + 3], raw);
    } else {
      raw = __fadd_rn(raw, __fmul_rn(v.x, cur[4 * q]));
      raw = __fadd_rn(raw, __fmul_rn(v.y, cur[4 * q + 1]));
      raw = __fadd_rn(raw, __fmul_rn(v.z, cur[4 * q + 2]));
      raw = __fadd_rn(raw, __fmul_rn(v.w, cur[4 * q + 3]));
    }
  }
  return raw;
}

template <bool kImprint, bool kNoisy>
__global__ void __launch_bounds__(kThreads, 2)
grng_eps_kernel(const float* __restrict__ sel, float* __restrict__ out,
                int R, int K, int N, uint32_t row0, uint32_t col0,
                uint32_t sample0, GrngParams p) {
  __shared__ __align__(16) Shared s;
  const int lane = threadIdx.x & (kCols - 1), warp = threadIdx.x / kCols;
  const int n = blockIdx.x * kCols + lane;
  const int k0 = blockIdx.y * (kWarps * kCells) + warp;
  const uint32_t col = col0 + static_cast<uint32_t>(n);

  float staged[kLoads];
  int rc = min(R, kStage);
  load_sel(staged, sel, 0, rc);
#pragma unroll
  for (int u = 0; u < kSums / kThreads; ++u) {   // the tables
    const int sum = threadIdx.x + u * kThreads;
    const float g = gauss_of_sum(static_cast<float>(sum));
    s.cur_tab[sum] = current_of(0u, g, p);
    s.cur_tab[kSums + sum] = current_of(1u, g, p);
    if constexpr (kImprint) s.imp_tab[sum] = __fmul_rn(p.imprint, g);
    if constexpr (kNoisy) s.noise_tab[sum] = __fmul_rn(p.read_sigma, g);
  }
  {  // the column prefixes of the 16 devices: warp w fills j = w, w + 8
    const uint32_t key = key_prefix(lane, p.seed);
    const uint32_t key_i = kImprint ? key_prefix(lane, p.imprint_seed) : 0u;
#pragma unroll
    for (int u = 0; u < kDevices / kWarps; ++u) {
      const int j = warp + u * kWarps;
      s.cur[j][lane] = col_hash(col, __shfl_sync(0xFFFFFFFFu, key, j));
      if constexpr (kImprint)
        s.imp[j][lane] = col_hash(col, __shfl_sync(0xFFFFFFFFu, key_i, j));
    }
  }
  noise_prefixes<kNoisy>(s, 0, rc, col, sample0, p);
  bool fused = __syncthreads_and(store_sel(s, staged, rc));

  uint32_t row[kCells];
  bool in[kCells];
#pragma unroll
  for (int c = 0; c < kCells; ++c) {
    const int k = k0 + c * kWarps;
    row[c] = row0 + static_cast<uint32_t>(k);
    in[c] = n < N && k < K;
  }
  float cur[kCells][kDevices];
#pragma unroll
  for (int j = 0; j < kDevices; ++j) {
    const uint32_t pc = s.cur[j][lane], pi = kImprint ? s.imp[j][lane] : 0u;
#pragma unroll
    for (int c = 0; c < kCells; ++c) {
      cur[c][j] = entry(s.cur_tab, cur_offset(row_hash(row[c], pc)));
      if constexpr (kImprint)
        cur[c][j] = __fadd_rn(
            cur[c][j], entry(s.imp_tab, sum_offset(row_hash(row[c], pi))));
    }
  }

  const size_t plane = static_cast<size_t>(K) * N;
  const size_t step = static_cast<size_t>(kWarps) * N;   // to row k + 8
  float* dst = out + static_cast<size_t>(k0) * N + n;
  for (int r0 = 0; r0 < R; r0 += kStage) {
    rc = min(R - r0, kStage);
    if (r0 > 0) {                      // the next samples, once all are done
      __syncthreads();
      load_sel(staged, sel, r0, rc);
      noise_prefixes<kNoisy>(s, r0, rc, col, sample0, p);
      fused = __syncthreads_and(store_sel(s, staged, rc));
    }
    auto samples = [&](auto kind) {
      float* d = dst;
      for (int r = 0; r < rc; ++r, d += plane) {
        const float4* s4 = reinterpret_cast<const float4*>(s.sel[r]);
#pragma unroll
        for (int c = 0; c < kCells; ++c) {
          float raw = mix<decltype(kind)::value>(s4, cur[c]);
          if constexpr (kNoisy)
            raw = __fadd_rn(raw, entry(s.noise_tab, sum_offset(row_hash(
                                                         row[c],
                                                         s.noise[r][lane]))));
          store_if(d + c * step,
                   __fmul_rn(__fsub_rn(raw, p.sum_mean), p.inv_std), in[c]);
        }
      }
    };
    if (fused)
      samples(std::true_type{});
    else
      samples(std::false_type{});
    dst += static_cast<size_t>(kStage) * plane;
  }
}

template <bool kImprint, bool kNoisy>
int launch(const float* sel, float* out, int R, int K, int N, uint32_t row0,
           uint32_t col0, uint32_t sample0, const GrngParams& p,
           cudaStream_t stream) {
  constexpr int rows = kWarps * kCells;
  const dim3 grid((N + kCols - 1) / kCols, (K + rows - 1) / rows);
  if (grid.y > 65535u) return cudaErrorInvalidValue;
  grng_eps_kernel<kImprint, kNoisy><<<grid, kThreads, 0, stream>>>(
      sel, out, R, K, N, row0, col0, sample0, p);
  return static_cast<int>(cudaGetLastError());
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
  const bool imprint = p->imprint != 0.f, noisy = p->read_sigma != 0.f;
  auto st = static_cast<cudaStream_t>(stream);
  if (imprint)
    return noisy ? launch<true, true>(sel, out, R, K, N, row0, col0, sample0,
                                      *p, st)
                 : launch<true, false>(sel, out, R, K, N, row0, col0,
                                       sample0, *p, st);
  return noisy ? launch<false, true>(sel, out, R, K, N, row0, col0, sample0,
                                     *p, st)
               : launch<false, false>(sel, out, R, K, N, row0, col0, sample0,
                                      *p, st);
}
