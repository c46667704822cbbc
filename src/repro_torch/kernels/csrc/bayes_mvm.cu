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
// What they compute (all float32; x [B,K], mu/sigma [K,N]; sel [R,16];
// out [R,B,N]):
//   rank16  y = x.mu, xs = x.sigma, m_j = x.(sigma (.) I_j) for the 16
//           devices, xq = (x^2).(sigma^2); then
//           out[r] = y + (sum_j sel[r,j] m_j - sum_mean xs
//                    + read_sigma sqrt(max(xq,0))
//                      gauss(hash3(sample0+r, b, col0+n, noise_seed)))
//                    * inv_std
//           (the read noise as its exact logit-level projection,
//           bayes_mvm.py:96-124; without read noise xq is unused).
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
// What bounds them on this card.  By float operations: at kernel_bench's
// head (B=8, K=512, N=2048) the float bound is ~6.7 us (rank16) and
// ~18 us (paper, R=20) at 67 TFLOP/s, the bytes ~3 us at 3.35 TB/s.
// Beside them is integer work with no peak in the float table: every one
// of the K N 16 device currents (16.8 M there) is a hash, and paper mixes
// 16 currents into every eps (K N R of them).  At the UQ path's shape
// (B=64, K=64, N=2, R=20) the whole call is a few thousand currents and
// ~0.17 M multiply-adds: latency and the launch bound it.
//
// The design.  The launch plan (output tile, samples a block carries,
// threads, shared memory) is picked from the shape in Python
// (kernels/bayes.py: head_plan, fitted to chip_smoke.py's plan sweep) and
// checked here:
//   tile     a block owns tile_n (a power of two) output columns and
//            tile_b = B rounded up to 4 (at most 64) rows, so N = 2
//            leaves no thread idle.  B > 64 takes a grid row a 64-row
//            tile (no path of the port has one), which hashes the tile's
//            currents again.
//   loads    a chunk's x rows and mu/sigma columns, and all R selections
//            once, arrive by cp.async (float32: the wrapper widens
//            bfloat16 operands first); a block copies the next chunk
//            while it works on this one.  A global
//            round trip costs hundreds of cycles, so none is left in a
//            loop.
//   hashing  every current of the tile is hashed once, by the whole
//            block, one current a thread per pass: a thread keeps one of
//            the 16 tile_n (device, column) pairs and steps over rows.
//            hash3's first two mix32 rounds depend only on that pair, so
//            they come from a per-block table and a current costs one
//            mix32; gauss's bytes become floats by their bit patterns
//            (2^23 + b), exactly; kBatch currents are computed before any
//            is stored, so their chains overlap.
//   weights  rank16 writes sigma (.) I_j, mu and sigma as the weight tile
//            W [64 rows][cols] in shared memory; paper keeps a chunk's
//            currents and, per sample chunk, mixes them into
//            sigma (.) eps_r columns: a thread takes one cell's 16
//            currents in registers and a run of samples, 4 side by side.
//   product  a micro-tile is one x row against 4 W columns: 4 in-order
//            fmaf chains over a chunk's 64 rows, x and W read as float4.
//            rank16's (x^2).(sigma^2) is one chain per (row, column).
//   K walk   K is cut at the ADC's 64-row chunks, and a block walks its
//            tile's chunks in order, folding each chunk's partial sums
//            (or ADC codes) into its sums in chunk order c = 0, 1, ...
//            from 0.  (Splitting the chunks over a thread-block cluster,
//            cim_mvm.cu's scheme, was slower at kernel_bench's head, the
//            only deep head measured: PERF.md.)
//   samples  rank16 hoists its per-(row, column) terms (sum_mean * x.sigma,
//            the read noise's scale and hash prefix) before the R samples.
// So every plan computes each chunk's partial sum as the same chain and
// folds the same values in the same order: all plans give the same bits,
// with the ADC or without, and two launches give the same bits.  The
// currents, eps, ADC and epilogue are round-to-nearest intrinsics (no
// FMA contraction), as the plain PyTorch versions round them; only the K
// sums' order differs from those.  Tensor cores stay out: TF32 would
// move the products past the tolerance and the ADC codes with them.
//
// The previous design, for comparison: a fixed 16-column x 8-row tile, K
// walked 16 rows a step, one thread hashing a cell's 16 currents in
// series, grid over B (each B tile hashing again) and, in paper mode,
// over sample chunks (each hashing again).  Times of both: PERF.md.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hash.cuh"

namespace {

using repro_torch::col_prefix;
using repro_torch::current;
using repro_torch::gauss_bytes;
using repro_torch::GrngParams;
using repro_torch::row_hash;

constexpr int kChunk = 64;            // ADC accumulation depth, K step
constexpr int kXStride = kChunk + 4;  // padded x row: 16-byte aligned
constexpr int kDevices = 16;
constexpr int kEpsGroup = 4;          // samples mixed side by side
constexpr int kRank16Sums = 20;       // rank16 sums a tile column
constexpr int kBatch = 4;             // items a thread computes before storing
constexpr int kMaxTileB = 64;
constexpr int kMaxThreads = 512;      // 128 registers a thread
constexpr int kMaxSmem = 227 * 1024;  // a block's opt-in shared memory

struct Params {
  const float* x;        // [B, K]
  const float* mu;       // [K, N]
  const float* sigma;    // [K, N]
  const float* sel;      // [R, 16]
  const float* fs;       // [2] ADC full scales (paper with the ADC)
  float* out;            // [R, B, N]
  int B, K, N, R;
  uint32_t row0, col0, sample0;
  int levels;            // 0: no ADC, else the largest code (31)
  int tile_n, tile_b, samples;
  int tn_shift;          // log2(tile_n): tile widths are powers of two
  int vec_x;             // x rows start on 16 bytes: 16-byte copies
  GrngParams g;
};

__host__ __device__ inline int quad(int n) { return (n + 3) & ~3; }

// The weight tile's columns (rank16: the 16 tile_n sigma (.) I_j, then
// mu and sigma; paper: ``samples`` tile_n sigma (.) eps_r, then mu),
// rounded up to whole 4-column micro-tiles; and the sums' columns
// (rank16: 20 a tile column n at 20 n + v, v = device 0..15, mu, sigma,
// sigma^2 and one unused; paper: mu at n, sample r at (1 + r) tile_n + n).
__host__ __device__ inline int tile_cols(bool paper, int tn, int samples) {
  return quad(paper ? (samples + 1) * tn : (kDevices + 2) * tn);
}
__host__ __device__ inline int sum_cols(bool paper, int tn, int R) {
  return paper ? (R + 1) * tn : kRank16Sums * tn;
}
// The product's micro-tiles: one x row against 4 weight columns.
__host__ __device__ inline int micro_tiles(bool paper, int tn, int tb,
                                           int samples) {
  return tb * (tile_cols(paper, tn, samples) / 4);
}

// Shared memory, in floats from the start, each region on 16 bytes;
// kernels/bayes.py (_smem_bytes) computes the same total.  A block that
// walks several chunks double-buffers a chunk's x rows and mu/sigma.
struct Layout {
  int lsb, sels, xs, mus, sgs, h2c, h2i, h2n, cur, w, acc, total;
  int stages, ws, acols;
};

__host__ __device__ inline Layout layout(bool paper, int tn, int tb,
                                         int samples, int R, int chunks) {
  Layout l;
  int at = 0;
  l.stages = chunks > 1 ? 2 : 1;
  l.ws = tile_cols(paper, tn, samples);
  l.acols = sum_cols(paper, tn, R);
  l.lsb = at;  at += 4;                             // the ADC's two steps
  // selections [r][j], zero rows after R for paper's last group of 4
  l.sels = at; at += (quad(R) + kEpsGroup) * kDevices;
  l.xs = at;   at += l.stages * tb * kXStride;      // x rows [b][k]
  l.mus = at;  at += l.stages * kChunk * tn;        // mu [k][n]
  l.sgs = at;  at += l.stages * kChunk * tn;        // sigma [k][n]
  l.h2c = at;  at += quad(kDevices * tn);           // hash prefixes: currents
  l.h2i = at;  at += quad(kDevices * tn);           //   imprint
  l.h2n = at;  at += quad(paper ? samples * tn : tb * tn);  //   read noise
  // currents [k][j*tn + n], rows of 16 tn + 1 (odd: a warp of rows
  // reads them without bank conflicts)
  l.cur = at;  at += paper ? quad(kChunk * (kDevices * tn + 1)) : 0;
  // the weight tile: rank16 [k][col], paper [col][k] in padded rows
  l.w = at;    at += paper ? l.ws * kXStride : kChunk * l.ws;
  l.acc = at;  at += quad(tb * l.acols);            // sums [b][col]
  l.total = at;
  return l;
}

// Runs f(std::true_type) or f(std::false_type) as ``on`` says, so that a
// uniform branch stays outside the loops in f.
template <typename F>
__device__ __forceinline__ void with_flag(bool on, F f) {
  if (on)
    f(std::true_type{});
  else
    f(std::false_type{});
}

__device__ __forceinline__ float adc(float v, float lsb, float lo, float hi) {
  const float code = fminf(fmaxf(rintf(__fdiv_rn(v, lsb)), lo), hi);
  return __fmul_rn(code, lsb);
}

__device__ __forceinline__ void cp_async16(float* dst, const void* src,
                                           int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async4(float* dst, const void* src,
                                          int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// f(r, c) for the items of [rows) x [cols), c fastest, the thread's
// every blockDim.x-th, one at a time.  No division in the loop.
template <typename F>
__device__ __forceinline__ void for_each2(int rows, int cols, F f) {
  const int step_r = blockDim.x / cols, step_c = blockDim.x % cols;
  int r = threadIdx.x / cols, c = threadIdx.x % cols;
  while (r < rows) {
    f(r, c);
    c += step_c;
    r += step_r;
    if (c >= cols) {
      c -= cols;
      ++r;
    }
  }
}

// The current prefixes of the tile's 16 x tile_n (device, column) pairs.
__device__ void col_prefixes(const Params& p, int n0, uint32_t* h2c,
                             uint32_t* h2i) {
  for (int i = threadIdx.x; i < kDevices * p.tile_n; i += blockDim.x) {
    const uint32_t col = p.col0 + n0 + (i & (p.tile_n - 1));
    const uint32_t j = i >> p.tn_shift;
    h2c[i] = col_prefix(col, j, p.g.seed);
    h2i[i] = col_prefix(col, j, p.g.imprint_seed);
  }
}

// The selections [R][16] into sels, the region's rows after R zero.
__device__ void stage_selections(const Params& p, float* sels) {
  for (int i = threadIdx.x; i < (quad(p.R) + kEpsGroup) * 4;
       i += blockDim.x)
    cp_async16(sels + 4 * i, p.sel + (i < p.R * 4 ? 4 * i : 0),
               i < p.R * 4 ? 16 : 0);
}

// Chunk c's x rows [b][k] and mu/sigma [k][n] by asynchronous copies
// (wait with cp_async_wait_all), zero outside [B, K] and [K, N].
__device__ void load_chunk(const Params& p, int c, int b0, int n0,
                           float* xs, float* mus, float* sgs) {
  const int k0 = c * kChunk, tn = p.tile_n;
  if (p.vec_x) {                       // a quad of k is all in or all out
    for (int i = threadIdx.x; i < p.tile_b * (kChunk / 4); i += blockDim.x) {
      const int row = i / (kChunk / 4), k = 4 * (i % (kChunk / 4));
      const bool in = b0 + row < p.B && k0 + k < p.K;
      cp_async16(xs + row * kXStride + k,
                 in ? p.x + static_cast<size_t>(b0 + row) * p.K + k0 + k
                    : p.x,
                 in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < p.tile_b * kChunk; i += blockDim.x) {
      const int row = i / kChunk, k = i % kChunk;
      const bool in = b0 + row < p.B && k0 + k < p.K;
      cp_async4(xs + row * kXStride + k,
                in ? p.x + static_cast<size_t>(b0 + row) * p.K + k0 + k : p.x,
                in ? 4 : 0);
    }
  }
  for (int i = threadIdx.x; i < kChunk * tn; i += blockDim.x) {
    const int k = i >> p.tn_shift, n = i & (tn - 1);
    const bool in = k0 + k < p.K && n0 + n < p.N;
    const size_t at = static_cast<size_t>(k0 + k) * p.N + n0 + n;
    cp_async4(mus + i, in ? p.mu + at : p.mu, in ? 4 : 0);
    cp_async4(sgs + i, in ? p.sigma + at : p.sigma, in ? 4 : 0);
  }
}

// A micro-tile's 64-term partial sums: x row xr against weight columns
// c4 .. c4+3, each one fmaf chain in order k = 0..63.  kByCol: the tile
// is stored [col][k] in padded rows (paper), else [k][col] with ws
// columns (rank16).
template <bool kByCol>
__device__ __forceinline__ void tile_sums(const float* xr, const float* w,
                                          int ws, int c4, float (&ps)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) ps[j] = 0.f;
#pragma unroll 4
  for (int k = 0; k < kChunk; k += 4) {
    const float4 xv = *reinterpret_cast<const float4*>(xr + k);
    if constexpr (kByCol) {            // a column's 4 rows k.. at a time
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 v =
            *reinterpret_cast<const float4*>(w + (c4 + j) * kXStride + k);
        ps[j] = fmaf(xv.x, v.x, ps[j]);
        ps[j] = fmaf(xv.y, v.y, ps[j]);
        ps[j] = fmaf(xv.z, v.z, ps[j]);
        ps[j] = fmaf(xv.w, v.w, ps[j]);
      }
    } else {                           // a row k's 4 columns at a time
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 v =
            *reinterpret_cast<const float4*>(w + (k + u) * ws + c4);
        const float xk = u == 0 ? xv.x : u == 1 ? xv.y : u == 2 ? xv.z
                                                                : xv.w;
        ps[0] = fmaf(xk, v.x, ps[0]);
        ps[1] = fmaf(xk, v.y, ps[1]);
        ps[2] = fmaf(xk, v.z, ps[2]);
        ps[3] = fmaf(xk, v.w, ps[3]);
      }
    }
  }
}

// Chunk c's value of sum ``at``, folded into the block's sums in chunk
// order.
__device__ __forceinline__ void put(float* acc, int c, int at, float v) {
  acc[at] = __fadd_rn(c == 0 ? 0.f : acc[at], v);
}

// One kernel for both modes, on a grid (tiles_n, tiles_b): a block owns
// one output tile and walks every chunk of K.
template <bool kPaper>
__global__ void __launch_bounds__(kMaxThreads) head_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  const int tn = p.tile_n, tb = p.tile_b, sh = p.tn_shift;
  const int ns = kPaper ? p.samples : 0;
  const int chunks = (p.K + kChunk - 1) / kChunk;
  const Layout L = layout(kPaper, tn, tb, ns, p.R, chunks);
  float* sels = smem + L.sels;
  uint32_t* h2c = reinterpret_cast<uint32_t*>(smem + L.h2c);
  uint32_t* h2i = reinterpret_cast<uint32_t*>(smem + L.h2i);
  uint32_t* h2n = reinterpret_cast<uint32_t*>(smem + L.h2n);
  float* cur = smem + L.cur;
  float* w = smem + L.w;
  float* acc = smem + L.acc;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int n0 = blockIdx.x * tn, b0 = blockIdx.y * tb;
  const int tiles = micro_tiles(kPaper, tn, tb, ns);
  stage_selections(p, sels);
  load_chunk(p, 0, b0, n0, smem + L.xs, smem + L.mus, smem + L.sgs);
  cp_async_commit();
  col_prefixes(p, n0, h2c, h2i);
  float* lsb = smem + L.lsb;          // the ADC's steps: mu, sigma-eps
  if (kPaper && p.levels > 0 && tid < 2)
    lsb[tid] = __fdiv_rn(p.fs[tid], static_cast<float>(p.levels));

  for (int c = 0; c < chunks; ++c) {
    const int st = L.stages > 1 ? c & 1 : 0;
    const float* xs = smem + L.xs + st * tb * kXStride;
    const float* mus = smem + L.mus + st * kChunk * tn;
    const float* sgs = smem + L.sgs + st * kChunk * tn;
    cp_async_wait_all();
    __syncthreads();                   // chunk c (and the selections) in
    if (c + 1 < chunks) {              // prefetch the next chunk
      const int nx = (c + 1) & 1;
      load_chunk(p, c + 1, b0, n0, smem + L.xs + nx * tb * kXStride,
                 smem + L.mus + nx * kChunk * tn,
                 smem + L.sgs + nx * kChunk * tn);
      cp_async_commit();
    }
    const uint32_t row_c = p.row0 + c * kChunk;
    // the chunk's currents, one a thread per pass: rank16 sigma (.) I_j
    // into the weight tile, paper I_j kept for every sample chunk.  The
    // 16 tile_n columns divide the threads, so a thread keeps its column
    // cc (and its hash prefixes) and steps over rows k.
    {
      const int gen = kDevices * tn;
      const int cc = tid & (gen - 1), n = cc & (tn - 1), dk = nthreads / gen;
      const uint32_t pc = h2c[cc], pi = h2i[cc];
      with_flag(p.g.imprint != 0.f, [&](auto imprint) {
        for (int k = tid / gen; k < kChunk; k += kBatch * dk) {
          float v[kBatch];
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            const int ku = min(k + u * dk, kChunk - 1);
            v[u] = current<decltype(imprint)::value>(row_c + ku, pc, pi, p.g);
            if constexpr (!kPaper) v[u] = __fmul_rn(sgs[ku * tn + n], v[u]);
          }
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            const int ku = k + u * dk;
            if (ku < kChunk) {
              if constexpr (kPaper)
                cur[ku * (gen + 1) + cc] = v[u];
              else
                w[ku * L.ws + cc] = v[u];
            }
          }
        }
      });
    }
    const int sample_chunks = kPaper ? (p.R + ns - 1) / ns : 1;
    for (int q = 0; q < sample_chunks; ++q) {
      const int r0 = q * ns, rc = kPaper ? min(ns, p.R - r0) : 0;
      if constexpr (kPaper) {
        for (int i = tid; i < rc * tn; i += nthreads)
          h2n[i] = col_prefix(p.col0 + n0 + (i & (tn - 1)),
                              p.sample0 + r0 + (i >> sh), p.g.noise_seed);
        __syncthreads();               // currents, noise prefixes in
        // sigma (.) eps_r of every cell and sample: a thread takes one
        // cell (k, n), its 16 currents in registers, and a run of the
        // chunk's samples, kEpsGroup side by side (samples past the run
        // mix zero selections and are not stored); the cells times the
        // runs fill the block once
        const int cells = kChunk * tn;
        const int runs = min((rc + kEpsGroup - 1) / kEpsGroup,
                             nthreads / cells);
        const int per_run = (rc + runs - 1) / runs;
        if (tid < cells * runs) {
          const int cn = tid & (tn - 1), k = (tid >> sh) & (kChunk - 1);
          const int s_lo = (tid / cells) * per_run;
          const int s_hi = min(s_lo + per_run, rc);
          float cj[kDevices];
#pragma unroll
          for (int j = 0; j < kDevices; ++j)
            cj[j] = cur[k * (kDevices * tn + 1) + j * tn + cn];
          const float s = sgs[k * tn + cn];
          with_flag(p.g.read_sigma != 0.f, [&](auto noisy) {
            for (int s0 = s_lo; s0 < s_hi; s0 += kEpsGroup) {
              float raw[kEpsGroup];
#pragma unroll
              for (int u = 0; u < kEpsGroup; ++u) raw[u] = 0.f;
#pragma unroll
              for (int j4 = 0; j4 < kDevices; j4 += 4) {
#pragma unroll
                for (int u = 0; u < kEpsGroup; ++u) {
                  const float4 sv = *reinterpret_cast<const float4*>(
                      sels + (r0 + s0 + u) * kDevices + j4);
                  raw[u] = __fadd_rn(raw[u], __fmul_rn(sv.x, cj[j4]));
                  raw[u] = __fadd_rn(raw[u], __fmul_rn(sv.y, cj[j4 + 1]));
                  raw[u] = __fadd_rn(raw[u], __fmul_rn(sv.z, cj[j4 + 2]));
                  raw[u] = __fadd_rn(raw[u], __fmul_rn(sv.w, cj[j4 + 3]));
                }
              }
#pragma unroll
              for (int u = 0; u < kEpsGroup; ++u) {
                const int sr = s0 + u;
                float r = raw[u];
                if constexpr (decltype(noisy)::value)
                  r = __fadd_rn(r, __fmul_rn(p.g.read_sigma,
                                             gauss_bytes(row_hash(
                                                 row_c + k,
                                                 h2n[min(sr, rc - 1) * tn +
                                                     cn]))));
                const float se = __fmul_rn(
                    s, __fmul_rn(__fsub_rn(r, p.g.sum_mean), p.g.inv_std));
                if (sr < s_hi) w[(sr * tn + cn) * kXStride + k] = se;
              }
            }
          });
        }
        if (q == 0)                    // the mu columns
          for (int i = tid; i < kChunk * tn; i += nthreads)
            w[(ns * tn + (i & (tn - 1))) * kXStride + (i >> sh)] = mus[i];
      } else {                         // the mu and sigma columns
        for (int i = tid; i < kChunk * 2 * tn; i += nthreads) {
          const int k = i / (2 * tn), cc = i % (2 * tn);
          w[k * L.ws + kDevices * tn + cc] =
              cc < tn ? mus[k * tn + cc] : sgs[k * tn + cc - tn];
        }
      }
      __syncthreads();                 // the weight tile is in
      // the micro-tiles, then (rank16 on a noisy die) the (x^2).(sigma^2)
      // chains of the tile's (row, n), one item a thread per pass
      const bool xq = !kPaper && p.g.read_sigma != 0.f;
      for (int t = tid; t < tiles + (xq ? tb * tn : 0); t += nthreads) {
        if (t >= tiles) {
          const int row = (t - tiles) >> sh, n = (t - tiles) & (tn - 1);
          const float* xr = xs + row * kXStride;
          float a = 0.f;
#pragma unroll 4
          for (int k = 0; k < kChunk; k += 4) {
            const float4 xv = *reinterpret_cast<const float4*>(xr + k);
            const float x4[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const float sv = sgs[(k + u) * tn + n];
              a = fmaf(__fmul_rn(x4[u], x4[u]), __fmul_rn(sv, sv), a);
            }
          }
          put(acc, c, row * L.acols + n * kRank16Sums + kDevices + 2, a);
          continue;
        }
        const int row = t % tb, c4 = 4 * (t / tb);
        float ps[4];
        tile_sums<kPaper>(xs + row * kXStride, w, L.ws, c4, ps);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = c4 + j;
          int acol;
          float v = ps[j];
          if constexpr (kPaper) {
            const bool mu_col = col >= ns * tn;
            if (mu_col ? (q != 0 || col >= (ns + 1) * tn)
                       : (col >> sh) >= rc)
              continue;
            acol = mu_col ? col - ns * tn : (1 + r0 + (col >> sh)) * tn +
                                                (col & (tn - 1));
            if (p.levels > 0)
              v = adc(v, lsb[mu_col ? 0 : 1],
                      static_cast<float>(-p.levels - 1),
                      static_cast<float>(p.levels));
          } else {
            if (col >= (kDevices + 2) * tn) continue;
            acol = (col & (tn - 1)) * kRank16Sums + (col >> sh);
          }
          put(acc, c, row * L.acols + acol, v);
        }
      }
      __syncthreads();                 // the weight tile and stage are free
    }
  }
  // the samples: item (r, row * tile_n + n)
  with_flag(p.g.read_sigma != 0.f, [&](auto noisy) {
    constexpr bool kNoisy = decltype(noisy)::value;
    uint32_t* h2e = h2n;               // rank16: noise prefixes of (row, n)
    if constexpr (!kPaper) {
      // once per (row, n): sum_mean * x.sigma in sigma's place, the read
      // noise's scale read_sigma * sqrt((x^2).(sigma^2)) in sigma^2's,
      // and the noise hash's prefix over (row, column)
      for (int t = tid; t < tb * tn; t += nthreads) {
        float* a = acc + (t >> sh) * L.acols + (t & (tn - 1)) * kRank16Sums;
        a[kDevices + 1] = __fmul_rn(p.g.sum_mean, a[kDevices + 1]);
        if constexpr (kNoisy) {
          a[kDevices + 2] = __fmul_rn(p.g.read_sigma,
                                      sqrtf(fmaxf(a[kDevices + 2], 0.f)));
          h2e[t] = col_prefix(b0 + (t >> sh), p.col0 + n0 + (t & (tn - 1)),
                              p.g.noise_seed);
        }
      }
      __syncthreads();
    }
    for_each2(p.R, tb * tn, [&](int r, int rn) {
      const int row = rn >> sh, n = rn & (tn - 1);
      const int b = b0 + row, gn = n0 + n;
      if (b >= p.B || gn >= p.N) return;
      float y;
      if constexpr (kPaper) {
        const float* a = acc + row * L.acols + n;
        y = __fadd_rn(a[0], a[(1 + r) * tn]);
      } else {
        const float* a = acc + row * L.acols + n * kRank16Sums;
        const float4* s4 =
            reinterpret_cast<const float4*>(sels + r * kDevices);
        const float4* m4 = reinterpret_cast<const float4*>(a);
        float mixed = 0.f;
#pragma unroll
        for (int j4 = 0; j4 < 4; ++j4) {
          const float4 s = s4[j4], m = m4[j4];
          mixed = __fadd_rn(mixed, __fmul_rn(s.x, m.x));
          mixed = __fadd_rn(mixed, __fmul_rn(s.y, m.y));
          mixed = __fadd_rn(mixed, __fmul_rn(s.z, m.z));
          mixed = __fadd_rn(mixed, __fmul_rn(s.w, m.w));
        }
        float num = __fsub_rn(mixed, a[kDevices + 1]);
        if constexpr (kNoisy)
          num = __fadd_rn(num, __fmul_rn(gauss_bytes(row_hash(
                                             p.sample0 + r, h2e[rn])),
                                         a[kDevices + 2]));
        y = __fadd_rn(a[kDevices], __fmul_rn(num, p.g.inv_std));
      }
      p.out[(static_cast<size_t>(r) * p.B + b) * p.N + gn] = y;
    });
  });
}

template <bool kPaper>
int launch(const Params& p, int threads, int smem, cudaStream_t stream) {
  const int chunks = (p.K + kChunk - 1) / kChunk;
  const bool tiles_ok = p.tile_n >= 1 && (p.tile_n & (p.tile_n - 1)) == 0 &&
                        p.tile_b >= 4 && p.tile_b <= kMaxTileB &&
                        p.tile_b % 4 == 0;
  const bool samples_ok = !kPaper || (p.samples >= 1 && p.samples <= p.R);
  if (!tiles_ok || !samples_ok) return cudaErrorInvalidValue;
  const Layout L = layout(kPaper, p.tile_n, p.tile_b, p.samples, p.R,
                          chunks);
  const int need = static_cast<int>(sizeof(float)) * L.total;
  // a thread keeps one generated column; paper's cells fill the block once
  if (threads < 128 || threads > kMaxThreads || threads % 128 != 0 ||
      kDevices * p.tile_n > threads ||
      (kPaper && kChunk * p.tile_n > threads) || smem != need ||
      smem > kMaxSmem)
    return cudaErrorInvalidValue;
  const unsigned tiles_n = (p.N + p.tile_n - 1) / p.tile_n;
  const unsigned tiles_b = (p.B + p.tile_b - 1) / p.tile_b;
  if (tiles_b > 65535u) return cudaErrorInvalidValue;
  auto kernel = head_kernel<kPaper>;
  static bool opted_in = false;     // once per instance: allow kMaxSmem
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  kernel<<<dim3(tiles_n, tiles_b), threads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches one head product on ``stream`` without synchronising, under
// the plan (tile_n, tile_b, samples, threads: 128, 256 or 512,
// smem_bytes) picked by kernels/bayes.py.  ``paper``: 0 = rank16, 1 =
// paper; ``levels``: paper's ADC, 0 for none, else its largest code (31
// at 6 bits), with ``fs`` [2] on the device holding the mu and sigma-eps
// full scales.  ``g`` is a host pointer, copied into the launch.  Returns
// the launch's cudaError_t (0 = cudaSuccess); cudaErrorInvalidValue for
// a shape or plan the kernels do not take, or shared memory that differs
// from what the plan's tiles need here.  The wrapper has checked devices,
// types (float32), shapes and contiguity, and that sel is 16-byte aligned.
extern "C" int bayes_head_launch(int paper, const float* x, const float* mu,
                                 const float* sigma, const float* sel,
                                 const float* fs, float* out, int B, int K,
                                 int N, int R, unsigned int row0,
                                 unsigned int col0, unsigned int sample0,
                                 int levels, int tile_n, int tile_b,
                                 int samples, int threads,
                                 int smem_bytes, const GrngParams* g,
                                 void* stream) {
  if (B < 1 || K < 1 || N < 1 || R < 1 || g == nullptr || levels < 0 ||
      (levels > 0 && (!paper || fs == nullptr)) ||
      reinterpret_cast<uintptr_t>(sel) % 16 != 0)
    return cudaErrorInvalidValue;
  int shift = 0;
  while (shift < 30 && (1 << shift) < tile_n) ++shift;
  const int vec_x = K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const Params p{x, mu, sigma, sel, fs, out, B, K, N, R, row0, col0,
                 sample0, levels, tile_n, tile_b, paper ? samples : 0,
                 shift, vec_x, *g};
  auto st = static_cast<cudaStream_t>(stream);
  return paper ? launch<true>(p, threads, smem_bytes, st)
               : launch<false>(p, threads, smem_bytes, st);
}
