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
// path's shapes, but latency and the launch.  The trunk products of a
// 32-slot admission, (M,K,N) = (7200,64,16), (1568,192,32) and
// (288,320,64), move at most 2.3 MB (0.7 µs at 3.35 TB/s) and do at most
// 15 MFLOP (0.2 µs at the float32 rate), while an empty kernel alone
// costs about 0.8 µs by graph replay on the H100 (PERF.md).  Inside a
// block the floor is a memory round trip and one 64-deep dependent fmaf
// chain per chunk, so the kernel puts every chunk's chain on the card at
// once.
//
// The contract is bit for bit: every output's 64-term partial sum is one
// fmaf chain in order k = 0…63, and the front end, the division, rintf,
// the clamps and acc += code·lsb are round-to-nearest intrinsics
// (nvcc cannot contract them into an FMA) applied in chunk order
// c = 0, 1, …, from 0.  A partial sum's last bit decides the 6-bit code
// on half-code ties, so any other order would move outputs by an LSB.
// That is also why tensor cores are not used: TF32, bf16 or int8 wgmma
// would change the partial sums or their order.  This kernel gives the
// bits of the previous design (below).
//
// The design.  The launch plan (tile sides, chunk split, threads, shared
// memory) is picked from (M, K, N) in Python (kernels/cim.py:
// launch_plan) and checked here:
//   tiles    a block owns a tile_m × tile_n output tile; tile_n is N
//            rounded up to 16, at most 64, so N = 16 wastes no thread;
//            tile_m is 32, 16, 8 or 4.  Each thread carries 4 rows of one
//            column: four independent fmaf chains, interleaved, reading
//            x as float4 along k from shared memory (rows padded to 68
//            floats: no bank conflicts).  Tiles are copied with cp.async,
//            16 bytes a copy where aligned.
//   split    where the largest tiles alone do not fill the card and
//            K/64 is 2..8 (every trunk product but the first conv's one
//            chunk), the chunks of a tile run at once in the blocks of a
//            thread-block cluster, one chunk each, at tile_m = 16.  Each
//            block stores its code·lsb per output into rank 0's shared
//            memory (distributed shared memory, after a barrier phase
//            that only shows every block has started); after one cluster
//            barrier rank 0 folds them in order c = 0…C-1, from 0: the
//            additions of the serial walk, in its order, and no atomics.
//   walk     otherwise one block walks the chunks in order, its
//            accumulators in registers, one shared-memory stage copied
//            and summed per chunk.  No path of the port walks more than
//            one chunk: it is kept for K > 512 and for tiles that fill
//            the card.
//   edges    ragged M and N are masked (zero-filled copies, no stores);
//            there are no pad chunks, K % 64 != 0 is refused.
// Two launches on the same inputs give the same bits, under any plan.
//
// The previous design, for comparison: one 32×32 tile a block, 256 threads,
// the K/64 chunks walked in series with synchronous global→shared copies
// (18 blocks at the third conv).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kChunk = 64;          // analog accumulation depth (tile rows)
constexpr int kXStride = kChunk + 4;  // padded x row: 16-byte aligned
constexpr int kRows = 4;            // output rows (chains) per thread
constexpr int kMaxCluster = 8;      // portable cluster size
constexpr int kMaxThreads = 32 * 64 / kRows;
constexpr int kMaxSmem = 48 * 1024;

struct Params {
  const float* x;        // [M, K]
  const float* w;        // [K, N]
  const float* fs;       // [1] ADC full scale
  const float* gain;     // [N] or null
  const float* offset;   // [N] (LSB units) or null
  float* out;            // [M, N]
  int M, K, N, levels;
  int tile_m, tile_n, split;
  int vec_x, vec_w;      // 16-byte copies possible
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
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

// The cluster barrier in two halves: a block may touch another block's
// shared memory only once every block of the cluster has started, which
// the first phase (arrive at entry, wait before the first remote store)
// shows without a stall.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Copies chunk c's x[m0 : m0+tile_m, 64] and w[64, n0 : n0+tile_n] tiles
// into (xs, ws); rows past M and columns past N are zero-filled (a
// zero-byte copy reads nothing, its source is any valid address).
__device__ __forceinline__ void load_chunk(const Params& p, int c, int m0,
                                           int n0, float* xs, float* ws) {
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int k0 = c * kChunk;
  for (int i = tid; i < p.tile_m * (kChunk / 4); i += nthreads) {
    const int r = i / (kChunk / 4), q = i % (kChunk / 4);
    const int m = m0 + r;
    float* dst = xs + r * kXStride + 4 * q;
    const float* src = p.x + static_cast<size_t>(m < p.M ? m : 0) * p.K + k0
                       + 4 * q;
    if (p.vec_x) {
      cp_async16(dst, src, m < p.M ? 16 : 0);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) cp_async4(dst + j, src + j, m < p.M ? 4 : 0);
    }
  }
  const int quads = p.tile_n / 4;
  for (int i = tid; i < kChunk * quads; i += nthreads) {
    const int r = i / quads, q = i % quads;
    const int n = n0 + 4 * q;
    float* dst = ws + r * p.tile_n + 4 * q;
    const float* row = p.w + static_cast<size_t>(k0 + r) * p.N;
    if (p.vec_w) {                     // N % 4 == 0: a quad is all in or out
      cp_async16(dst, n < p.N ? row + n : p.w, n < p.N ? 16 : 0);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool in = n + j < p.N;
        cp_async4(dst + j, in ? row + n + j : p.w, in ? 4 : 0);
      }
    }
  }
}

// The four 64-term partial sums of rows (g, g+rs, g+2rs, g+3rs) of column
// col, each one fmaf chain in order k = 0…63, the chains interleaved.
__device__ __forceinline__ void chunk_sums(const float* xs, const float* ws,
                                           int tile_n, int g, int rs, int col,
                                           float (&psum)[kRows]) {
  const float* xr[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    xr[i] = xs + (g + i * rs) * kXStride;
    psum[i] = 0.f;
  }
#pragma unroll 4
  for (int k = 0; k < kChunk; k += 4) {
    float4 xv[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      xv[i] = *reinterpret_cast<const float4*>(xr[i] + k);
    const float w0 = ws[(k + 0) * tile_n + col];
    const float w1 = ws[(k + 1) * tile_n + col];
    const float w2 = ws[(k + 2) * tile_n + col];
    const float w3 = ws[(k + 3) * tile_n + col];
#pragma unroll
    for (int i = 0; i < kRows; ++i) psum[i] = fmaf(xv[i].x, w0, psum[i]);
#pragma unroll
    for (int i = 0; i < kRows; ++i) psum[i] = fmaf(xv[i].y, w1, psum[i]);
#pragma unroll
    for (int i = 0; i < kRows; ++i) psum[i] = fmaf(xv[i].z, w2, psum[i]);
#pragma unroll
    for (int i = 0; i < kRows; ++i) psum[i] = fmaf(xv[i].w, w3, psum[i]);
  }
}

// The column front end and the 6-bit ADC of one partial sum: code·lsb.
__device__ __forceinline__ float adc_step(float psum, float g, float off_lsb,
                                          float lsb, float lo, float hi) {
  const float v = __fadd_rn(__fmul_rn(g, psum), off_lsb);
  const float code = fminf(fmaxf(rintf(__fdiv_rn(v, lsb)), lo), hi);
  return __fmul_rn(code, lsb);
}

// kSplit = false: grid (tiles_m, tiles_n), one block walks every chunk.
// kSplit = true: grid (split·tiles_m, tiles_n) in clusters of ``split``
// blocks along x; the block of rank c takes chunk c.
template <bool kSplit>
__global__ void __launch_bounds__(kMaxThreads) cim_mvm_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int col = tid % p.tile_n;
  const int g = tid / p.tile_n;
  const int rs = p.tile_m / kRows;
  const int rank =
      kSplit ? static_cast<int>(cg::this_cluster().block_rank()) : 0;
  const int m0 = (kSplit ? static_cast<int>(blockIdx.x) / p.split
                         : static_cast<int>(blockIdx.x)) * p.tile_m;
  const int n0 = blockIdx.y * p.tile_n;
  const int n = n0 + col;

  const float lsb = __fdiv_rn(p.fs[0], static_cast<float>(p.levels));
  const float gn = (p.gain != nullptr && n < p.N) ? p.gain[n] : 1.f;
  const float off_lsb =
      __fmul_rn((p.offset != nullptr && n < p.N) ? p.offset[n] : 0.f, lsb);
  const float lo = static_cast<float>(-p.levels - 1);
  const float hi = static_cast<float>(p.levels);
  float* xs = smem;                          // one stage: x and w tiles
  float* ws = smem + p.tile_m * kXStride;
  float psum[kRows];

  if constexpr (kSplit) {
    cluster_arrive_relaxed();
    // [split][tile_m, tile_n] code·lsb of every chunk, in rank 0's block
    float* q = ws + kChunk * p.tile_n;
    load_chunk(p, rank, m0, n0, xs, ws);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    chunk_sums(xs, ws, p.tile_n, g, rs, col, psum);
    cg::cluster_group cluster = cg::this_cluster();
    const int outputs = p.tile_m * p.tile_n;
    float* q0 = cluster.map_shared_rank(q, 0) + rank * outputs;
    cluster_wait();                          // every block has started
#pragma unroll
    for (int i = 0; i < kRows; ++i)          // into rank 0's shared memory
      q0[(g + i * rs) * p.tile_n + col] =
          adc_step(psum[i], gn, off_lsb, lsb, lo, hi);
    cluster.sync();                          // every chunk's codes are in
    if (rank != 0) return;                   // only rank 0's memory is read
    for (int o = tid; o < outputs; o += blockDim.x) {
      float acc = 0.f;
      for (int c = 0; c < p.split; ++c) acc = __fadd_rn(acc, q[c * outputs + o]);
      const int m = m0 + o / p.tile_n, nn = n0 + o % p.tile_n;
      if (m < p.M && nn < p.N) p.out[static_cast<size_t>(m) * p.N + nn] = acc;
    }
  } else {
    const int chunks = p.K / kChunk;
    float acc[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) acc[i] = 0.f;
    for (int c = 0; c < chunks; ++c) {
      load_chunk(p, c, m0, n0, xs, ws);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
      chunk_sums(xs, ws, p.tile_n, g, rs, col, psum);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        acc[i] = __fadd_rn(acc[i], adc_step(psum[i], gn, off_lsb, lsb, lo, hi));
      __syncthreads();                       // the stage is free again
    }
    if (n < p.N) {
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int m = m0 + g + i * rs;
        if (m < p.M) p.out[static_cast<size_t>(m) * p.N + n] = acc[i];
      }
    }
  }
}

}  // namespace

// Launches one product on ``stream`` without synchronising, with the
// plan (tile_m, tile_n, split, threads, smem_bytes) picked by
// kernels/cim.py.  Returns the launch's cudaError_t (0 = cudaSuccess);
// cudaErrorInvalidValue for a shape the kernel does not take or a plan
// whose threads or shared memory differ from what its tiles need here.
// The wrapper has checked devices, types, shapes and contiguity;
// ``gain`` and ``offset`` may both be null (the ideal ADC).
extern "C" int cim_mvm_launch(const float* x, const float* w, const float* fs,
                              const float* gain, const float* offset,
                              float* out, int M, int K, int N, int levels,
                              int tile_m, int tile_n, int split, int threads,
                              int smem_bytes, void* stream) {
  if (M < 1 || N < 1 || K < kChunk || K % kChunk != 0 || levels < 1)
    return cudaErrorInvalidValue;
  const int chunks = K / kChunk;
  const bool tile_ok = (tile_m == 4 || tile_m == 8 || tile_m == 16 ||
                        tile_m == 32) &&
                       tile_n >= 16 && tile_n <= 64 && tile_n % 16 == 0;
  const bool split_ok =
      split == 1 || (split == chunks && split <= kMaxCluster);
  if (!tile_ok || !split_ok) return cudaErrorInvalidValue;
  // one stage of x and w tiles, and in a split every chunk's codes
  const int need = static_cast<int>(sizeof(float)) *
                   (tile_m * kXStride + kChunk * tile_n +
                    (split > 1 ? split * tile_m * tile_n : 0));
  if (threads != tile_m * tile_n / kRows || smem_bytes != need ||
      smem_bytes > kMaxSmem)
    return cudaErrorInvalidValue;

  Params p{x, w, fs, gain, offset, out, M, K, N, levels, tile_m, tile_n,
           split,
           reinterpret_cast<uintptr_t>(x) % 16 == 0,
           N % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0};
  const unsigned tiles_m = (M + tile_m - 1) / tile_m;
  const unsigned tiles_n = (N + tile_n - 1) / tile_n;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (split == 1) {
    cim_mvm_kernel<false><<<dim3(tiles_m, tiles_n), threads, smem_bytes, s>>>(
        p);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles_m * split, tiles_n);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, cim_mvm_kernel<true>, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
