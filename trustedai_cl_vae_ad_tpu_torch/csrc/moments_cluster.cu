// Latent moments (mean, population variance, skew, kurtosis), forward and backward, of the
// whole latent matrix ("global") and of each latent column over the batch ("per
// dimension"), on thread-block clusters.
//
// Replaces the TPU kernels trustedai_cl_vae_ad_tpu/ops/moments.py:77 (_global_kernel, its
// analytic VJP _global_bwd at :174) and :98 (_perdim_kernel, its VJP _perdim_bwd at :210),
// as moments.cu does, with the same function (moments.cu's header states it): z (B, L) f32
// or bf16 gives (4,) f32 [mean, var, skew, kurt] of all n = B*L values, or (4, L) f32 of
// each column over its B rows; skew is 0 where std is 0 and kurt 0 where var is 0; the
// backward is the analytic gradient, cast to z's type.
//
// What bounds it on Hopper: latency. The flagship's latent (256, 2000) f32 is 2.05 MB: a
// forward reads it once (0.61 us at 3.35 TB/s), a backward reads it and writes as much. Each
// forward holds two reductions that depend on each other (the mean before the centred
// powers: raw power sums cancel in f32 for the fourth moment), which moments.cu joins across
// blocks with three dependent launches (global) or by giving one block all B rows of 32
// columns (63 blocks at the flagship, fewer than half the SMs).
//
// The design. Each forward is ONE launch on thread-block clusters whose joins go through
// distributed shared memory, as stream_score_cluster.cu's do:
//   * global: one cluster of C = 16 CTAs (non-portable). Rank r owns elements
//     [r s, min((r + 1) s, n)) of the flattened z, s = ceil(n / C) rounded up to 16 bytes
//     (ops/moments.py::moments_arrangement computes the same s), so every slice starts on
//     a 16-byte boundary. Staged (the slice fits the CTA's shared memory and z is 16-byte
//     aligned): the slice is read from HBM once, by kChunks cp.async.bulk global->shared
//     copies that lanes of warp 0 ask for at once, each completing on its own mbarrier, and
//     pass 1 sums each chunk as it lands; pass 2 reads shared memory. Streamed (a larger slice, or z off 16 bytes): both
//     passes read z, the second from L2. The same kernel: the launch's shared memory
//     decides. A chunk holds a multiple of the CTA's threads in vectors, so every thread
//     sums the same elements in the same order either way: staged and streamed give the
//     same bits.
//   * per dimension: a cluster of R <= 8 CTAs (portable) owns a tile of 32 lanes x 16 bytes
//     of adjacent columns (128 f32, 256 bf16) and its R CTAs split the B rows; a warp reads
//     one 512-byte row segment of the tile, a lane 16 bytes. Pass 1 keeps the CTA's rows of
//     the tile in shared memory where they fit (staged), for pass 2.
// The joins: each CTA reduces its share (warp shuffles, then the warps in order through
// shared memory), then PUSHES its partial into slot [rank] of every peer's shared memory
// (the global sums and the per-dimension column sums), or of the rank that writes the
// column's output (the per-dimension centred sums); one cluster.sync() publishes them and
// each reader folds its own copy in rank order 0..C-1, so every CTA holds the same bits of
// the mean. The first push waits for the cluster barrier every CTA arrives at on entry (a
// peer's shared memory exists once the peer runs); no thread reads a peer's memory; after
// the last barrier no CTA touches a peer's, so none waits for another to exit. No atomics
// and no scratch in device memory: the same bits from run to run.
// The backwards are one streaming launch each: the global one on a grid of a multiple of
// the SM count with kBwdUnroll 16-byte vectors in flight a thread, the per-dimension one on
// the forward's column tiles with 16-byte accesses where L and the alignment allow. A
// thread's first loads of z go out before it waits for the coefficients, which are derived
// once a CTA into shared memory in the float operations of moments.cu's backwards; the
// element arithmetic is moments.cu's BwdCoef::grad, so the gradients equal moments.cu's bit
// for bit (both are built with --fmad=false).
// A ragged L, odd bf16 widths and views off 16 bytes take scalar accesses in the same
// kernels. A launch the card refuses (an arrangement the source does not take, a slice past
// the shared memory, no cluster of the size resident) returns its error; nothing falls back
// to moments.cu.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <mutex>
#include <vector>

namespace cg = cooperative_groups;

namespace {

constexpr int kGlobalThreads = 384;
constexpr int kGlobalWarps = kGlobalThreads / 32;
constexpr int kChunks = 8;  // bulk copies, each on its own mbarrier, of a staged slice
constexpr int kPerdimThreads = 256;
constexpr int kPerdimWarps = kPerdimThreads / 32;
constexpr int kRowGroup = 4;  // rows a warp loads before it adds them
constexpr int kBwdThreads = 256;
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kBwdUnroll = 2;  // 16-byte vectors in flight a thread
constexpr int kBwdMaxWaves = 8;  // CTAs an SM at most; grid-stride beyond
constexpr int kBwdResident = 4;  // per-dimension backward CTAs an SM holds at once
constexpr int kPortableCluster = 8;
constexpr int kMaxCluster = 16;        // Hopper's largest (non-portable) cluster
constexpr int kMaxPerdimCluster = 8;   // the per-dimension clusters stay portable
// shared memory a CTA may stage its share in: 227 KB less 32 KB kept for the static scratch
constexpr size_t kStageBudget = 232448 - 32768;
// returned when cudaOccupancyMaxActiveClusters finds no cluster of the size resident
constexpr int kErrorNoActiveCluster = 100000;
// a bulk copy that never lands stops the kernel instead of hanging it
constexpr long long kMaxSpins = 1LL << 22;

// 16 bytes of z widened to f32: 4 floats or 8 bfloat16.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int kWidth = 4;
  static __device__ void widen(const uint4& q, float* x) {
    x[0] = __uint_as_float(q.x); x[1] = __uint_as_float(q.y);
    x[2] = __uint_as_float(q.z); x[3] = __uint_as_float(q.w);
  }
  static __device__ uint4 narrow(const float* x) {
    return make_uint4(__float_as_uint(x[0]), __float_as_uint(x[1]), __float_as_uint(x[2]),
                      __float_as_uint(x[3]));
  }
  static __device__ float get(const float* p) { return *p; }
  static __device__ void put(float* p, float x) { *p = x; }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kWidth = 8;
  // bf16 is the high half of an f32: widening is a shift
  static __device__ void widen(const uint4& q, float* x) {
    const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      x[2 * k] = __uint_as_float(w[k] << 16);
      x[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
  static __device__ unsigned pack(float lo, float hi) {
    const unsigned a = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
    const unsigned b = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
    return a | (b << 16);
  }
  static __device__ uint4 narrow(const float* x) {
    return make_uint4(pack(x[0], x[1]), pack(x[2], x[3]), pack(x[4], x[5]), pack(x[6], x[7]));
  }
  static __device__ float get(const __nv_bfloat16* p) { return __bfloat162float(*p); }
  static __device__ void put(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }
};

template <typename T>
__device__ inline void load16(const T* p, float* x) {
  Vec<T>::widen(*reinterpret_cast<const uint4*>(p), x);
}

__host__ __device__ inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// ---- cluster barrier, mbarrier and bulk copy (PTX) ---------------------------------------

// The cluster barrier in two halves: arrive (relaxed: orders nothing) and wait.
__device__ inline void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ inline void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ inline uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ inline void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// the initialized barriers are visible to the bulk copies (the async proxy) of this CTA
__device__ inline void fence_barrier_init() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ inline void mbar_expect_tx(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// bytes (a multiple of 16) from global src to shared dst, both 16-byte aligned; completes
// on bar
__device__ inline void bulk_load(void* dst, const void* src, unsigned bytes,
                                 unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ inline void mbar_wait(unsigned long long* bar, unsigned phase) {
  const uint32_t addr = smem_addr(bar);
  for (long long spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(phase)
        : "memory");
    if (done) return;
    if (spin > kMaxSpins) __trap();
  }
}

// ---- reductions -----------------------------------------------------------------------------

__device__ inline float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The CTA's sums of v[0..K-1]: each warp's, then every warp's over the warps' results
// (red holds K rows of one float a warp and is not reused), so every thread returns the
// same bits; one barrier for the K.
template <int kWarps, int K>
__device__ inline void cta_sum(float (&v)[K], float (*red)[kWarps]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = warp_sum(v[k]);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) red[k][threadIdx.x >> 5] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = warp_sum(lane < kWarps ? red[k][lane] : 0.0f);
}

// ---- global forward ---------------------------------------------------------------------

struct GlobalScratch {
  float red[4][kGlobalWarps];  // the CTA reductions: sum z, then the centred sums ^2, ^3, ^4
  float sum[kMaxCluster];      // join 1: rank r's sum of z, pushed there by rank r
  float cen[3][kMaxCluster];   // join 2: rank r's centred sums
  unsigned long long bar[kChunks];
};

// The centred powers of one element, added in the order of moments.cu.
struct Centred {
  float a2 = 0.0f, a3 = 0.0f, a4 = 0.0f;
  __device__ void add(float x, float mean) {
    const float zc = x - mean;
    const float zc2 = zc * zc;
    a2 += zc2;
    a3 += zc2 * zc;
    a4 += zc2 * zc2;
  }
};

template <typename T>
__global__ void __launch_bounds__(kGlobalThreads, 1)
global_forward_kernel(const T* __restrict__ z, long long n, long long slice, int staged,
                      float* __restrict__ out) {
  constexpr int W = Vec<T>::kWidth;
  extern __shared__ __align__(128) unsigned char stage[];  // the staged slice
  __shared__ GlobalScratch sc;
  cg::cluster_group cluster = cg::this_cluster();
  // A peer's shared memory may be written only once the peer runs: this arrive is waited
  // for just before the first push, after pass 1.
  cluster_arrive_relaxed();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_ranks = static_cast<int>(cluster.num_blocks());
  const long long e0 = min(static_cast<long long>(rank) * slice, n);
  const long long len = min(e0 + slice, n) - e0;
  const T* src = z + e0;
  const long long nv = aligned16(z) ? len / W : 0;  // whole 16-byte vectors of the slice
  // vectors a chunk: a multiple of the threads, so a thread's vectors are the same staged
  // or streamed
  const long long per_chunk =
      ((nv + kChunks - 1) / kChunks + kGlobalThreads - 1) / kGlobalThreads * kGlobalThreads;
  auto chunk = [&](int c, long long* v0, long long* v1) {
    *v0 = min(c * per_chunk, nv);
    *v1 = min(*v0 + per_chunk, nv);
  };

  if (staged) {
    if (threadIdx.x < kChunks) {
      mbar_init(&sc.bar[threadIdx.x], 1);
      fence_barrier_init();
      long long v0, v1;  // lane c of warp 0 asks for chunk c
      chunk(threadIdx.x, &v0, &v1);
      if (v1 > v0) {
        const unsigned bytes = static_cast<unsigned>((v1 - v0) * 16);
        mbar_expect_tx(&sc.bar[threadIdx.x], bytes);
        bulk_load(stage + v0 * 16, src + v0 * W, bytes, &sc.bar[threadIdx.x]);
      }
    }
    __syncthreads();  // every barrier initialized before any thread waits on one
  }

  // pass 1: sum z over the slice, each chunk as it lands
  float acc = 0.0f;
  if (staged) {
    for (int c = 0; c < kChunks; ++c) {
      long long v0, v1;
      chunk(c, &v0, &v1);
      if (v1 <= v0) break;
      mbar_wait(&sc.bar[c], 0);
      for (long long v = v0 + threadIdx.x; v < v1; v += kGlobalThreads) {
        float x[W];
        load16(reinterpret_cast<const T*>(stage) + v * W, x);
#pragma unroll
        for (int k = 0; k < W; ++k) acc += x[k];
      }
    }
  } else {
    long long v = threadIdx.x;
    for (; v + 3 * kGlobalThreads < nv; v += 4 * kGlobalThreads) {  // 4 vectors in flight
      float x[4][W];
#pragma unroll
      for (int u = 0; u < 4; ++u) load16(src + (v + u * kGlobalThreads) * W, x[u]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int k = 0; k < W; ++k) acc += x[u][k];
      }
    }
    for (; v < nv; v += kGlobalThreads) {
      float x[W];
      load16(src + v * W, x);
#pragma unroll
      for (int k = 0; k < W; ++k) acc += x[k];
    }
  }
  // the ragged tail of the last slice, or every element when z is off 16 bytes
  for (long long i = nv * W + threadIdx.x; i < len; i += kGlobalThreads) {
    acc += Vec<T>::get(src + i);
  }

  // join 1: sum z
  float sums[1] = {acc};
  cta_sum<kGlobalWarps>(sums, &sc.red[0]);
  const float s = sums[0];
  cluster_wait();  // every peer runs: its shared memory may be written
  if (threadIdx.x < n_ranks) *cluster.map_shared_rank(&sc.sum[rank], threadIdx.x) = s;
  cluster.sync();
  float total = sc.sum[0];
  for (int r = 1; r < n_ranks; ++r) total += sc.sum[r];
  const float nf = static_cast<float>(n);
  const float mean = total / nf;

  // pass 2: the centred powers, from shared memory (staged) or z again (streamed)
  Centred a;
  const T* pass2 = staged ? reinterpret_cast<const T*>(stage) : src;
  long long v = threadIdx.x;
  for (; v + 3 * kGlobalThreads < nv; v += 4 * kGlobalThreads) {
    float x[4][W];
#pragma unroll
    for (int u = 0; u < 4; ++u) load16(pass2 + (v + u * kGlobalThreads) * W, x[u]);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int k = 0; k < W; ++k) a.add(x[u][k], mean);
    }
  }
  for (; v < nv; v += kGlobalThreads) {
    float x[W];
    load16(pass2 + v * W, x);
#pragma unroll
    for (int k = 0; k < W; ++k) a.add(x[k], mean);
  }
  for (long long i = nv * W + threadIdx.x; i < len; i += kGlobalThreads) {
    a.add(Vec<T>::get(src + i), mean);
  }

  // join 2: the centred sums. After this barrier no CTA touches a peer's shared memory.
  float cen[3] = {a.a2, a.a3, a.a4};
  cta_sum<kGlobalWarps>(cen, &sc.red[1]);
  if (threadIdx.x < n_ranks) {
#pragma unroll
    for (int k = 0; k < 3; ++k) *cluster.map_shared_rank(&sc.cen[k][rank], threadIdx.x) = cen[k];
  }
  cluster.sync();
  if (rank == 0 && threadIdx.x == 0) {  // moments.cu's finalize_kernel
    float t2 = sc.cen[0][0], t3 = sc.cen[1][0], t4 = sc.cen[2][0];
    for (int r = 1; r < n_ranks; ++r) {
      t2 += sc.cen[0][r];
      t3 += sc.cen[1][r];
      t4 += sc.cen[2][r];
    }
    const float var = t2 / nf;
    const float sd = sqrtf(var);
    const float sd3 = sd * var;
    const float var2 = var * var;
    out[0] = mean;
    out[1] = var;
    out[2] = sd == 0.0f ? 0.0f : (t3 / nf) / (sd3 == 0.0f ? 1.0f : sd3);
    out[3] = var == 0.0f ? 0.0f : (t4 / nf) / (var2 == 0.0f ? 1.0f : var2);
  }
}

// ---- per-dimension forward ----------------------------------------------------------------

template <typename T>
struct PerdimScratch {
  static constexpr int kCols = 32 * Vec<T>::kWidth;
  float part[kPerdimWarps][kCols];  // the warps' column sums, one join at a time
  __align__(16) float cta[kCols];   // the CTA's column sums
  __align__(16) float sum[kMaxPerdimCluster][kCols];  // join 1: rank r's, pushed by rank r
  float cen[3][kCols];  // join 2: [r * share + j] rank r's centred sums of column j of mine
  float mean[kCols];
};

// One cluster of R CTAs a tile of kCols adjacent columns (grid R x tiles); rank r owns
// rows [r rows, min((r + 1) rows, B)) of the tile; the staged rows sit in dynamic shared
// memory as [rows][kCols] elements of T.
template <typename T>
__global__ void __launch_bounds__(kPerdimThreads)
perdim_forward_kernel(const T* __restrict__ z, long long B, long long L, long long rows,
                      int staged, float* __restrict__ out) {
  constexpr int V = Vec<T>::kWidth;
  constexpr int kCols = PerdimScratch<T>::kCols;
  extern __shared__ __align__(128) unsigned char stage_bytes[];
  T* stage = reinterpret_cast<T*>(stage_bytes);
  __shared__ __align__(16) PerdimScratch<T> sc;
  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive_relaxed();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_ranks = static_cast<int>(cluster.num_blocks());
  const long long c0 = static_cast<long long>(blockIdx.x / n_ranks) * kCols;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long col = c0 + lane * V;  // this lane's first column
  const int ncols = static_cast<int>(max(0LL, min(static_cast<long long>(V), L - col)));
  // every row then starts on a 16-byte boundary and a lane's V columns are all in or all out
  const bool vec = aligned16(z) && (L * static_cast<long long>(sizeof(T))) % 16 == 0;
  const long long b0 = min(static_cast<long long>(rank) * rows, B);
  const long long b1 = min(b0 + rows, B);
  const float nf = static_cast<float>(B);

  // row b of this lane's columns from z, kept in the stage when staged
  auto load_z = [&](long long b, float* x) {
    const T* p = z + b * L + col;
    T* keep = stage + (b - b0) * kCols + lane * V;
    if (vec) {
      if (ncols == V) {
        const uint4 q = *reinterpret_cast<const uint4*>(p);
        if (staged) *reinterpret_cast<uint4*>(keep) = q;
        Vec<T>::widen(q, x);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) x[j] = 0.0f;
      }
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        x[j] = j < ncols ? Vec<T>::get(p + j) : 0.0f;
        if (staged && j < ncols) keep[j] = p[j];
      }
    }
  };
  // row b again: from the stage, or from z
  auto reload = [&](long long b, float* x) {
    const T* p = staged ? stage + (b - b0) * kCols + lane * V : z + b * L + col;
    if (vec && ncols == V) {
      load16(p, x);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) x[j] = j < ncols ? Vec<T>::get(p + j) : 0.0f;
    }
  };

  // pass 1: the column sums of this CTA's rows
  float acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = 0.0f;
  for (long long b = b0 + warp; b < b1; b += kRowGroup * kPerdimWarps) {
    float x[kRowGroup][V];
#pragma unroll
    for (int u = 0; u < kRowGroup; ++u) {
      if (b + u * kPerdimWarps < b1) load_z(b + u * kPerdimWarps, x[u]);
    }
#pragma unroll
    for (int u = 0; u < kRowGroup; ++u) {
      if (b + u * kPerdimWarps < b1) {
#pragma unroll
        for (int j = 0; j < V; ++j) acc[j] += x[u][j];
      }
    }
  }
#pragma unroll
  for (int j = 0; j < V; ++j) sc.part[warp][lane * V + j] = acc[j];
  __syncthreads();
  if (threadIdx.x < kCols) {
    float s = sc.part[0][threadIdx.x];
    for (int w = 1; w < kPerdimWarps; ++w) s += sc.part[w][threadIdx.x];
    sc.cta[threadIdx.x] = s;
  }
  __syncthreads();

  // join 1: every rank's column sums into every peer, 16 bytes a store
  cluster_wait();  // every peer runs: its shared memory may be written
  constexpr int kQuads = kCols / 4;
  for (int i = threadIdx.x; i < n_ranks * kQuads; i += kPerdimThreads) {
    const int peer = i / kQuads;
    const int q = i % kQuads;
    float4* dst = reinterpret_cast<float4*>(&sc.sum[rank][0]) + q;
    *cluster.map_shared_rank(dst, peer) = reinterpret_cast<const float4*>(sc.cta)[q];
  }
  cluster.sync();
  if (threadIdx.x < kCols) {
    float t = sc.sum[0][threadIdx.x];
    for (int r = 1; r < n_ranks; ++r) t += sc.sum[r][threadIdx.x];
    sc.mean[threadIdx.x] = t / nf;
  }
  __syncthreads();

  // pass 2: the centred powers of this CTA's rows
  float m[V];
  Centred a[V];
#pragma unroll
  for (int j = 0; j < V; ++j) m[j] = sc.mean[lane * V + j];
  for (long long b = b0 + warp; b < b1; b += kRowGroup * kPerdimWarps) {
    float x[kRowGroup][V];
#pragma unroll
    for (int u = 0; u < kRowGroup; ++u) {
      if (b + u * kPerdimWarps < b1) reload(b + u * kPerdimWarps, x[u]);
    }
#pragma unroll
    for (int u = 0; u < kRowGroup; ++u) {
      if (b + u * kPerdimWarps < b1) {
#pragma unroll
        for (int j = 0; j < V; ++j) a[j].add(x[u][j], m[j]);
      }
    }
  }

  // join 2: each column's centred sums go to the rank that writes that column, one power
  // at a time through the warps' buffer
  const int share = kCols / n_ranks;
  auto push_centred = [&](int k, const float (&v)[V]) {
    __syncthreads();  // the buffer's last readers are done
#pragma unroll
    for (int j = 0; j < V; ++j) sc.part[warp][lane * V + j] = v[j];
    __syncthreads();
    if (threadIdx.x < kCols) {
      float s = sc.part[0][threadIdx.x];
      for (int w = 1; w < kPerdimWarps; ++w) s += sc.part[w][threadIdx.x];
      const int owner = threadIdx.x / share;
      *cluster.map_shared_rank(&sc.cen[k][rank * share + threadIdx.x % share], owner) = s;
    }
  };
  {
    float v2[V], v3[V], v4[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      v2[j] = a[j].a2;
      v3[j] = a[j].a3;
      v4[j] = a[j].a4;
    }
    push_centred(0, v2);
    push_centred(1, v3);
    push_centred(2, v4);
  }
  // After this barrier no CTA touches a peer's shared memory.
  cluster.sync();
  if (threadIdx.x < share) {
    const int j = rank * share + threadIdx.x;
    const long long c = c0 + j;
    if (c < L) {  // moments.cu's finalize, per column
      float t2 = sc.cen[0][threadIdx.x], t3 = sc.cen[1][threadIdx.x],
            t4 = sc.cen[2][threadIdx.x];
      for (int r = 1; r < n_ranks; ++r) {
        t2 += sc.cen[0][r * share + threadIdx.x];
        t3 += sc.cen[1][r * share + threadIdx.x];
        t4 += sc.cen[2][r * share + threadIdx.x];
      }
      const float var = t2 / nf;
      const float sd = sqrtf(var);
      const float sd3 = sd * var;
      const float var2 = var * var;
      out[c] = sc.mean[j];
      out[L + c] = var;
      out[2 * L + c] = sd == 0.0f ? 0.0f : (t3 / nf) / (sd3 == 0.0f ? 1.0f : sd3);
      out[3 * L + c] = var == 0.0f ? 0.0f : (t4 / nf) / (var2 == 0.0f ? 1.0f : var2);
    }
  }
}

// ---- backwards ----------------------------------------------------------------------------

struct BwdCoef {  // moments.cu's, unchanged
  float mean, m2c, m3c, m4c, inv_var, c_mean, c_var, c_skew, c_kurt;
  __device__ float grad(float z) const {
    const float zc = z - mean;
    const float d_skew = c_skew * (zc * zc - m2c - m3c * zc * inv_var);
    const float d_kurt = c_kurt * (zc * zc * zc - m3c - m4c * zc * inv_var);
    return c_mean + c_var * zc + d_skew + d_kurt;
  }
};

template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
global_backward_kernel(const T* __restrict__ z, const float* __restrict__ moments,
                       const float* __restrict__ gout, T* __restrict__ grad, long long n,
                       long long nv) {
  constexpr int W = Vec<T>::kWidth;
  __shared__ BwdCoef coef;
  const long long first =
      static_cast<long long>(blockIdx.x) * kBwdThreads * kBwdUnroll + threadIdx.x;
  const long long step = static_cast<long long>(gridDim.x) * kBwdThreads * kBwdUnroll;
  // the first vectors' loads go out before the coefficients are ready
  float x[kBwdUnroll][W];
  auto load = [&](long long v) {
#pragma unroll
    for (int u = 0; u < kBwdUnroll; ++u) {
      if (v + u * kBwdThreads < nv) load16(z + (v + u * kBwdThreads) * W, x[u]);
    }
  };
  load(first);
  if (threadIdx.x == 0) {  // the float operations of moments.cu's backward_kernel
    const float nf = static_cast<float>(n);
    const float var = moments[1];
    const float sd = sqrtf(var);
    const float sd3 = sd * var;
    BwdCoef c;
    c.mean = moments[0];
    c.m2c = var;
    c.m3c = moments[2] * sd * var;
    c.m4c = moments[3] * var * var;
    c.inv_var = var == 0.0f ? 0.0f : 1.0f / var;
    const float inv_sd3 = sd3 == 0.0f ? 0.0f : 1.0f / sd3;
    c.c_mean = gout[0] * (1.0f / nf);
    c.c_var = gout[1] * (2.0f / nf);
    c.c_skew = gout[2] * ((3.0f / nf) * inv_sd3);
    c.c_kurt = gout[3] * ((4.0f / nf) * (c.inv_var * c.inv_var));
    coef = c;
  }
  __syncthreads();
  const BwdCoef c = coef;
  for (long long v = first; v < nv; v += step) {
    if (v != first) load(v);
#pragma unroll
    for (int u = 0; u < kBwdUnroll; ++u) {
      if (v + u * kBwdThreads < nv) {
#pragma unroll
        for (int k = 0; k < W; ++k) x[u][k] = c.grad(x[u][k]);
        *reinterpret_cast<uint4*>(grad + (v + u * kBwdThreads) * W) = Vec<T>::narrow(x[u]);
      }
    }
  }
  // the ragged tail, or every element when z or grad is off 16 bytes
  for (long long i = nv * W + static_cast<long long>(blockIdx.x) * kBwdThreads + threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * kBwdThreads) {
    Vec<T>::put(grad + i, c.grad(Vec<T>::get(z + i)));
  }
}

// grid (tiles of kCols columns, row blocks); the tile's coefficients once a CTA
template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
perdim_backward_kernel(const T* __restrict__ z, const float* __restrict__ moments,
                       const float* __restrict__ gout, T* __restrict__ grad, long long B,
                       long long L) {
  constexpr int V = Vec<T>::kWidth;
  constexpr int kCols = 32 * V;
  __shared__ BwdCoef coef[kCols];
  const long long c0 = static_cast<long long>(blockIdx.x) * kCols;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long lane_col = c0 + lane * V;  // this lane's first column
  const int ncols =
      static_cast<int>(max(0LL, min(static_cast<long long>(V), L - lane_col)));
  const bool vec = aligned16(z) && aligned16(grad) &&
                   (L * static_cast<long long>(sizeof(T))) % 16 == 0;
  // a row a warp at a time; the first row's loads go out before the coefficients are ready
  const long long first = static_cast<long long>(blockIdx.y) * kBwdWarps + warp;
  const long long stride = static_cast<long long>(gridDim.y) * kBwdWarps;
  float x[V];
  auto load = [&](long long row) {
    const T* p = z + row * L + lane_col;
    if (vec) {
      load16(p, x);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) x[j] = j < ncols ? Vec<T>::get(p + j) : 0.0f;
    }
  };
  if (first < B && ncols > 0) load(first);
  const float nf = static_cast<float>(B);
  if (threadIdx.x < kCols && c0 + threadIdx.x < L) {
    // the float operations of moments.cu's perdim_backward_kernel
    const long long col = c0 + threadIdx.x;
    const float var = moments[L + col];
    const float sd = sqrtf(var);
    const float sd3 = sd * var;
    BwdCoef c;
    c.mean = moments[col];
    c.m2c = var;
    c.m3c = moments[2 * L + col] * sd * var;
    c.m4c = moments[3 * L + col] * var * var;
    c.inv_var = var == 0.0f ? 0.0f : 1.0f / var;
    const float inv_sd3 = sd3 == 0.0f ? 0.0f : 1.0f / sd3;
    c.c_mean = gout[col] / nf;
    c.c_var = gout[L + col] * (2.0f / nf);
    c.c_skew = gout[2 * L + col] * (3.0f / nf) * inv_sd3;
    c.c_kurt = gout[3 * L + col] * (4.0f / nf) * (c.inv_var * c.inv_var);
    coef[threadIdx.x] = c;
  }
  __syncthreads();
  if (ncols == 0) return;  // no barrier follows
  const BwdCoef* c = coef + lane * V;  // read where used: a copy in registers cut occupancy
  for (long long b = first; b < B; b += stride) {
    if (b != first) load(b);
    T* g = grad + b * L + lane_col;
#pragma unroll
    for (int j = 0; j < V; ++j) x[j] = c[j].grad(x[j]);
    if (vec) {
      *reinterpret_cast<uint4*>(g) = Vec<T>::narrow(x);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        if (j < ncols) Vec<T>::put(g + j, x[j]);
      }
    }
  }
}

// ---- launches -------------------------------------------------------------------------------

// The current device set to `device` for a launch, and restored after it.
struct DeviceGuard {
  int previous = -1;
  cudaError_t error = cudaSuccess;
  explicit DeviceGuard(int device) {
    int current = 0;
    error = cudaGetDevice(&current);
    if (error == cudaSuccess && current != device) {
      error = cudaSetDevice(device);
      if (error == cudaSuccess) previous = current;
    }
  }
  ~DeviceGuard() {
    if (previous >= 0) cudaSetDevice(previous);
  }
};

cudaLaunchConfig_t launch_config(dim3 grid, int threads, size_t smem, int cluster,
                                 cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(static_cast<unsigned>(threads), 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = static_cast<unsigned>(cluster);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Per device and kernel: the attributes set so far, and the resident clusters of each
// (cluster size, shared memory) asked for. Set once, read on every launch.
struct KernelState {
  int device;
  const void* kernel;
  size_t max_smem;
  bool non_portable;
};
struct Occupancy {
  int device;
  const void* kernel;
  int cluster;
  size_t smem;
  int active;
};
std::mutex prepare_mutex;
std::vector<KernelState> kernel_states;
std::vector<Occupancy> occupancies;

template <typename... Args>
int prepare(void (*kernel)(Args...), int threads, int cluster, size_t smem, int device,
            int* active) {
  std::lock_guard<std::mutex> lock(prepare_mutex);
  const void* key = reinterpret_cast<const void*>(kernel);
  for (const Occupancy& o : occupancies) {
    if (o.device == device && o.kernel == key && o.cluster == cluster && o.smem == smem) {
      *active = o.active;
      return 0;
    }
  }
  KernelState* state = nullptr;
  for (KernelState& s : kernel_states) {
    if (s.device == device && s.kernel == key) state = &s;
  }
  if (state == nullptr) {
    kernel_states.push_back({device, key, 0, false});
    state = &kernel_states.back();
  }
  cudaError_t err;
  if (smem > state->max_smem) {  // never lowered: a larger launch may come back
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    state->max_smem = smem;
  }
  if (cluster > kPortableCluster && !state->non_portable) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
    state->non_portable = true;
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      launch_config(dim3(static_cast<unsigned>(cluster)), threads, smem, cluster, nullptr, &attr);
  int n_active = 0;
  err = cudaOccupancyMaxActiveClusters(&n_active, kernel, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  occupancies.push_back({device, key, cluster, smem, n_active});
  *active = n_active;
  return 0;
}

int finish(int rc) {
  if (rc != 0) cudaGetLastError();  // a refused launch leaves no error for the next one
  return rc;
}

template <typename... Args, typename... Actual>
int launch_cluster(void (*kernel)(Args...), dim3 grid, int threads, int cluster, size_t smem,
                   int device, cudaStream_t stream, Actual... args) {
  int active = 0;
  const int rc = prepare(kernel, threads, cluster, smem, device, &active);
  if (rc != 0) return finish(rc);
  if (active == 0) return kErrorNoActiveCluster;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(grid, threads, smem, cluster, stream, &attr);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return finish(static_cast<int>(err));
  return finish(static_cast<int>(cudaGetLastError()));
}

int sm_count(int device) {
  static int counts[64] = {};
  if (device < 0 || device >= 64) return 132;
  if (counts[device] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) != cudaSuccess ||
        n <= 0) {
      cudaGetLastError();
      return 132;
    }
    counts[device] = n;
  }
  return counts[device];
}

template <typename T>
int global_forward(const void* z, long long n, int cluster, long long slice, int staged,
                   float* out, int device, cudaStream_t stream) {
  const size_t smem = staged ? static_cast<size_t>(slice) * sizeof(T) : 0;
  return launch_cluster(global_forward_kernel<T>, dim3(static_cast<unsigned>(cluster)),
                        kGlobalThreads, cluster, smem, device, stream,
                        static_cast<const T*>(z), n, slice, staged, out);
}

template <typename T>
int perdim_forward(const void* z, long long B, long long L, int cluster, long long rows,
                   int staged, float* out, int device, cudaStream_t stream) {
  constexpr long long kCols = PerdimScratch<T>::kCols;
  const long long tiles = (L + kCols - 1) / kCols;
  if (tiles * cluster > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = staged ? static_cast<size_t>(rows * kCols) * sizeof(T) : 0;
  return launch_cluster(perdim_forward_kernel<T>,
                        dim3(static_cast<unsigned>(tiles * cluster)), kPerdimThreads, cluster,
                        smem, device, stream, static_cast<const T*>(z), B, L, rows, staged, out);
}

template <typename T>
int global_backward(const void* z, long long n, const float* moments, const float* gout,
                    void* grad, int device, cudaStream_t stream) {
  constexpr int W = Vec<T>::kWidth;
  const long long nv = (aligned16(z) && aligned16(grad)) ? n / W : 0;
  const int sms = sm_count(device);
  long long blocks = (nv + kBwdThreads * kBwdUnroll - 1) / (kBwdThreads * kBwdUnroll);
  blocks = (blocks + sms - 1) / sms * sms;  // a multiple of the SMs
  if (blocks < sms) blocks = sms;
  if (blocks > static_cast<long long>(sms) * kBwdMaxWaves) {
    blocks = static_cast<long long>(sms) * kBwdMaxWaves;
  }
  global_backward_kernel<T><<<static_cast<unsigned>(blocks), kBwdThreads, 0, stream>>>(
      static_cast<const T*>(z), moments, gout, static_cast<T*>(grad), n, nv);
  return finish(static_cast<int>(cudaGetLastError()));
}

template <typename T>
int perdim_backward(const void* z, long long B, long long L, const float* moments,
                    const float* gout, void* grad, int device, cudaStream_t stream) {
  constexpr long long kCols = 32 * Vec<T>::kWidth;
  const long long tiles = (L + kCols - 1) / kCols;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  // a row a warp, up to about kBwdResident CTAs an SM; warps take more rows beyond
  long long row_blocks = (B + kBwdWarps - 1) / kBwdWarps;
  const long long cap = (static_cast<long long>(sm_count(device)) * kBwdResident + tiles - 1) /
                        tiles;
  if (row_blocks > cap) row_blocks = cap;
  if (row_blocks > 65535) row_blocks = 65535;
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(row_blocks));
  perdim_backward_kernel<T><<<grid, kBwdThreads, 0, stream>>>(
      static_cast<const T*>(z), moments, gout, static_cast<T*>(grad), B, L);
  return finish(static_cast<int>(cudaGetLastError()));
}

constexpr int kInvalid = static_cast<int>(cudaErrorInvalidValue);

}  // namespace

// z: n values, f32 (is_bf16 == 0) or bf16; out: 4 floats. One cluster of `cluster` CTAs
// (at most 16), rank r owning [r slice, min((r + 1) slice, n)); slice a multiple of 16
// bytes of z. staged: each slice in shared memory (z 16-byte aligned, slice within the
// budget).
extern "C" int mc_global_forward(const void* z, int is_bf16, long long n, int cluster,
                                 long long slice, int staged, float* out, int device,
                                 void* stream) {
  const long long width = is_bf16 ? 8 : 4;
  const size_t elem = is_bf16 ? 2 : 4;
  if (n <= 0 || cluster <= 0 || slice <= 0 || slice % width != 0 || slice > n + width) {
    return kInvalid;
  }
  if (cluster > kMaxCluster) return static_cast<int>(cudaErrorInvalidClusterSize);
  if (slice * cluster < n) return kInvalid;
  if (staged && (reinterpret_cast<uintptr_t>(z) % 16 != 0 ||
                 static_cast<size_t>(slice) * elem > kStageBudget)) {
    return kInvalid;
  }
  DeviceGuard guard(device);
  if (guard.error != cudaSuccess) return finish(static_cast<int>(guard.error));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? global_forward<__nv_bfloat16>(z, n, cluster, slice, staged, out, device, s)
                 : global_forward<float>(z, n, cluster, slice, staged, out, device, s);
}

// z: (B, L) row-major; out: (4, L) floats, rows mean, var, skew, kurt of each column.
// Clusters of `cluster` CTAs (1, 2, 4 or 8), one a tile of 128 (f32) or 256 (bf16)
// columns, rank r owning rows [r rows, min((r + 1) rows, B)). staged: those rows of the
// tile kept in shared memory (within the budget).
extern "C" int mc_perdim_forward(const void* z, int is_bf16, long long B, long long L,
                                 int cluster, long long rows, int staged, float* out,
                                 int device, void* stream) {
  const long long cols = is_bf16 ? 256 : 128;
  const size_t elem = is_bf16 ? 2 : 4;
  if (B <= 0 || L <= 0 || cluster <= 0 || rows <= 0 || rows > B) return kInvalid;
  if (cluster > kMaxPerdimCluster || cols % cluster != 0) {
    return static_cast<int>(cudaErrorInvalidClusterSize);
  }
  if (rows * cluster < B) return kInvalid;
  if (staged && static_cast<size_t>(rows * cols) * elem > kStageBudget) return kInvalid;
  DeviceGuard guard(device);
  if (guard.error != cudaSuccess) return finish(static_cast<int>(guard.error));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16
             ? perdim_forward<__nv_bfloat16>(z, B, L, cluster, rows, staged, out, device, s)
             : perdim_forward<float>(z, B, L, cluster, rows, staged, out, device, s);
}

// moments, gout: 4 floats each, on the device; grad: n values of z's type.
extern "C" int mc_global_backward(const void* z, int is_bf16, long long n,
                                  const float* moments, const float* gout, void* grad,
                                  int device, void* stream) {
  if (n <= 0) return kInvalid;
  DeviceGuard guard(device);
  if (guard.error != cudaSuccess) return finish(static_cast<int>(guard.error));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? global_backward<__nv_bfloat16>(z, n, moments, gout, grad, device, s)
                 : global_backward<float>(z, n, moments, gout, grad, device, s);
}

// moments, gout: (4, L) floats each, on the device; grad: (B, L) of z's type.
extern "C" int mc_perdim_backward(const void* z, int is_bf16, long long B, long long L,
                                  const float* moments, const float* gout, void* grad,
                                  int device, void* stream) {
  if (B <= 0 || L <= 0) return kInvalid;
  DeviceGuard guard(device);
  if (guard.error != cudaSuccess) return finish(static_cast<int>(guard.error));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? perdim_backward<__nv_bfloat16>(z, B, L, moments, gout, grad, device, s)
                 : perdim_backward<float>(z, B, L, moments, gout, grad, device, s);
}

// cudaOccupancyMaxActiveClusters of a forward (kind 0 global, 1 per dimension) on
// clusters of `cluster` CTAs with `smem` bytes of dynamic shared memory, into *active.
extern "C" int mc_occupancy(int kind, int is_bf16, int cluster, long long smem, int device,
                            int* active) {
  if (cluster <= 0 || smem < 0 || static_cast<size_t>(smem) > kStageBudget) return kInvalid;
  DeviceGuard guard(device);
  if (guard.error != cudaSuccess) return finish(static_cast<int>(guard.error));
  const size_t bytes = static_cast<size_t>(smem);
  int rc;
  if (kind == 0) {
    if (cluster > kMaxCluster) return static_cast<int>(cudaErrorInvalidClusterSize);
    rc = is_bf16 ? prepare(global_forward_kernel<__nv_bfloat16>, kGlobalThreads, cluster, bytes,
                           device, active)
                 : prepare(global_forward_kernel<float>, kGlobalThreads, cluster, bytes, device,
                           active);
  } else if (kind == 1) {
    if (cluster > kMaxPerdimCluster) return static_cast<int>(cudaErrorInvalidClusterSize);
    rc = is_bf16 ? prepare(perdim_forward_kernel<__nv_bfloat16>, kPerdimThreads, cluster, bytes,
                           device, active)
                 : prepare(perdim_forward_kernel<float>, kPerdimThreads, cluster, bytes, device,
                           active);
  } else {
    return kInvalid;
  }
  return finish(rc);
}

extern "C" const char* mc_error_string(int code) {
  if (code == kErrorNoActiveCluster) {
    return "cudaOccupancyMaxActiveClusters is 0: no cluster of this size and shared memory "
           "fits on the device at once";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
