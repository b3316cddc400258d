// Fused streaming anomaly scorer on one thread-block cluster a frame.
//
// Replaces the TPU kernel trustedai_cl_vae_ad_tpu/ops/stream_score.py::
// _stream_kernel (Pallas, launched by _stream_pallas), as stream_score.cu
// does, with the same function: per frame k it reads img, rec (H, W, C) f32
// in HWC order, the EMA maps (2, H, W) and the scalars (6,), and writes the
// new maps and scalars, the normalized error map (H, W) and [score, count]
// (stream_score.cu's header states the update).
//
// What bounds it on Hopper: the bytes, and the frame-wide reductions between them. A
// 224x300x3 frame moves 2.96 MB (44 bytes a pixel), 0.88 us at 3.35 TB/s; 16 frames 47.3 MB.
// Its two frame-wide reductions depend on each other (min/max of err before the map
// update, the mean and std of z before the count), so a frame cannot be split over
// independent blocks without a second launch. stream_score.cu gives each frame one
// 1024-thread block: one SM does the work, in four passes over global memory.
// The design: a cluster of C CTAs owns a frame (grid (C, K), cluster dims (C, 1, 1);
// ops/stream_score.py::stream_score_arrangement picks C by the frame count). Rank r owns
// the pixels [r s, min((r + 1) s, H W)) with s = ceil(H W / C) rounded up to a multiple of
// 4 (ops/stream_score.py::cluster_slice computes the same s), so every slice starts
// on a 16-byte boundary of the HWC image and of the maps. Each input is read once and each
// output written once: err of the slice stays in this CTA's shared memory and is
// overwritten in place by z, one float a pixel. img and rec are read as float4 (three a
// group of 4 pixels at C = 3), the maps, the new maps and norm as float4, where the
// frame's pointers allow it; other frames take scalar loads with the same arithmetic.
// The frame-wide reductions are joined through distributed shared memory, four times
// (min and max together, sum z, sum (z - mean)^2 two-pass as jnp.std is, the count): each
// CTA reduces its slice (warp shuffles, then shared memory) and warp 0 PUSHES the partial
// into slot [rank] of every peer's shared memory; one cluster.sync() then publishes all of
// them, and every thread folds the C partials of its own CTA's copy in rank order 0..C-1,
// so every CTA holds the same bits of e_min, e_max, the z mean and the z std (the zz > 3
// test then agrees across the frame). No thread reads a peer's shared memory after a
// barrier, so the remote latency is paid before the barrier, and after the fourth no CTA
// touches a peer's memory and none waits for another to exit. The first push waits for
// the cluster barrier that every CTA arrives at on entry (a peer's shared memory exists
// once the peer runs). Counts go to rank 0 alone, which writes the scalars and
// [score, count]. 512 threads and at most 64 registers a thread keep two CTAs an SM, so
// 30 clusters of 8 or 14 of 16 are resident at once on an H100.
// Build with --fmad=false and without fast math: every per-pixel step then
// rounds as PyTorch's ops do (and as stream_score.cu's do), so only the order
// of the frame-wide sums differs from the plain version
// (ops/stream_score.py::stream_score_step_reference).
// A dropped frame (valid[k] == 0) keeps its maps and scalars and reports
// score NaN and count 0, as in stream_score.cu.
// A launch the card refuses (a cluster size it does not take, a slice larger
// than a CTA's shared memory, no cluster of this size resident at once)
// returns its error; nothing falls back to stream_score.cu.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstddef>
#include <cstdint>
#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 4;  // pixels a thread takes at a time; every slice starts on a multiple
constexpr int kPortableCluster = 8;
constexpr int kMaxCluster = 16;  // Hopper's largest (non-portable) cluster
// returned when cudaOccupancyMaxActiveClusters finds no cluster of the size resident
constexpr int kErrorNoActiveCluster = 100000;

// the joins: min and max of err, sum z, sum (z - mean)^2
enum Slot { kMin, kMax, kSum, kSq, kSlots };

struct Scratch {
  float red[kSlots][kWarps];        // the warps' results of the CTA reductions
  unsigned red_count[kWarps];
  float parts[kSlots][kMaxCluster];  // rank r's partial of each join, pushed there by rank r
  unsigned counts[kMaxCluster];      // (rank 0's) the ranks' counts
};

struct SumOp {
  __device__ float operator()(float a, float b) const { return a + b; }
  static __device__ float identity() { return 0.0f; }
};

// min/max that propagate NaN, like jnp.min / jnp.max (and stream_score.cu)
struct MinOp {
  __device__ float operator()(float a, float b) const { return (a != a || a < b) ? a : b; }
  static __device__ float identity() { return CUDART_INF_F; }
};

struct MaxOp {
  __device__ float operator()(float a, float b) const { return (a != a || a > b) ? a : b; }
  static __device__ float identity() { return -CUDART_INF_F; }
};

__host__ __device__ inline int slice_pixels(int hw, int cluster) {
  const int per_rank = (hw + cluster - 1) / cluster;
  return (per_rank + kGroup - 1) / kGroup * kGroup;
}

__device__ inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// The cluster barrier in two halves: arrive (relaxed: orders nothing) and wait.
__device__ inline void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ inline void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

template <class Op>
__device__ inline float warp_reduce(float v, Op op) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ inline unsigned warp_sum(unsigned v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The CTA's reduction of v: each warp's, then every warp's over the warps' results, so
// every thread returns the CTA's value.
template <class Op>
__device__ inline float cta_reduce(float v, Op op, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_reduce(v, op);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float w = lane < kWarps ? red[lane] : Op::identity();
  return __shfl_sync(0xffffffffu, warp_reduce(w, op), 0);
}

// Warp 0 pushes this CTA's partial into slot `slot` of every rank's shared memory: lane r
// writes rank r's copy. The caller's cluster.sync() then publishes it.
__device__ inline void push(cg::cluster_group& cluster, Scratch& sc, int slot, int rank,
                            int n_ranks, float v) {
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < 32 && lane < n_ranks) {
    *cluster.map_shared_rank(&sc.parts[slot][rank], lane) = v;
  }
}

// The ranks' partials of a join, folded in rank order 0..n-1 from this CTA's own copy:
// every thread of every CTA gets the same bits.
template <class Op>
__device__ inline float fold(const Scratch& sc, int slot, Op op, int n_ranks) {
  float acc = sc.parts[slot][0];
#pragma unroll
  for (int r = 1; r < kMaxCluster; ++r) {
    if (r < n_ranks) acc = op(acc, sc.parts[slot][r]);
  }
  return acc;
}

// Group g of the slice in shared memory (n of its 4 pixels are the frame's):
// one 16-byte load for a whole group.
__device__ inline void load_group(const float4* slice_buf, int g, int n, float v[kGroup]) {
  if (n == kGroup) {
    const float4 u = slice_buf[g];
    v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
  } else {
    const float* buf = reinterpret_cast<const float*>(slice_buf);
#pragma unroll
    for (int i = 0; i < kGroup; ++i) v[i] = i < n ? buf[g * kGroup + i] : 0.0f;
  }
}

__device__ inline void store_group(float4* slice_buf, int g, int n, const float v[kGroup]) {
  if (n == kGroup) {
    slice_buf[g] = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    float* buf = reinterpret_cast<float*>(slice_buf);
    for (int i = 0; i < n; ++i) buf[g * kGroup + i] = v[i];
  }
}

// err of one pixel: sum over the channels of (x - x_hat)^2, in channel order
__device__ inline float pixel_err(const float* a, const float* b, int c) {
  float d = a[0] - b[0];
  float e = d * d;
  for (int ch = 1; ch < c; ++ch) {
    d = a[ch] - b[ch];
    e = e + d * d;
  }
  return e;
}

// The 3 channels of the n pixels from p of a 16-byte aligned HWC frame of C = 3.
__device__ inline void load_rgb(const float* x, int p, int n, float v[3 * kGroup]) {
  if (n == kGroup) {
    const float4* x4 = reinterpret_cast<const float4*>(x + static_cast<size_t>(p) * 3);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float4 u = x4[j];
      v[4 * j] = u.x; v[4 * j + 1] = u.y; v[4 * j + 2] = u.z; v[4 * j + 3] = u.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 3 * kGroup; ++j) {
      v[j] = j < 3 * n ? x[static_cast<size_t>(p) * 3 + j] : 0.0f;
    }
  }
}

// The EMA maps of the n pixels from p.
__device__ inline void load_maps(const float* maps, int hw, int p, int n, bool vec,
                                 float m0[kGroup], float m1[kGroup]) {
  if (vec && n == kGroup) {
    const float4 u = *reinterpret_cast<const float4*>(maps + p);
    const float4 v = *reinterpret_cast<const float4*>(maps + hw + p);
    m0[0] = u.x; m0[1] = u.y; m0[2] = u.z; m0[3] = u.w;
    m1[0] = v.x; m1[1] = v.y; m1[2] = v.z; m1[3] = v.w;
  } else {
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      m0[i] = i < n ? maps[p + i] : 0.0f;
      m1[i] = i < n ? maps[hw + p + i] : 0.0f;
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
stream_score_cluster_kernel(const float* __restrict__ img, const float* __restrict__ rec,
                            const float* __restrict__ maps, const float* __restrict__ scalars,
                            float alpha, float* __restrict__ out_maps,
                            float* __restrict__ out_scalars, float* __restrict__ norm,
                            float* __restrict__ score_count,
                            const unsigned char* __restrict__ valid, int hw, int c) {
  extern __shared__ float4 slice_buf[];  // err of this CTA's pixels, then z
  __shared__ Scratch sc;
  cg::cluster_group cluster = cg::this_cluster();
  // A peer's shared memory may be written only once the peer runs: this arrive is waited
  // for just before the first push, after pass 1.
  cluster_arrive_relaxed();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_ranks = static_cast<int>(cluster.num_blocks());

  const size_t k = blockIdx.y;
  img += k * hw * c;
  rec += k * hw * c;
  maps += k * 2 * hw;
  out_maps += k * 2 * hw;
  scalars += k * 6;
  out_scalars += k * 6;
  norm += k * hw;
  score_count += k * 2;

  const int slice = slice_pixels(hw, n_ranks);
  const int p0 = min(rank * slice, hw);
  const int p1 = min(p0 + slice, hw);
  const int n_groups = (p1 - p0 + kGroup - 1) / kGroup;

  const bool keep = valid != nullptr && valid[k] == 0;  // a dropped frame: state kept
  const float oma = 1.0f - alpha;
  const bool initialized = scalars[4] > 0.0f;

  // pass 1: err of the slice into shared memory, and its min / max
  float lmin = MinOp::identity();
  float lmax = MaxOp::identity();
  auto take_err = [&](int g, int n, const float e[kGroup]) {
    store_group(slice_buf, g, n, e);
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      if (i < n) {
        lmin = MinOp()(lmin, e[i]);
        lmax = MaxOp()(lmax, e[i]);
      }
    }
  };
  if (c == 3 && aligned16(img) && aligned16(rec)) {
    for (int g = threadIdx.x; g < n_groups; g += kThreads) {
      const int n = min(kGroup, p1 - (p0 + g * kGroup));
      float a[3 * kGroup], b[3 * kGroup], e[kGroup];
      load_rgb(img, p0 + g * kGroup, n, a);
      load_rgb(rec, p0 + g * kGroup, n, b);
#pragma unroll
      for (int i = 0; i < kGroup; ++i) e[i] = pixel_err(a + 3 * i, b + 3 * i, 3);
      take_err(g, n, e);
    }
  } else {  // other channel counts, or a frame off a 16-byte boundary: scalar loads
    for (int g = threadIdx.x; g < n_groups; g += kThreads) {
      const int p = p0 + g * kGroup;
      const int n = min(kGroup, p1 - p);
      float e[kGroup];
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        e[i] = i < n ? pixel_err(img + static_cast<size_t>(p + i) * c,
                                 rec + static_cast<size_t>(p + i) * c, c)
                     : 0.0f;
      }
      take_err(g, n, e);
    }
  }
  // join 1: min and max together
  lmin = cta_reduce(lmin, MinOp(), sc.red[kMin]);
  lmax = cta_reduce(lmax, MaxOp(), sc.red[kMax]);
  cluster_wait();  // every peer runs: its shared memory may be written
  push(cluster, sc, kMin, rank, n_ranks, lmin);
  push(cluster, sc, kMax, rank, n_ranks, lmax);
  cluster.sync();
  const float e_min = fold(sc, kMin, MinOp(), n_ranks);
  const float e_max = fold(sc, kMax, MaxOp(), n_ranks);
  const float min_ema = alpha * scalars[0] + oma * e_min;
  const float max_ema = alpha * scalars[1] + oma * e_max;
  const float denom = max_ema - min_ema;
  const float denom_safe = denom == 0.0f ? 1.0f : denom;

  // pass 2: norm, the new EMA maps, z (over err in shared memory) and sum z
  const bool vec_maps = aligned16(maps) && aligned16(maps + hw) && aligned16(out_maps) &&
                        aligned16(out_maps + hw) && aligned16(norm);
  float lsum = 0.0f;
  for (int g = threadIdx.x; g < n_groups; g += kThreads) {
    const int p = p0 + g * kGroup;
    const int n = min(kGroup, p1 - p);
    float e[kGroup], m0[kGroup], m1[kGroup];
    load_group(slice_buf, g, n, e);
    load_maps(maps, hw, p, n, vec_maps, m0, m1);
    float nv[kGroup], o0[kGroup], o1[kGroup], z[kGroup];
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      nv[i] = (e[i] - min_ema) / denom_safe;
      const float prev = initialized ? m0[i] : e[i];
      const float prev2 = initialized ? m1[i] : e[i] * e[i];
      const float ema = alpha * prev + oma * e[i];
      const float ema2 = alpha * prev2 + (oma * e[i]) * e[i];
      const float var = fabsf(ema2 - ema * ema);
      z[i] = (e[i] - ema) * (1.0f / sqrtf(var + 1e-10f));
      o0[i] = keep ? m0[i] : ema;
      o1[i] = keep ? m1[i] : ema2;
      if (i < n) lsum += z[i];
    }
    if (vec_maps && n == kGroup) {
      *reinterpret_cast<float4*>(norm + p) = make_float4(nv[0], nv[1], nv[2], nv[3]);
      *reinterpret_cast<float4*>(out_maps + p) = make_float4(o0[0], o0[1], o0[2], o0[3]);
      *reinterpret_cast<float4*>(out_maps + hw + p) = make_float4(o1[0], o1[1], o1[2], o1[3]);
    } else {
      for (int i = 0; i < n; ++i) {
        norm[p + i] = nv[i];
        out_maps[p + i] = o0[i];
        out_maps[hw + p + i] = o1[i];
      }
    }
    store_group(slice_buf, g, n, z);
  }
  // join 2: sum z
  lsum = cta_reduce(lsum, SumOp(), sc.red[kSum]);
  push(cluster, sc, kSum, rank, n_ranks, lsum);
  cluster.sync();
  const float n_pixels = static_cast<float>(hw);
  const float z_mean = fold(sc, kSum, SumOp(), n_ranks) / n_pixels;

  // pass 3: population std of z, two-pass
  float lsq = 0.0f;
  for (int g = threadIdx.x; g < n_groups; g += kThreads) {
    const int n = min(kGroup, p1 - (p0 + g * kGroup));
    float z[kGroup];
    load_group(slice_buf, g, n, z);
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      const float dz = z[i] - z_mean;
      if (i < n) lsq += dz * dz;
    }
  }
  // join 3: sum (z - mean)^2
  lsq = cta_reduce(lsq, SumOp(), sc.red[kSq]);
  push(cluster, sc, kSq, rank, n_ranks, lsq);
  cluster.sync();
  const float z_std = sqrtf(fold(sc, kSq, SumOp(), n_ranks) / n_pixels);
  const float std_safe = z_std == 0.0f ? 1.0f : z_std;

  // pass 4: count of zz > 3
  unsigned lcount = 0;
  for (int g = threadIdx.x; g < n_groups; g += kThreads) {
    const int n = min(kGroup, p1 - (p0 + g * kGroup));
    float z[kGroup];
    load_group(slice_buf, g, n, z);
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      const float zz = (z[i] - z_mean) / std_safe;
      lcount += (i < n && zz > 3.0f) ? 1u : 0u;
    }
  }
  // join 4: the count, pushed to rank 0 alone (an integer sum: every order gives the same
  // total). After this barrier no CTA touches a peer's shared memory, so none has to wait
  // for another before it exits.
  {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    lcount = warp_sum(lcount);
    if (lane == 0) sc.red_count[warp] = lcount;
    __syncthreads();
    if (threadIdx.x < 32) {
      const unsigned w = warp_sum(lane < kWarps ? sc.red_count[lane] : 0u);
      if (lane == 0) *cluster.map_shared_rank(&sc.counts[rank], 0) = w;
    }
  }
  cluster.sync();
  if (rank == 0 && threadIdx.x == 0) {
    unsigned total = 0;
    for (int r = 0; r < n_ranks; ++r) total += sc.counts[r];
    const float count = static_cast<float>(total);
    const float as_sum = alpha * scalars[2] + oma * count;
    const float as_sum2 = alpha * scalars[3] + (oma * count) * count;
    const float a_var = as_sum2 - as_sum * as_sum;
    out_scalars[0] = keep ? scalars[0] : min_ema;
    out_scalars[1] = keep ? scalars[1] : max_ema;
    out_scalars[2] = keep ? scalars[2] : as_sum;
    out_scalars[3] = keep ? scalars[3] : as_sum2;
    out_scalars[4] = keep ? scalars[4] : 1.0f;
    out_scalars[5] = keep ? scalars[5] : 0.0f;
    score_count[0] = keep ? CUDART_NAN_F : (count - as_sum) / sqrtf(a_var);
    score_count[1] = keep ? 0.0f : count;
  }
}

// The launch configuration of K frames of hw pixels on clusters of `cluster` CTAs.
cudaLaunchConfig_t launch_config(int k, int hw, int cluster, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(cluster), static_cast<unsigned>(k), 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(slice_pixels(hw, cluster)) * sizeof(float);
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = static_cast<unsigned>(cluster);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Per device: the kernel's attributes set so far, and the resident clusters of each
// (cluster size, shared memory) asked for. Set once, read on every launch.
struct Prepared {
  int device = -1;
  size_t max_smem = 0;
  bool non_portable = false;
  int sizes[8] = {};
  size_t smem[8] = {};
  int active[8] = {};
  int n = 0;
};

std::mutex prepare_mutex;
Prepared prepared[8];

// Sets the kernel's attributes for this launch shape on the current device and
// returns the clusters of that shape the device holds at once (in *active).
int prepare(int hw, int cluster, int* active) {
  std::lock_guard<std::mutex> lock(prepare_mutex);
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Prepared* p = nullptr;
  for (Prepared& q : prepared) {
    if (q.device == device || q.device < 0) {
      p = &q;
      break;
    }
  }
  if (p == nullptr) return static_cast<int>(cudaErrorInvalidDevice);
  p->device = device;
  const size_t smem = static_cast<size_t>(slice_pixels(hw, cluster)) * sizeof(float);
  for (int i = 0; i < p->n; ++i) {
    if (p->sizes[i] == cluster && p->smem[i] == smem) {
      *active = p->active[i];
      return 0;
    }
  }
  if (smem > p->max_smem) {  // never lowered: a larger frame may still be in use
    err = cudaFuncSetAttribute(stream_score_cluster_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    p->max_smem = smem;
  }
  if (cluster > kPortableCluster && !p->non_portable) {
    err = cudaFuncSetAttribute(stream_score_cluster_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
    p->non_portable = true;
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(1, hw, cluster, nullptr, &attr);
  int n_active = 0;
  err = cudaOccupancyMaxActiveClusters(&n_active, stream_score_cluster_kernel, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (p->n < 8) {
    p->sizes[p->n] = cluster;
    p->smem[p->n] = smem;
    p->active[p->n] = n_active;
    ++p->n;
  }
  *active = n_active;
  return 0;
}

int finish(int rc) {
  if (rc != 0) cudaGetLastError();  // a refused launch leaves no error for the next one
  return rc;
}

}  // namespace

extern "C" int stream_score_cluster_occupancy(int hw, int cluster, int* active) {
  if (hw <= 0 || cluster <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return finish(prepare(hw, cluster, active));
}

extern "C" int stream_score_cluster_launch(const float* img, const float* rec, const float* maps,
                                           const float* scalars, float alpha, float* out_maps,
                                           float* out_scalars, float* norm,
                                           float* score_count, const unsigned char* valid,
                                           int k, int hw, int c, int cluster, void* stream) {
  if (k <= 0 || hw <= 0 || c <= 0 || cluster <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (cluster > kMaxCluster) return static_cast<int>(cudaErrorInvalidClusterSize);
  int active = 0;
  const int rc = prepare(hw, cluster, &active);
  if (rc != 0) return finish(rc);
  if (active == 0) return kErrorNoActiveCluster;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      launch_config(k, hw, cluster, static_cast<cudaStream_t>(stream), &attr);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, stream_score_cluster_kernel, img, rec, maps,
                                             scalars, alpha, out_maps, out_scalars, norm,
                                             score_count, valid, hw, c);
  if (err != cudaSuccess) return finish(static_cast<int>(err));
  return finish(static_cast<int>(cudaGetLastError()));
}

extern "C" const char* stream_score_cluster_error_string(int code) {
  if (code == kErrorNoActiveCluster) {
    return "cudaOccupancyMaxActiveClusters is 0: no cluster of this size and shared memory "
           "fits on the device at once";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
