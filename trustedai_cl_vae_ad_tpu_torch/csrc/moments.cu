// Latent moments (mean, population variance, skew, kurtosis), forward and
// backward: of the whole latent matrix ("global"), and of each latent column
// over the batch ("per dimension").
//
// ---- Global ----
//
// Replaces the TPU kernel trustedai_cl_vae_ad_tpu/ops/moments.py:77
// (_global_kernel, Pallas, launched by _global_moments_pallas) and its
// analytic VJP at :174 (_global_bwd, which XLA fuses on the TPU). Forward:
// z (B, L) f32 or bf16, read as n = B*L values, gives four f32 scalars
//   mean = sum z / n
//   var  = sum (z - mean)^2 / n                       (population variance)
//   skew = (sum (z - mean)^3 / n) / (std * var), 0 where std == 0
//   kurt = (sum (z - mean)^4 / n) / (var * var), 0 where var == 0
// Backward: one elementwise pass
//   grad_i = gm/n + gv*2*zc_i/n
//          + gs*(3/n)*inv_std3*(zc_i^2 - m2c - m3c*zc_i*inv_var)
//          + gk*(4/n)*inv_var^2*(zc_i^3 - m3c - m4c*zc_i*inv_var)
// with zc = z - mean, m2c = var, m3c = skew*std^3, m4c = kurt*var^2, and
// inv_var, inv_std3 zero where var is zero; cast to z's type.
//
// What bounds it on Hopper: launch latency, not bytes. The flagship's latent
// (256, 2000) f32 is 2.05 MB: the forward reads it once (about 0.6 us at
// 3.35 TB/s), the backward reads it and writes as much (4.1 MB, about
// 1.2 us); either is below the cost of one launch.
//
// The design. The TPU kernel held all of z in one VMEM block and walked it
// twice in order; on Hopper blocks run in no order and carry nothing between
// them, so the reduction across blocks is explicit. The numerics stay
// two-pass (mean first, then centred sums: raw power sums cancel badly in
// f32 for the fourth moment), as three launches on one stream:
//   1. sum_kernel: G blocks, grid-stride, 16-byte loads; each block reduces
//      with warp shuffles, then shared memory, and writes one partial sum to
//      a scratch buffer the caller allocates;
//   2. centred_kernel: every block first adds the G partials in one fixed
//      order (so all blocks hold the same mean, bit for bit), then reduces
//      (z-mean)^2, ^3, ^4 over its share and writes three partials. z
//      (2 MB) is still in the 50 MB L2 from launch 1;
//   3. finalize_kernel: one block adds the partials in the same fixed order
//      and writes the four moments.
// G depends only on n, and no float atomics are used, so the result is the
// same bits from run to run: the loss is |target - kurtosis|, and a training
// run should be repeatable. Sums accumulate in f32. The backward derives its
// few scalar coefficients in every thread from the moments and the upstream
// gradients, which are device pointers: nothing is read back on the host.
//
// ---- Per dimension ----
//
// Replaces the TPU kernel trustedai_cl_vae_ad_tpu/ops/moments.py:98
// (_perdim_kernel, Pallas, launched by _perdim_moments_pallas) and its
// analytic VJP at :210 (_perdim_bwd). The same four moments, but of every
// column l of z (B, L) over its B rows (n = B): out (4, L) f32, rows mean,
// var, skew, kurt. The backward is the formula above with every coefficient
// a per-column value read from moments (4, L) and gout (4, L).
//
// What bounds it: launch latency again. At (256, 2000) f32 the forward
// reads 2.05 MB and writes 32 KB, the backward moves 4.2 MB.
//
// The design. The reduction runs DOWN the columns of a row-major matrix. A
// warp per column would read with a stride of L elements; a thread per
// column alone gives L threads of work. So a block of 32 x 8 threads owns a
// tile of adjacent columns and ALL rows: threadIdx.x picks the column (a
// warp reads adjacent columns of one row: coalesced), threadIdx.y strides
// the rows, and the 8 partial sums of a column meet in shared memory and
// are added in a fixed order. Because one block sees every row of its
// columns, the two passes (mean, then centred powers) need no step across
// blocks: ONE launch, no atomics, equal bits from run to run. The second
// read of the tile (32 columns x 256 rows x 4 B = 32 KB at the flagship's
// size) comes from L1/L2. bf16 takes two adjacent columns per thread as one
// 4-byte load when L is even and the view is 4-byte aligned, else one. The
// backward is one elementwise launch on the same tiling, with the rows
// spread over gridDim.y as well: a thread derives its column's
// coefficients once and walks its rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 1024;
constexpr int kMaxBwdBlocks = 4096;
constexpr int kTileX = 32;  // per dimension: threads across adjacent columns
constexpr int kTileY = 8;   // per dimension: threads down the rows
constexpr int kMaxRowBlocks = 256;

// 16-byte vector access for the two element types.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int kWidth = 4;
  static __device__ void load(const float* p, size_t v, float* x) {
    const float4 q = reinterpret_cast<const float4*>(p)[v];
    x[0] = q.x; x[1] = q.y; x[2] = q.z; x[3] = q.w;
  }
  static __device__ void store(float* p, size_t v, const float* x) {
    reinterpret_cast<float4*>(p)[v] = make_float4(x[0], x[1], x[2], x[3]);
  }
  static __device__ float get(const float* p, size_t i) { return p[i]; }
  static __device__ void put(float* p, size_t i, float x) { p[i] = x; }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kWidth = 8;
  // bf16 is the high half of an f32: widening is a shift
  static __device__ void load(const __nv_bfloat16* p, size_t v, float* x) {
    const uint4 q = reinterpret_cast<const uint4*>(p)[v];
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
  static __device__ void store(__nv_bfloat16* p, size_t v, const float* x) {
    reinterpret_cast<uint4*>(p)[v] =
        make_uint4(pack(x[0], x[1]), pack(x[2], x[3]), pack(x[4], x[5]), pack(x[6], x[7]));
  }
  static __device__ float get(const __nv_bfloat16* p, size_t i) { return __bfloat162float(p[i]); }
  static __device__ void put(__nv_bfloat16* p, size_t i, float x) { p[i] = __float2bfloat16_rn(x); }
};

// Sum v over the block in a fixed order; every thread gets the result.
// red holds 33 floats.
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = (blockDim.x + 31) >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float w = lane < n_warps ? red[lane] : 0.0f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) w += __shfl_xor_sync(0xffffffffu, w, o);
    if (lane == 0) red[32] = w;
  }
  __syncthreads();
  const float r = red[32];
  __syncthreads();  // red is reused by the next reduction
  return r;
}

// Sum of g per-block partials, in an order that depends only on g.
__device__ float sum_partials(const float* __restrict__ p, int g, float* red) {
  float acc = 0.0f;
  for (int i = threadIdx.x; i < g; i += blockDim.x) acc += p[i];
  return block_sum(acc, red);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
sum_kernel(const T* __restrict__ z, size_t n, size_t n_vec, float* __restrict__ partial) {
  __shared__ float red[33];
  constexpr int W = Vec<T>::kWidth;
  float x[W];
  float acc = 0.0f;
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t v = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; v < n_vec;
       v += stride) {
    Vec<T>::load(z, v, x);
#pragma unroll
    for (int k = 0; k < W; ++k) acc += x[k];
  }
  if (blockIdx.x == 0) {  // the ragged tail, or everything when z is not 16-byte aligned
    for (size_t i = n_vec * W + threadIdx.x; i < n; i += blockDim.x) acc += Vec<T>::get(z, i);
  }
  const float s = block_sum(acc, red);
  if (threadIdx.x == 0) partial[blockIdx.x] = s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
centred_kernel(const T* __restrict__ z, size_t n, size_t n_vec, float* __restrict__ partial) {
  __shared__ float red[33];
  constexpr int W = Vec<T>::kWidth;
  const int g = gridDim.x;
  const float mean = sum_partials(partial, g, red) / static_cast<float>(n);
  float x[W];
  float a2 = 0.0f, a3 = 0.0f, a4 = 0.0f;
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t v = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; v < n_vec;
       v += stride) {
    Vec<T>::load(z, v, x);
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const float zc = x[k] - mean;
      const float zc2 = zc * zc;
      a2 += zc2;
      a3 += zc2 * zc;
      a4 += zc2 * zc2;
    }
  }
  if (blockIdx.x == 0) {
    for (size_t i = n_vec * W + threadIdx.x; i < n; i += blockDim.x) {
      const float zc = Vec<T>::get(z, i) - mean;
      const float zc2 = zc * zc;
      a2 += zc2;
      a3 += zc2 * zc;
      a4 += zc2 * zc2;
    }
  }
  const float s2 = block_sum(a2, red);
  const float s3 = block_sum(a3, red);
  const float s4 = block_sum(a4, red);
  if (threadIdx.x == 0) {
    partial[g + blockIdx.x] = s2;
    partial[2 * g + blockIdx.x] = s3;
    partial[3 * g + blockIdx.x] = s4;
  }
}

__global__ void __launch_bounds__(kThreads)
finalize_kernel(const float* __restrict__ partial, int g, size_t n, float* __restrict__ out) {
  __shared__ float red[33];
  const float nf = static_cast<float>(n);
  const float mean = sum_partials(partial, g, red) / nf;
  const float s2 = sum_partials(partial + g, g, red);
  const float s3 = sum_partials(partial + 2 * g, g, red);
  const float s4 = sum_partials(partial + 3 * g, g, red);
  if (threadIdx.x == 0) {
    const float var = s2 / nf;
    const float sd = sqrtf(var);
    const float sd3 = sd * var;
    const float var2 = var * var;
    out[0] = mean;
    out[1] = var;
    out[2] = sd == 0.0f ? 0.0f : (s3 / nf) / (sd3 == 0.0f ? 1.0f : sd3);
    out[3] = var == 0.0f ? 0.0f : (s4 / nf) / (var2 == 0.0f ? 1.0f : var2);
  }
}

struct BwdCoef {
  float mean, m2c, m3c, m4c, inv_var, c_mean, c_var, c_skew, c_kurt;
  __device__ float grad(float z) const {
    const float zc = z - mean;
    const float d_skew = c_skew * (zc * zc - m2c - m3c * zc * inv_var);
    const float d_kurt = c_kurt * (zc * zc * zc - m3c - m4c * zc * inv_var);
    return c_mean + c_var * zc + d_skew + d_kurt;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
backward_kernel(const T* __restrict__ z, const float* __restrict__ moments,
                const float* __restrict__ gout, T* __restrict__ grad, size_t n, size_t n_vec) {
  constexpr int W = Vec<T>::kWidth;
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
  float x[W];
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t v = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; v < n_vec;
       v += stride) {
    Vec<T>::load(z, v, x);
#pragma unroll
    for (int k = 0; k < W; ++k) x[k] = c.grad(x[k]);
    Vec<T>::store(grad, v, x);
  }
  if (blockIdx.x == 0) {
    for (size_t i = n_vec * W + threadIdx.x; i < n; i += blockDim.x)
      Vec<T>::put(grad, i, c.grad(Vec<T>::get(z, i)));
  }
}

// ---- per dimension ----------------------------------------------------------

// V adjacent columns of one row, widened to f32.
template <typename T, int V>
struct Cols;

template <>
struct Cols<float, 1> {
  static __device__ void load(const float* p, float* x) { x[0] = *p; }
  static __device__ void store(float* p, const float* x) { *p = x[0]; }
};

template <>
struct Cols<__nv_bfloat16, 1> {
  static __device__ void load(const __nv_bfloat16* p, float* x) { x[0] = __bfloat162float(*p); }
  static __device__ void store(__nv_bfloat16* p, const float* x) { *p = __float2bfloat16_rn(x[0]); }
};

template <>
struct Cols<__nv_bfloat16, 2> {  // p is 4-byte aligned
  static __device__ void load(const __nv_bfloat16* p, float* x) {
    const unsigned w = *reinterpret_cast<const unsigned*>(p);
    x[0] = __uint_as_float(w << 16);
    x[1] = __uint_as_float(w & 0xffff0000u);
  }
  static __device__ void store(__nv_bfloat16* p, const float* x) {
    *reinterpret_cast<unsigned*>(p) = Vec<__nv_bfloat16>::pack(x[0], x[1]);
  }
};

// One block: kTileX * V adjacent columns, all B rows. With V == 2, L is
// even, so a thread whose first column is inside the matrix has both inside.
template <typename T, int V>
__global__ void __launch_bounds__(kTileX * kTileY)
perdim_forward_kernel(const T* __restrict__ z, size_t B, size_t L, float* __restrict__ out) {
  __shared__ float part[3][kTileY][kTileX * V];
  __shared__ float mean_s[kTileX * V];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const size_t col0 = (static_cast<size_t>(blockIdx.x) * kTileX + tx) * V;
  const bool live = col0 < L;
  const float nf = static_cast<float>(B);
  float x[V];
  float a[V];
#pragma unroll
  for (int k = 0; k < V; ++k) a[k] = 0.0f;
  if (live) {
    for (size_t b = ty; b < B; b += kTileY) {
      Cols<T, V>::load(z + b * L + col0, x);
#pragma unroll
      for (int k = 0; k < V; ++k) a[k] += x[k];
    }
  }
#pragma unroll
  for (int k = 0; k < V; ++k) part[0][ty][tx * V + k] = a[k];
  __syncthreads();
  if (ty == 0) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float s = 0.0f;
      for (int r = 0; r < kTileY; ++r) s += part[0][r][tx * V + k];
      mean_s[tx * V + k] = s / nf;
    }
  }
  __syncthreads();
  float m[V], a2[V], a3[V], a4[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    m[k] = mean_s[tx * V + k];
    a2[k] = a3[k] = a4[k] = 0.0f;
  }
  if (live) {
    for (size_t b = ty; b < B; b += kTileY) {
      Cols<T, V>::load(z + b * L + col0, x);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float zc = x[k] - m[k];
        const float zc2 = zc * zc;
        a2[k] += zc2;
        a3[k] += zc2 * zc;
        a4[k] += zc2 * zc2;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < V; ++k) {
    part[0][ty][tx * V + k] = a2[k];
    part[1][ty][tx * V + k] = a3[k];
    part[2][ty][tx * V + k] = a4[k];
  }
  __syncthreads();
  if (ty == 0 && live) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float s2 = 0.0f, s3 = 0.0f, s4 = 0.0f;
      for (int r = 0; r < kTileY; ++r) {
        s2 += part[0][r][tx * V + k];
        s3 += part[1][r][tx * V + k];
        s4 += part[2][r][tx * V + k];
      }
      const float var = s2 / nf;
      const float sd = sqrtf(var);
      const float sd3 = sd * var;
      const float var2 = var * var;
      const size_t col = col0 + k;
      out[col] = m[k];
      out[L + col] = var;
      out[2 * L + col] = sd == 0.0f ? 0.0f : (s3 / nf) / (sd3 == 0.0f ? 1.0f : sd3);
      out[3 * L + col] = var == 0.0f ? 0.0f : (s4 / nf) / (var2 == 0.0f ? 1.0f : var2);
    }
  }
}

// grid.x tiles the columns as the forward does, grid.y spreads the rows.
template <typename T, int V>
__global__ void __launch_bounds__(kTileX * kTileY)
perdim_backward_kernel(const T* __restrict__ z, const float* __restrict__ moments,
                       const float* __restrict__ gout, T* __restrict__ grad, size_t B, size_t L) {
  const size_t col0 = (static_cast<size_t>(blockIdx.x) * kTileX + threadIdx.x) * V;
  if (col0 >= L) return;
  const float nf = static_cast<float>(B);
  BwdCoef c[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const size_t col = col0 + k;
    const float var = moments[L + col];
    const float sd = sqrtf(var);
    const float sd3 = sd * var;
    c[k].mean = moments[col];
    c[k].m2c = var;
    c[k].m3c = moments[2 * L + col] * sd * var;
    c[k].m4c = moments[3 * L + col] * var * var;
    c[k].inv_var = var == 0.0f ? 0.0f : 1.0f / var;
    const float inv_sd3 = sd3 == 0.0f ? 0.0f : 1.0f / sd3;
    c[k].c_mean = gout[col] / nf;
    c[k].c_var = gout[L + col] * (2.0f / nf);
    c[k].c_skew = gout[2 * L + col] * (3.0f / nf) * inv_sd3;
    c[k].c_kurt = gout[3 * L + col] * (4.0f / nf) * (c[k].inv_var * c[k].inv_var);
  }
  float x[V];
  const size_t stride = static_cast<size_t>(gridDim.y) * kTileY;
  for (size_t b = static_cast<size_t>(blockIdx.y) * kTileY + threadIdx.y; b < B; b += stride) {
    Cols<T, V>::load(z + b * L + col0, x);
#pragma unroll
    for (int k = 0; k < V; ++k) x[k] = c[k].grad(x[k]);
    Cols<T, V>::store(grad + b * L + col0, x);
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T>
int forward_launch(const void* z_, size_t n, int blocks, float* partial, float* out,
                   cudaStream_t stream) {
  const T* z = static_cast<const T*>(z_);
  const size_t n_vec = aligned16(z_) ? n / Vec<T>::kWidth : 0;
  sum_kernel<T><<<blocks, kThreads, 0, stream>>>(z, n, n_vec, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  centred_kernel<T><<<blocks, kThreads, 0, stream>>>(z, n, n_vec, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  finalize_kernel<<<1, kThreads, 0, stream>>>(partial, blocks, n, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int backward_launch(const void* z_, size_t n, const float* moments, const float* gout,
                    void* grad_, cudaStream_t stream) {
  const T* z = static_cast<const T*>(z_);
  T* grad = static_cast<T*>(grad_);
  const size_t n_vec = (aligned16(z_) && aligned16(grad_)) ? n / Vec<T>::kWidth : 0;
  size_t blocks = (n_vec + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBwdBlocks) blocks = kMaxBwdBlocks;
  backward_kernel<T><<<static_cast<int>(blocks), kThreads, 0, stream>>>(z, moments, gout, grad,
                                                                       n, n_vec);
  return static_cast<int>(cudaGetLastError());
}

bool aligned4(const void* p) { return reinterpret_cast<uintptr_t>(p) % 4 == 0; }

unsigned col_blocks(size_t L, int v) {
  return static_cast<unsigned>((L + kTileX * v - 1) / (kTileX * v));
}

template <typename T, int V>
int perdim_forward_launch(const void* z, size_t B, size_t L, float* out, cudaStream_t stream) {
  perdim_forward_kernel<T, V><<<col_blocks(L, V), dim3(kTileX, kTileY), 0, stream>>>(
      static_cast<const T*>(z), B, L, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V>
int perdim_backward_launch(const void* z, size_t B, size_t L, const float* moments,
                           const float* gout, void* grad, cudaStream_t stream) {
  // about four rows a thread, so that small batches still fill the card
  size_t row_blocks = (B + 4 * kTileY - 1) / (4 * kTileY);
  if (row_blocks > kMaxRowBlocks) row_blocks = kMaxRowBlocks;
  const dim3 grid(col_blocks(L, V), static_cast<unsigned>(row_blocks));
  perdim_backward_kernel<T, V><<<grid, dim3(kTileX, kTileY), 0, stream>>>(
      static_cast<const T*>(z), moments, gout, static_cast<T*>(grad), B, L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// z: n values, f32 (is_bf16 == 0) or bf16; partial: 4*blocks floats of
// scratch; out: 4 floats. blocks is chosen by the caller from n alone.
extern "C" int moments_global_forward(const void* z, int is_bf16, long long n, int blocks,
                                      float* partial, float* out, void* stream) {
  if (n <= 0 || blocks < 1 || blocks > kMaxBlocks) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t count = static_cast<size_t>(n);
  return is_bf16 ? forward_launch<__nv_bfloat16>(z, count, blocks, partial, out, s)
                 : forward_launch<float>(z, count, blocks, partial, out, s);
}

// moments, gout: 4 floats each, on the device; grad: n values of z's type.
extern "C" int moments_global_backward(const void* z, int is_bf16, long long n,
                                       const float* moments, const float* gout, void* grad,
                                       void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t count = static_cast<size_t>(n);
  return is_bf16 ? backward_launch<__nv_bfloat16>(z, count, moments, gout, grad, s)
                 : backward_launch<float>(z, count, moments, gout, grad, s);
}

// z: (B, L) row-major, f32 (is_bf16 == 0) or bf16; out: (4, L) floats, rows
// mean, var, skew, kurt of each column.
extern "C" int moments_perdim_forward(const void* z, int is_bf16, long long B, long long L,
                                      float* out, void* stream) {
  if (B <= 0 || L <= 0 || L > (1LL << 35)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t rows = static_cast<size_t>(B), cols = static_cast<size_t>(L);
  if (!is_bf16) return perdim_forward_launch<float, 1>(z, rows, cols, out, s);
  return (cols % 2 == 0 && aligned4(z))
             ? perdim_forward_launch<__nv_bfloat16, 2>(z, rows, cols, out, s)
             : perdim_forward_launch<__nv_bfloat16, 1>(z, rows, cols, out, s);
}

// moments, gout: (4, L) floats each, on the device; grad: (B, L) of z's type.
extern "C" int moments_perdim_backward(const void* z, int is_bf16, long long B, long long L,
                                       const float* moments, const float* gout, void* grad,
                                       void* stream) {
  if (B <= 0 || L <= 0 || L > (1LL << 35)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t rows = static_cast<size_t>(B), cols = static_cast<size_t>(L);
  if (!is_bf16) return perdim_backward_launch<float, 1>(z, rows, cols, moments, gout, grad, s);
  return (cols % 2 == 0 && aligned4(z) && aligned4(grad))
             ? perdim_backward_launch<__nv_bfloat16, 2>(z, rows, cols, moments, gout, grad, s)
             : perdim_backward_launch<__nv_bfloat16, 1>(z, rows, cols, moments, gout, grad, s);
}

extern "C" const char* moments_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
