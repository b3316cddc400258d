// One Adam step on a dense kernel with the gradient product fused in, and the
// pieces that step is made of: six kernels from three device functions.
//
// Replaces the archived TPU probes
//   benchmarks/r11_kernel.py::_kernel (fused_dense_grad_adam)   tile_kernel<T, false, true>
//   benchmarks/r11_diag.py   fused_xt  (x given as (M, K))       tile_kernel<T, true,  true>
//   benchmarks/r11_diag.py   dot_only  (the product alone)       tile_kernel<T, false, false>
//   benchmarks/r11_diag.py   copy_only (w, mu, nu streamed)      copy_kernel
//   benchmarks/r11_diag.py   epi_bf16  (the step, bf16 maths)    epilogue_kernel<bf16, true>
//   benchmarks/r11_diag.py   epi_only  (the step, f32 maths)     epilogue_kernel<T, false>
// The three tile kernels here take what the tensor cores do not: float32, ragged M or N (or
// K with x as (M, K)), views off 16 bytes. bf16 operands on the rule go to the wgmma kernels:
// the product alone to dense_grad_wgmma.cu, the fused step to dense_grad_adam_wgmma.cu
// (ops/dense_grad_adam.py's dense_grad_arrangement and fused_arrangement say which).
//
// x (K, M) holds the inputs of a dense layer for K rows of a batch (or (M, K)
// in the transposed variant), dz (K, N) the gradient of its outputs, w, mu, nu
// (M, N) the kernel and its two Adam moments, all of one dtype T (bf16 in the
// probes, float32 taken too). The step (adam_f32 of adam_step.cuh) is
// adam_epilogue of benchmarks/r11_kernel.py, operation by operation.
//
// The TPU kernels' grids (dz-resident, x-resident, 2-D), block budgets and
// input_output_aliases answer VMEM and Mosaic's tiling; none of that is carried
// over. Here any M, N, K >= 1 is taken and ragged edges are masked.
//
// What bounds them on Hopper. The streaming kernels (copy, both epilogues) move
// 6 or 7 tensors of (M, N) once: device memory bytes. One thread owns 16 bytes
// of each tensor, neighbouring threads neighbouring addresses, and a grid as
// large as the tensors keeps enough loads in flight (2.9 TB/s of the card's
// 3.35 on an H100 at 700 W). The fused kernel moves the same 6 tensors plus x
// and dz, which are small beside them, and does 2 K M N operations: at K = 768
// that is 128 operations for each byte of the state, below the 295 at which
// the tensor cores would leave the bytes as the bound, but far above what CUDA
// cores sustain, so on CUDA cores the product, not the bytes, sets the
// kernel's time (32 TFLOP/s on that card, 13 times the bound of the bytes).
// The design is the simple one: a block of 256 threads owns one tile of
// 64 x 64 outputs, walks all of K in steps of 16 (no split of K,
// so nothing crosses blocks), stages x and dz as float32 in shared memory (one
// global fetch ahead, in registers), and each thread keeps a 4 x 4
// patch of float32 sums fed by fmaf. With the epilogue on, the thread then
// reads its patch of w, mu, nu, takes the step and writes the same addresses:
// every element of the state is read and written by exactly one thread of one
// block, which is what makes in place safe. Tiles are numbered so that the
// axis with fewer tiles runs fastest: neighbouring blocks share the tile of
// the larger operand and the smaller operand stays in L2. (A 128 x 128 tile of
// 8 x 8 patches took about 145 registers, one block an SM, and was the slower.)
//
// Numbers. The file is built with --fmad=false and the step is written with
// __fmul_rn and friends, so each operation rounds once, as PyTorch's
// elementwise operations do: the streaming kernels equal their plain versions
// bit for bit. The product uses explicit fmaf: for bf16 operands every product
// is exact in float32, so the sum is a plain float32 sum over k in ascending
// order. The bf16 arithmetic runs each operation in float32 on bf16 values and
// rounds the result to bf16, which is what PyTorch's bf16 operations do.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "adam_step.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kKT = 16;  // rows of K staged per step
constexpr int R = 4;  // a thread's R x R outputs: 64 x 64 outputs a block

using adam_step::AdamScalars;
using adam_step::from_f32;
using adam_step::load_vec;
using adam_step::StepScalars;
using adam_step::store_vec;
using adam_step::to_f32;

// ---- streaming epilogue (epi_only, epi_bf16) -------------------------------------------------

// One thread takes 16 bytes of each tensor when `vec` (all four pointers 16-byte aligned);
// the elements past the last whole group, or all of them when not `vec`, go one a thread.
template <typename T, bool BF16>
__global__ void __launch_bounds__(kThreads)
epilogue_kernel(const T* __restrict__ g, T* __restrict__ w, T* __restrict__ mu,
                T* __restrict__ nu, long long total, int vec, AdamScalars scalars) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  const StepScalars<BF16> step(scalars);
  const long long tid = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long groups = vec ? total / V : 0;
  if (tid < groups) {
    const long long off = tid * V;
    float gv[V], wv[V], mv[V], nv[V];
    load_vec<T, V>(g + off, gv);
    load_vec<T, V>(w + off, wv);
    load_vec<T, V>(mu + off, mv);
    load_vec<T, V>(nu + off, nv);
#pragma unroll
    for (int i = 0; i < V; ++i) step.template apply<T>(gv[i], wv[i], mv[i], nv[i]);
    store_vec<T, V>(w + off, wv);
    store_vec<T, V>(mu + off, mv);
    store_vec<T, V>(nu + off, nv);
  }
  const long long i = groups * V + tid;
  if (i < total) {
    float wv = to_f32(w[i]), mv = to_f32(mu[i]), nv = to_f32(nu[i]);
    step.template apply<T>(to_f32(g[i]), wv, mv, nv);
    w[i] = from_f32<T>(wv);
    mu[i] = from_f32<T>(mv);
    nu[i] = from_f32<T>(nv);
  }
}

// ---- streaming copy (copy_only) --------------------------------------------------------------

// Three tensors of nbytes each; a destination may be its own source, so no __restrict__.
// 16 bytes a thread and tensor when `vec`, the rest (or all) in 2-byte units.
__global__ void __launch_bounds__(kThreads)
copy_kernel(const void* s0, const void* s1, const void* s2, void* d0, void* d1, void* d2,
            long long nbytes, int vec) {
  const long long tid = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long groups = vec ? nbytes / 16 : 0;
  if (tid < groups) {
    const uint4 a = static_cast<const uint4*>(s0)[tid];
    const uint4 b = static_cast<const uint4*>(s1)[tid];
    const uint4 c = static_cast<const uint4*>(s2)[tid];
    static_cast<uint4*>(d0)[tid] = a;
    static_cast<uint4*>(d1)[tid] = b;
    static_cast<uint4*>(d2)[tid] = c;
  }
  const long long i = groups * 8 + tid;  // in 2-byte units
  if (i < nbytes / 2) {
    const uint16_t a = static_cast<const uint16_t*>(s0)[i];
    const uint16_t b = static_cast<const uint16_t*>(s1)[i];
    const uint16_t c = static_cast<const uint16_t*>(s2)[i];
    static_cast<uint16_t*>(d0)[i] = a;
    static_cast<uint16_t*>(d1)[i] = b;
    static_cast<uint16_t*>(d2)[i] = c;
  }
}

// ---- tile product, with or without the step in its epilogue ----------------------------------

// R contiguous elements of row `row` of a row-major (rows, cols) matrix from column `col`
// on, as float32; zeros outside. `vec`: cols % R == 0 and the base is aligned to
// min(16, R * sizeof(T)), so a group is whole and aligned.
template <typename T, int R>
__device__ __forceinline__ void fetch(const T* __restrict__ src, long long row, long long rows,
                                      long long col, long long cols, int vec, float (&out)[R]) {
#pragma unroll
  for (int j = 0; j < R; ++j) out[j] = 0.0f;
  if (row >= rows || col >= cols) return;
  const T* p = src + row * cols + col;
  if (vec) {
    load_vec<T, R>(p, out);
    return;
  }
#pragma unroll
  for (int j = 0; j < R; ++j)
    if (col + j < cols) out[j] = to_f32(p[j]);
}

// A block of 256 threads (tx = thread % 16, ty = thread / 16) owns the outputs
// [m0, m0 + 16 R) x [n0, n0 + 16 R). A thread owns R x R of them, in R / 4
// groups of 4 rows (ty * 4 + i, 64 apart) by R / 4 groups of 4 columns (tx * 4 + j, 64
// apart), so that a warp's float4 reads of a staged row fall on neighbouring banks and
// its stores of a row of w on neighbouring addresses.
// XT: x is (M, K) and is transposed on its way into shared memory.
// EPI: w, mu, nu are read, stepped and written in place; else `w` receives g in T.
template <typename T, bool XT, bool EPI>
__global__ void __launch_bounds__(kThreads)
tile_kernel(const T* __restrict__ x, const T* __restrict__ dz, T* __restrict__ w,
            T* __restrict__ mu, T* __restrict__ nu, long long K, long long M, long long N,
            long long tiles_m, long long tiles_n, int m_fastest, int vec_x, int vec_dz,
            int vec_out, AdamScalars scalars) {
  constexpr int TILE = 16 * R;
  constexpr int G = R / 4;
  constexpr int SA = TILE + 4;  // the transposed stores of XT spread over more banks
  __shared__ __align__(16) float As[kKT][SA];
  __shared__ __align__(16) float Bs[kKT][TILE];

  const long long tile = blockIdx.x;
  const long long tm = m_fastest ? tile % tiles_m : tile / tiles_n;
  const long long tn = m_fastest ? tile / tiles_m : tile % tiles_n;
  const long long m0 = tm * TILE, n0 = tn * TILE;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  // XT: 16 / R threads fetch one row of x's tile (R of its 16 k each)
  const int xt_row = threadIdx.x / (kKT / R), xt_k = (threadIdx.x % (kKT / R)) * R;

  float acc[R][R];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) acc[i][j] = 0.0f;

  float xa[R], db[R];
  auto fetch_tiles = [&](long long k0) {
    if (XT) fetch<T, R>(x, m0 + xt_row, M, k0 + xt_k, K, vec_x, xa);
    else fetch<T, R>(x, k0 + ty, K, m0 + tx * R, M, vec_x, xa);
    fetch<T, R>(dz, k0 + ty, K, n0 + tx * R, N, vec_dz, db);
  };

  fetch_tiles(0);
  for (long long k0 = 0; k0 < K; k0 += kKT) {
    if (XT) {
#pragma unroll
      for (int j = 0; j < R; ++j) As[xt_k + j][xt_row] = xa[j];
    } else {
#pragma unroll
      for (int c = 0; c < G; ++c)
        *reinterpret_cast<float4*>(&As[ty][tx * R + 4 * c]) =
            make_float4(xa[4 * c], xa[4 * c + 1], xa[4 * c + 2], xa[4 * c + 3]);
    }
#pragma unroll
    for (int c = 0; c < G; ++c)
      *reinterpret_cast<float4*>(&Bs[ty][tx * R + 4 * c]) =
          make_float4(db[4 * c], db[4 * c + 1], db[4 * c + 2], db[4 * c + 3]);
    __syncthreads();
    if (k0 + kKT < K) fetch_tiles(k0 + kKT);  // in flight while this step multiplies
#pragma unroll
    for (int kk = 0; kk < kKT; ++kk) {
      float a[R], b[R];
#pragma unroll
      for (int c = 0; c < G; ++c) {
        const float4 va = *reinterpret_cast<const float4*>(&As[kk][c * 64 + ty * 4]);
        const float4 vb = *reinterpret_cast<const float4*>(&Bs[kk][c * 64 + tx * 4]);
        a[4 * c] = va.x, a[4 * c + 1] = va.y, a[4 * c + 2] = va.z, a[4 * c + 3] = va.w;
        b[4 * c] = vb.x, b[4 * c + 1] = vb.y, b[4 * c + 2] = vb.z, b[4 * c + 3] = vb.w;
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();  // every thread is done with this step's tiles
  }

  const StepScalars<false> step(scalars);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const long long m = m0 + (i / 4) * 64 + ty * 4 + (i % 4);
    if (m >= M) continue;
#pragma unroll
    for (int c = 0; c < G; ++c) {
      const long long n = n0 + c * 64 + tx * 4;
      if (n >= N) continue;
      const long long off = m * N + n;
      float gv[4] = {acc[i][4 * c], acc[i][4 * c + 1], acc[i][4 * c + 2], acc[i][4 * c + 3]};
      if (!EPI) {
        if (vec_out) {
          store_vec<T, 4>(w + off, gv);
        } else {
          for (int j = 0; j < 4 && n + j < N; ++j) w[off + j] = from_f32<T>(gv[j]);
        }
        continue;
      }
      float wv[4], mv[4], nv[4];
      if (vec_out) {
        load_vec<T, 4>(w + off, wv);
        load_vec<T, 4>(mu + off, mv);
        load_vec<T, 4>(nu + off, nv);
      } else {
        for (int j = 0; j < 4; ++j) {
          const bool in = n + j < N;
          wv[j] = in ? to_f32(w[off + j]) : 0.0f;
          mv[j] = in ? to_f32(mu[off + j]) : 0.0f;
          nv[j] = in ? to_f32(nu[off + j]) : 0.0f;
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) step.template apply<T>(gv[j], wv[j], mv[j], nv[j]);
      if (vec_out) {
        store_vec<T, 4>(w + off, wv);
        store_vec<T, 4>(mu + off, mv);
        store_vec<T, 4>(nu + off, nv);
      } else {
        for (int j = 0; j < 4 && n + j < N; ++j) {
          w[off + j] = from_f32<T>(wv[j]);
          mu[off + j] = from_f32<T>(mv[j]);
          nu[off + j] = from_f32<T>(nv[j]);
        }
      }
    }
  }
}

bool aligned(const void* p, size_t bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

template <typename T, bool XT, bool EPI>
cudaError_t launch_tile(const void* x, const void* dz, void* w, void* mu, void* nu, long long K,
                        long long M, long long N, const AdamScalars& scalars,
                        cudaStream_t stream) {
  constexpr int TILE = 16 * R;
  const long long tiles_m = (M + TILE - 1) / TILE, tiles_n = (N + TILE - 1) / TILE;
  if (tiles_m * tiles_n > 2147483647LL) return cudaErrorInvalidValue;
  const size_t in_align = R * sizeof(T) < 16 ? R * sizeof(T) : 16;
  const size_t out_align = 4 * sizeof(T) < 16 ? 4 * sizeof(T) : 16;
  const int vec_x = (XT ? K : M) % R == 0 && aligned(x, in_align);
  const int vec_dz = N % R == 0 && aligned(dz, in_align);
  const int vec_out = N % 4 == 0 && aligned(w, out_align) &&
                      (!EPI || (aligned(mu, out_align) && aligned(nu, out_align)));
  tile_kernel<T, XT, EPI><<<static_cast<unsigned>(tiles_m * tiles_n), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dz), static_cast<T*>(w),
      static_cast<T*>(mu), static_cast<T*>(nu), K, M, N, tiles_m, tiles_n,
      tiles_m < tiles_n ? 1 : 0, vec_x, vec_dz, vec_out, scalars);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_tile_for(const void* x, const void* dz, void* w, void* mu, void* nu,
                            long long K, long long M, long long N, bool xt, bool epi,
                            const AdamScalars& s, cudaStream_t stream) {
  if (!epi) {
    if (xt) return cudaErrorInvalidValue;  // the product alone takes x as (K, M) only
    return launch_tile<T, false, false>(x, dz, w, mu, nu, K, M, N, s, stream);
  }
  if (xt) return launch_tile<T, true, true>(x, dz, w, mu, nu, K, M, N, s, stream);
  return launch_tile<T, false, true>(x, dz, w, mu, nu, K, M, N, s, stream);
}

template <typename T, bool BF16>
cudaError_t launch_epilogue(const void* g, void* w, void* mu, void* nu, long long total,
                            const AdamScalars& s, cudaStream_t stream) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  const int vec = aligned(g, 16) && aligned(w, 16) && aligned(mu, 16) && aligned(nu, 16);
  const long long threads = vec ? total / V + total % V : total;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  epilogue_kernel<T, BF16><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(g), static_cast<T*>(w), static_cast<T*>(mu), static_cast<T*>(nu),
      total, vec, s);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 bf16, 1 float32. x (K, M), or (M, K) when x_transposed; dz (K, N); all row-major.
// epilogue != 0: w, mu, nu (M, N) take one Adam step in place. epilogue == 0: the product is
// written to w in the operands' dtype; mu and nu are not touched (pass null).
extern "C" int dga_tile_launch(const void* x, const void* dz, void* w, void* mu, void* nu,
                               long long K, long long M, long long N, int dtype,
                               int x_transposed, int epilogue, float lr, float b1, float b2,
                               float eps, float bc1, float bc2, void* stream) {
  if (K <= 0 || M <= 0 || N <= 0 || x == nullptr || dz == nullptr || w == nullptr ||
      (epilogue && (mu == nullptr || nu == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const AdamScalars s{lr, b1, b2, eps, bc1, bc2};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t rc;
  if (dtype == 0)
    rc = launch_tile_for<__nv_bfloat16>(x, dz, w, mu, nu, K, M, N, x_transposed != 0,
                                        epilogue != 0, s, st);
  else if (dtype == 1)
    rc = launch_tile_for<float>(x, dz, w, mu, nu, K, M, N, x_transposed != 0, epilogue != 0, s,
                                st);
  else
    rc = cudaErrorInvalidValue;
  return static_cast<int>(rc);
}

// One Adam step on `total` elements of w, mu, nu from g, in place. bf16_arithmetic != 0
// takes bf16 tensors only.
extern "C" int dga_epilogue_launch(const void* g, void* w, void* mu, void* nu, long long total,
                                   int dtype, int bf16_arithmetic, float lr, float b1, float b2,
                                   float eps, float bc1, float bc2, void* stream) {
  if (total <= 0 || g == nullptr || w == nullptr || mu == nullptr || nu == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const AdamScalars s{lr, b1, b2, eps, bc1, bc2};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t rc;
  if (dtype == 0 && bf16_arithmetic)
    rc = launch_epilogue<__nv_bfloat16, true>(g, w, mu, nu, total, s, st);
  else if (dtype == 0)
    rc = launch_epilogue<__nv_bfloat16, false>(g, w, mu, nu, total, s, st);
  else if (dtype == 1 && !bf16_arithmetic)
    rc = launch_epilogue<float, false>(g, w, mu, nu, total, s, st);
  else
    rc = cudaErrorInvalidValue;
  return static_cast<int>(rc);
}

// Three tensors of nbytes (even) each, copied to three destinations; d_i may equal s_i.
extern "C" int dga_copy_launch(const void* s0, const void* s1, const void* s2, void* d0,
                               void* d1, void* d2, long long nbytes, void* stream) {
  if (nbytes <= 0 || nbytes % 2 != 0 || !s0 || !s1 || !s2 || !d0 || !d1 || !d2)
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec = aligned(s0, 16) && aligned(s1, 16) && aligned(s2, 16) && aligned(d0, 16) &&
                  aligned(d1, 16) && aligned(d2, 16);
  const long long threads = vec ? nbytes / 16 + (nbytes % 16) / 2 : nbytes / 2;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  copy_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      s0, s1, s2, d0, d1, d2, nbytes, vec);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* dga_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
