// One Adam step on a dense kernel with the gradient product fused in, in bf16 on Hopper's
// tensor cores: g = bf16(x^T dz) is summed in float32 by wgmma, rounded once, and stepped
// into w, mu, nu in place, without ever going through device memory.
//
// Replaces the archived TPU probes benchmarks/r11_kernel.py:84 _kernel (fused_dense_grad_adam,
// its pallas_call at :209; x (K, M)) and benchmarks/r11_diag.py:132 fused_xt (its pallas_call
// at :145; x given as (M, K)) for bf16 operands; the CUDA-core tile_kernel<T, XT, true> of
// dense_grad_adam.cu stays for every other case (see ops/dense_grad_adam.py's
// fused_arrangement).
//
// What bounds it. The state w, mu, nu (M, N) is read and written once, 6 M N bf16 values,
// beside x and dz, which are small; the product does 2 K M N operations. At the probe's
// (768, 12800, 4000) that is 640 MB, 0.191 ms at 3.35 TB/s (H100 SXM data sheet), against
// 78.6 GFLOP, 0.0795 ms at the tensor cores' 989 TFLOP/s: the bytes bound it, by 2.4 times.
// On CUDA cores (about 33 TFLOP/s) the product took 13 times the bound, so the product has to
// run on the tensor cores, and the state has to stream at kernel 9's rate beside it.
//
// Design: kernel 6's mainloop (wgmma_bf16.cuh: two consumer warpgroups own 128 x 128 outputs,
// one m64n128k16 wgmma per warpgroup and 16 rows of K, a cp.async ring of 3 x 32 KB of
// 128-byte-swizzled shared memory; 97 KB a block and __launch_bounds__(256, 2), so two blocks
// share an SM and one block's memory-bound epilogue overlaps the other's tensor-bound
// mainloop). Kernel 4 reads x (K, M) MN-major, as kernel 6 does; kernel 5 reads x (M, K)
// K-major (the header's A_K_MAJOR: 128-byte rows of K in the K-major swizzle, transpose bit 0).
// The epilogue is staged through the freed ring. After the last stage's wgmma_wait<0>: wait
// for the trailing copy groups, barrier; each thread rounds its 64 float32 sums to bf16 (the
// first operation of adam_f32<bf16>, so staging g as bf16 loses nothing) and writes them as
// 4-byte pairs into a 128 x 128 bf16 tile whose 256-byte rows are padded to 272 bytes, so
// that the fragment's writes from 8 rows fall on 32 distinct banks; barrier. Then the 256
// threads walk the tile by rows, 16 bytes (8 values) a thread and 16 rows a pass: each reads
// its chunk of g from shared memory and the same chunk of w, mu and nu from device memory,
// applies StepScalars<false>::apply<bf16> (kernel 9's code, adam_step.cuh), and writes w, mu,
// nu back, as kernel 9 does. Staged, the state moves in kernel 9's 16-byte accesses, not the
// D fragment's 4-byte pairs, and the 64 accumulator registers are free before its loads.
// Rows past M and 16-byte chunks past N (N % 8 == 0: a chunk is wholly in or out) are
// masked. Each element of w, mu, nu is read and written by exactly one thread of one block,
// which is what makes in place safe. No split of K; tiles are numbered with the axis that has
// fewer tiles running fastest, as in kernel 6. No TMA, mbarrier pipeline, warp
// specialisation or persistent blocks.
//
// Numbers. The mainloop is kernel 6's, instruction for instruction, on the same tile map, so
// g's float32 sums are kernel 6's; their rounding to bf16 and the step are the same code as
// kernels 6 and 9 (built with --fmad=false). So the result equals, bit for bit, kernel 9's
// step applied to kernel 6's wgmma product of the same operands. Against the plain version
// (a float32 product summed in another order) g's rounding flips on a few elements, by one
// bf16 step.
//
// Float32 stays on CUDA cores: wgmma has no float32 input, and tf32 is another function than
// the float32 product the plain version and the TPU probe compute.
//
// Registers and spills (ptxas -v, sm_90a, CUDA 12.9): 124 registers with x (K, M), 121 with x
// (M, K), no spills, no stack, one barrier (kernel 6: 124), so two blocks share an SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "adam_step.cuh"
#include "wgmma_bf16.cuh"

namespace {

using adam_step::AdamScalars;
using wgmma_bf16::kAccumulators;
using wgmma_bf16::kThreads;
using wgmma_bf16::kTileK;
using wgmma_bf16::kTileM;
using wgmma_bf16::kTileN;

constexpr int kStages = 3;  // 97 KB a block: two blocks an SM
constexpr int kSmemBytes = wgmma_bf16::smem_bytes<kStages>();
// the staged g tile: 128 rows of 128 bf16 values, each row padded by 16 bytes
constexpr int kRowBytes = kTileN * 2 + 16;
constexpr int kChunks = kTileN / 8;              // 16-byte chunks a row
constexpr int kRowsPerPass = kThreads / kChunks;  // 16
static_assert(kTileM * kRowBytes <= kSmemBytes, "the staged tile fits in the freed ring");

using bf16 = __nv_bfloat16;

template <bool XT>
__global__ void __launch_bounds__(kThreads, 2)
dense_grad_adam_wgmma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dz,
                             bf16* __restrict__ w, bf16* __restrict__ mu, bf16* __restrict__ nu,
                             long long K, long long M, long long N, long long tiles_m,
                             long long tiles_n, int m_fastest, AdamScalars scalars) {
  extern __shared__ __align__(1024) uint8_t smem[];
  const long long tile = blockIdx.x;
  const long long tm = m_fastest ? tile % tiles_m : tile / tiles_n;
  const long long tn = m_fastest ? tile / tiles_m : tile % tiles_n;
  const long long m0 = tm * kTileM, n0 = tn * kTileN;

  float acc[kAccumulators];
#pragma unroll
  for (int i = 0; i < kAccumulators; ++i) acc[i] = 0.0f;
  wgmma_bf16::mainloop<kStages, XT>(x, dz, K, M, N, m0, n0, smem, acc);

  // the ring is free once the trailing (empty) copy groups are done and every warpgroup has
  // passed its last wgmma_wait<0>
  wgmma_bf16::cp_async_wait<0>();
  __syncthreads();

  // g rounded once to bf16 from the D fragment: accumulators 4j..4j+3 are columns
  // 8j + 2 (lane % 4) + {0, 1} of rows r and r + 8
  const int tid = threadIdx.x, lane = tid & 31;
  const int r = 64 * (tid >> 7) + 16 * ((tid >> 5) & 3) + (lane >> 2);
#pragma unroll
  for (int j = 0; j < kAccumulators / 4; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<__nv_bfloat162*>(smem + (r + 8 * h) * kRowBytes +
                                         (8 * j + 2 * (lane & 3)) * 2) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  __syncthreads();

  // kernel 9's step on 16-byte chunks: thread t takes chunk t % 16 of rows t / 16 + 16 p
  const adam_step::StepScalars<false> step(scalars);
  const int c = tid % kChunks;
  const long long n = n0 + 8 * c;
  if (n >= N) return;
#pragma unroll 2
  for (int p = 0; p < kTileM / kRowsPerPass; ++p) {
    const int row = kRowsPerPass * p + tid / kChunks;
    const long long m = m0 + row;
    if (m >= M) break;
    const long long off = m * N + n;
    float gv[8], wv[8], mv[8], nv[8];
    adam_step::load_vec<bf16, 8>(reinterpret_cast<const bf16*>(smem + row * kRowBytes + 16 * c),
                                 gv);
    adam_step::load_vec<bf16, 8>(w + off, wv);
    adam_step::load_vec<bf16, 8>(mu + off, mv);
    adam_step::load_vec<bf16, 8>(nu + off, nv);
#pragma unroll
    for (int i = 0; i < 8; ++i) step.template apply<bf16>(gv[i], wv[i], mv[i], nv[i]);
    adam_step::store_vec<bf16, 8>(w + off, wv);
    adam_step::store_vec<bf16, 8>(mu + off, mv);
    adam_step::store_vec<bf16, 8>(nu + off, nv);
  }
}

bool aligned16(const void* p) {
  return p != nullptr && reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <bool XT>
cudaError_t launch(const void* x, const void* dz, void* w, void* mu, void* nu, long long K,
                   long long M, long long N, long long tiles_m, long long tiles_n,
                   const AdamScalars& s, cudaStream_t stream) {
  cudaError_t rc = cudaFuncSetAttribute(dense_grad_adam_wgmma_kernel<XT>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (rc != cudaSuccess) return rc;
  dense_grad_adam_wgmma_kernel<XT>
      <<<static_cast<unsigned>(tiles_m * tiles_n), kThreads, kSmemBytes, stream>>>(
          static_cast<const bf16*>(x), static_cast<const bf16*>(dz), static_cast<bf16*>(w),
          static_cast<bf16*>(mu), static_cast<bf16*>(nu), K, M, N, tiles_m, tiles_n,
          tiles_m < tiles_n ? 1 : 0, s);
  return cudaGetLastError();
}

}  // namespace

// dtype 0 (bf16) only. x (K, M), or (M, K) when x_transposed; dz (K, N); w, mu, nu (M, N) take
// one Adam step in place; all row-major. M and N multiples of 8 (and K when x_transposed),
// every pointer 16-byte aligned, the stages of K (64 rows each) and the 128 x 128 tiles
// counted in an int; anything else is refused (cudaErrorInvalidValue), never rerouted.
// ops/dense_grad_adam.py's fused_arrangement states the same rule.
extern "C" int dgaw_launch(const void* x, const void* dz, void* w, void* mu, void* nu,
                           long long K, long long M, long long N, int dtype, int x_transposed,
                           float lr, float b1, float b2, float eps, float bc1, float bc2,
                           void* stream) {
  if (dtype != 0 || K <= 0 || M <= 0 || N <= 0 || M % 8 != 0 || N % 8 != 0 ||
      (x_transposed && K % 8 != 0) || !aligned16(x) || !aligned16(dz) || !aligned16(w) ||
      !aligned16(mu) || !aligned16(nu))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long ktiles = (K + kTileK - 1) / kTileK;
  const long long tiles_m = (M + kTileM - 1) / kTileM, tiles_n = (N + kTileN - 1) / kTileN;
  if (ktiles > 2147483647LL || tiles_m * tiles_n > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const AdamScalars s{lr, b1, b2, eps, bc1, bc2};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(x_transposed ? launch<true>(x, dz, w, mu, nu, K, M, N, tiles_m,
                                                      tiles_n, s, st)
                                       : launch<false>(x, dz, w, mu, nu, K, M, N, tiles_m,
                                                       tiles_n, s, st));
}

extern "C" const char* dgaw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
