// The gradient product g (M, N) = x (K, M)^T dz (K, N) of a dense layer in bf16 on
// Hopper's tensor cores: float32 sums, rounded once to bf16.
//
// Replaces the archived TPU probe benchmarks/r11_diag.py:163 dot_only (its pallas_call at
// :169) for bf16 operands; the CUDA-core tile_kernel<T, false, false, R> of
// dense_grad_adam.cu stays for every other case (see ops/dense_grad_adam.py's
// dense_grad_arrangement).
//
// What bounds it. 2 K M N operations against x, dz read once and g written once: at the
// probe's (768, 12800, 4000) that is 78.6 GFLOP and 0.12 GB, 0.0795 ms at the tensor
// cores' 989 TFLOP/s (dense bf16, H100 SXM data sheet) against 0.036 ms for the bytes at
// 3.35 TB/s: the operations bound it, and only wgmma reaches that rate.
//
// Design (the simple one; wgmma_bf16.cuh has the mainloop): a block of two consumer
// warpgroups owns 128 x 128 outputs, one m64n128k16 wgmma per warpgroup and 16 rows of K,
// both operands read straight from their row-major layouts as MN-major tiles (the
// transpose bits of wgmma), so neither x nor dz is copied or transposed in device memory.
// cp.async fills a ring of 3 x 32 KB of 128-byte-swizzled shared memory, 2 stages ahead of
// the product; at 97 KB and 124 registers a thread, two blocks share an SM, so that one
// block's barrier, ring fill and epilogue overlap the other's wgmma (chip_smoke.py's phase q
// at the probe's shape: 4 stages and one block an SM took 0.26 ms, this takes 0.22).
// No split of K: one block sums all of K in one order, so two runs give equal bits and
// nothing crosses blocks. Tiles are numbered with the axis that has fewer tiles running
// fastest, so that neighbouring blocks share the larger operand's tile and the smaller
// operand stays in L2. The epilogue rounds each float32 sum once to bf16 and stores it from
// the wgmma fragment, masking rows past M and columns past N. No TMA, mbarrier pipeline,
// warp specialisation or persistent blocks yet.
//
// What holds it at about 360 TFLOP/s on an H100 (PERF.md): a 128 x 128 tile stages 32 KB
// for every 2.1 MFLOP, 64 operations a byte, so the rate asks 5.7 TB/s of L2-to-SM copies;
// cuBLAS's time would ask 10. Larger tiles or clusters sharing a tile through TMA multicast
// are the next step, not this one.
//
// Why float32 operands stay on CUDA cores: wgmma has no float32 input type. Its nearest,
// tf32, rounds each operand to 10 bits of mantissa, which is another function than the
// float32 product the plain version and the TPU probe compute.
//
// Numbers. Products of bf16 values are exact in float32; the tensor cores add them in
// another order (and with another rounding inside one k16 step) than tile_kernel's
// ascending fmaf chain. The result is held to one bf16 step of the float64 product rounded
// once (with a floor of K * 2^-24 * max|g| where the terms cancel).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_bf16.cuh"

namespace {

using wgmma_bf16::kAccumulators;
using wgmma_bf16::kThreads;
using wgmma_bf16::kTileK;
using wgmma_bf16::kTileM;
using wgmma_bf16::kTileN;

constexpr int kStages = 3;  // 97 KB a block: two blocks an SM
constexpr int kSmemBytes = wgmma_bf16::smem_bytes<kStages>();

__global__ void __launch_bounds__(kThreads, 2)
dense_grad_wgmma_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ dz,
                        __nv_bfloat16* __restrict__ out, long long K, long long M, long long N,
                        long long tiles_m, long long tiles_n, int m_fastest) {
  extern __shared__ __align__(1024) uint8_t smem[];
  const long long tile = blockIdx.x;
  const long long tm = m_fastest ? tile % tiles_m : tile / tiles_n;
  const long long tn = m_fastest ? tile / tiles_m : tile % tiles_n;
  const long long m0 = tm * kTileM, n0 = tn * kTileN;

  float acc[kAccumulators];
#pragma unroll
  for (int i = 0; i < kAccumulators; ++i) acc[i] = 0.0f;
  wgmma_bf16::mainloop<kStages>(x, dz, K, M, N, m0, n0, smem, acc);

  // the D fragment: accumulators 4j..4j+3 are columns 8j + 2 (lane % 4) + {0, 1} of rows
  // r and r + 8
  const int tid = threadIdx.x, lane = tid & 31;
  const long long r = m0 + 64 * (tid >> 7) + 16 * ((tid >> 5) & 3) + (lane >> 2);
#pragma unroll
  for (int j = 0; j < kAccumulators / 4; ++j) {
    const long long col = n0 + 8 * j + 2 * (lane & 3);
    if (col >= N) continue;  // N % 8 == 0, so col + 1 < N too
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = r + 8 * h;
      if (row < M)
        *reinterpret_cast<__nv_bfloat162*>(out + row * N + col) =
            __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// x (K, M), dz (K, N), out (M, N): row-major bf16, M and N multiples of 8, every pointer
// 16-byte aligned, the stages of K (64 rows each) and the tiles counted in an int; anything
// else is refused (cudaErrorInvalidValue), never rerouted. ops/dense_grad_adam.py's
// dense_grad_arrangement states the same rule.
extern "C" int dgw_launch(const void* x, const void* dz, void* out, long long K, long long M,
                          long long N, void* stream) {
  if (K <= 0 || M <= 0 || N <= 0 || M % 8 != 0 || N % 8 != 0 || !aligned16(x) ||
      !aligned16(dz) || !aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long ktiles = (K + kTileK - 1) / kTileK;
  const long long tiles_m = (M + kTileM - 1) / kTileM, tiles_n = (N + kTileN - 1) / kTileN;
  if (ktiles > 2147483647LL || tiles_m * tiles_n > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t rc = cudaFuncSetAttribute(dense_grad_wgmma_kernel,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  dense_grad_wgmma_kernel<<<static_cast<unsigned>(tiles_m * tiles_n), kThreads, kSmemBytes,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(dz),
      static_cast<__nv_bfloat16*>(out), K, M, N, tiles_m, tiles_n, tiles_m < tiles_n ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* dgw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
