// Weight gradient of a 3x3, stride-2, SAME convolution on even H and W, bf16 operands, on
// Hopper's tensor cores (sm_90a):
//
//   dW[kh, kw, ci, co] = sum_{b, oh, ow} xpad[b, 2 oh + kh, 2 ow + kw, ci] * dy[b, oh, ow, co]
//
// x (B, H, W, CI) and dy (B, H/2, W/2, CO) are NHWC bf16; xpad is x with one row of zeros
// below and one column of zeros to the right; dW (3, 3, CI, CO) is float32, summed in float32.
//
// Replaces the TPU kernel benchmarks/r18_conv_dw.py::_dw_kernel (launched by conv_dw_pallas)
// for bf16 operands whose channel counts are multiples of 8; the CUDA-core kernel of
// conv_dw.cu stays for every other case (see ops/conv_dw.py's conv_dw_arrangement).
//
// What bounds it. As a matrix product it is dW (CO, 9 CI) = dy^T (CO, P) . patches (P, 9 CI)
// over P = B H W / 4 output positions: at the flagship's conv2 (768, 112, 150, 32 -> 64)
// that is 119 GFLOP, 0.120 ms at the tensor cores' 989 TFLOP/s (dense bf16, H100 SXM data
// sheet), against 1.24 GB of x and dy read once, 0.370 ms at 3.35 TB/s: the bytes bound
// it, and only the tensor cores keep the operations below them (the CUDA-core kernel runs
// at 31 TFLOP/s there, 3.8 ms).
//
// Design. The product D (64 x 128) += A (64 x 16) B (16 x 128) of wgmma.mma_async
// m64n128k16 with both operands MN-major and the 128-byte swizzle (the primitives of
// wgmma_bf16.cuh; its mainloop, written for two row-major operands, is not used). K runs
// over positions, 64 a stage:
//   A = dy: 64 positions x 64 output channels, one 8 KB atom column: dy's NHWC rows as
//       they lie in memory, so M = the block's 64 output channels.
//   B = the im2col patches of one kh: for a fixed kh the 3 CI values that a position needs
//       are CONTIGUOUS in an NHWC row of x, starting at pixel 2 ow. Each kh gets its own
//       slot of 128 columns (two atom columns, 16 KB): columns kw 32 + c for the 3 taps
//       of the block's 32 input channels, then 32 columns of padding that are zeroed once
//       and never copied to. No im2col matrix exists in device memory.
// Three warpgroups, warpgroup g owning kh = g, each issue four m64n128k16 a stage with the
// shared A and their own B slot: 64 float32 accumulators a thread, 64 x 96 of them useful.
// A quarter of the tensor-core work is padding: about 0.04 ms at peak against 0.37 of bytes.
// Gather: cp.async.cg 16-byte copies (8 channels of one pixel), each thread a fixed chunk
// of a fixed 2 (x) + 1 or 2 (dy) rows of the stage, its positions (b H/2 + oh, ow) carried
// from stage to stage by additions, so no division runs per chunk. The bottom padding row
// (2 oh + 2 = H), the right padding column (2 ow + 2 = W), channels past CI or CO and
// positions past the block's share are zero-filled by cp.async's src-size 0, in BOTH
// operands: the ring slot still holds an older stage, and 0 * NaN is not 0.
// Ring: 4 stages of 56 KB (225 KB, one block an SM), 3 stages of copies in flight behind
// the product; each stage: wait for its copies, fence them into the async proxy, one
// barrier (which also frees the slot the next copies reuse), issue the copies three stages
// ahead, then the 4 wgmma, waited for before the next stage.
// Split and join: the positions are split evenly over as many blocks as fit on the card at
// once (the occupancy API), shared among the channel tiles (CI in tiles of 32, CO in tiles
// of 64, masked). Each block writes its partial (3, 3, CI, CO) tile from the wgmma
// fragment to its own slice of the caller's scratch, and a second kernel adds the slices
// in index order. No float atomics: two runs give equal bits.
//
// Measured at conv2, batch 768, on an H100 SXM at 700 W (PERF.md): 0.46 ms, 1.25x the bound,
// against 0.65 ms for cuDNN's weight gradient and 3.9 ms for the CUDA-core kernel. Where it
// goes next: the gather stages each pixel of x 2.25 times (rows and columns of neighbouring
// positions overlap), about 2.3 GB from L2 at conv2 for 1.24 GB of operands; a TMA im2col
// copy, or staging whole input rows once and building B from them in shared memory, would
// cut that.
//
// Numbers. Products of bf16 values are exact in float32; the sums are taken in another
// order than the CUDA-core kernel's (and than the plain version's), so the two
// arrangements agree to the order of float32 sums, not bit for bit. The tensor cores' float32
// sums are also coarser than fmaf's: at conv2 the error against float64 sums is 2.8e-5 of
// max|dW| (the CUDA-core kernel's 1.2e-6), within the 1e-4 the checks allow, and it grows
// with the positions one block sums.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_bf16.cuh"

namespace {

using wgmma_bf16::kAccumulators;
using wgmma_bf16::kAtomBytes;

constexpr int kWarpgroups = 3;               // warpgroup g owns kh = g
constexpr int kThreads = 128 * kWarpgroups;  // 384
constexpr int kTileP = 64;                   // positions a stage: the K of the product
constexpr int kTileCo = 64;                  // output channels a block: the M
constexpr int kTileCi = 32;                  // input channels a block: 3 x 32 of the N = 128
constexpr int kRowChunks = 3 * kTileCi / 8;  // 12 chunks of 16 bytes: one kh row of a position
constexpr int kABytes = kAtomBytes;          // 64 positions x 64 channels
constexpr int kSlotBytes = 2 * kAtomBytes;   // 64 positions x 128 columns of one kh
constexpr int kStageBytes = kABytes + 3 * kSlotBytes;  // 56 KB
constexpr int kStages = 4;
constexpr int kSmemBytes = kStages * kStageBytes + 1024;  // + room to align the ring to 1 KB
constexpr int kJoinThreads = 256;
static_assert(kThreads == kTileP * kRowChunks / 2, "a thread copies one chunk of x in two rows");
static_assert(kStageBytes % 1024 == 0, "every stage starts on a 1 KB boundary");

// One position a thread copies for: its index p, its line b H/2 + oh, oh and ow.
struct Position {
  long long p, line;
  int oh, ow;

  __device__ __forceinline__ void start(long long p0, int OH, int OW) {
    line = p0 / OW;
    p = p0, ow = static_cast<int>(p0 - line * OW), oh = static_cast<int>(line % OH);
  }
  __device__ __forceinline__ void advance(int OH, int OW) {  // by one stage
    p += kTileP;
    ow += kTileP;
    while (ow >= OW) {
      ow -= OW;
      ++line;
      if (++oh == OH) oh = 0;
    }
  }
};

__global__ void __launch_bounds__(kThreads, 1)
conv_dw_wgmma_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ dy,
                     float* __restrict__ scratch, int W, int CI, int CO, int OH, int OW, int P) {
  extern __shared__ __align__(1024) uint8_t smem[];
  using namespace wgmma_bf16;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const uint32_t ring = (smem_address(smem) + 1023u) & ~1023u;
  const int ci0 = static_cast<int>(blockIdx.y) * kTileCi;
  const int co0 = static_cast<int>(blockIdx.z) * kTileCo;
  const int p_begin = static_cast<int>(static_cast<long long>(P) * blockIdx.x / gridDim.x);
  const int p_end = static_cast<int>(static_cast<long long>(P) * (blockIdx.x + 1) / gridDim.x);
  const int ktiles = (p_end - p_begin + kTileP - 1) / kTileP;

  // the padding columns 96..127 of every kh slot of every stage: zero, never copied to
  uint8_t* const ring_ptr = smem + (ring - smem_address(smem));
  for (int id = tid; id < kStages * 3 * kTileP * 4; id += kThreads) {
    const int c = kRowChunks + (id & 3), k = (id >> 2) % kTileP, slot = (id >> 2) / kTileP;
    *reinterpret_cast<uint4*>(ring_ptr + (slot / 3) * kStageBytes + kABytes +
                              (slot % 3) * kSlotBytes + swizzled_offset(k, c)) =
        make_uint4(0u, 0u, 0u, 0u);
  }

  // x: chunk c (tap kw = c / 4, channels ci0 + 8 (c % 4) ..) of rows kx and kx + 32, all kh;
  // dy: chunk ca (channels co0 + 8 ca ..) of row ka, and of row ka + 48 for tid < 128
  const int c = tid % kRowChunks, kx = tid / kRowChunks, kw = c / 4;
  const int ci = ci0 + 8 * (c % 4);
  const int ca = tid % 8, ka = tid / 8;
  const bool two_dy_rows = ka + 48 < kTileP;
  const bool ci_ok = ci < CI, co_ok = co0 + 8 * ca < CO;
  Position px[2], pa[2];
  const long long p0 = p_begin;
  px[0].start(p0 + kx, OH, OW);
  px[1].start(p0 + kx + 32, OH, OW);
  pa[0].start(p0 + ka, OH, OW);
  pa[1].start(p0 + ka + 48, OH, OW);

  auto load = [&](int kt) {  // stage kt; the positions then move on by one stage
    const uint32_t st = ring + (kt % kStages) * kStageBytes;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const Position& q = px[r];
      const bool valid = q.p < p_end && ci_ok && (kw < 2 || q.ow < OW - 1);
      const __nv_bfloat16* src = x + ((2 * q.line) * W + 2 * q.ow + kw) * CI + ci;
      const uint32_t off = swizzled_offset(kx + 32 * r, c);
#pragma unroll
      for (int kh = 0; kh < 3; ++kh) {
        const bool v = valid && (kh < 2 || q.oh < OH - 1);
        cp_async_16(st + kABytes + kh * kSlotBytes + off,
                    v ? src + kh * static_cast<long long>(W) * CI : x, v);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (r == 1 && !two_dy_rows) break;
      const Position& q = pa[r];
      const bool v = q.p < p_end && co_ok;
      cp_async_16(st + swizzled_offset(ka + 48 * r, ca), v ? dy + q.p * CO + co0 + 8 * ca : dy, v);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      px[r].advance(OH, OW);
      pa[r].advance(OH, OW);
    }
  };

  float acc[kAccumulators];
#pragma unroll
  for (int i = 0; i < kAccumulators; ++i) acc[i] = 0.0f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles) load(s);
    cp_async_commit();  // empty groups keep the count of groups uniform
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStages - 2>();  // this thread's copies of stage kt have landed
    fence_proxy_async();           // they, and the zeroed padding, are visible to wgmma
    __syncthreads();               // everyone's copies of kt; everyone done with kt - 1's slot
    if (kt + kStages - 1 < ktiles) load(kt + kStages - 1);
    cp_async_commit();
    const uint32_t sa = ring + (kt % kStages) * kStageBytes;
    const uint32_t sb = sa + kABytes + wg * kSlotBytes;
    fence_accumulators(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kTileP / 16; ++ks)  // 16 positions = two groups of 8 rows, 2 KB
      wgmma_m64n128k16_mn(acc, make_descriptor(sa + ks * 2048, kAtomBytes, 1024),
                          make_descriptor(sb + ks * 2048, kAtomBytes, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_accumulators(acc);
  }

  // the D fragment of warpgroup kh: accumulator i is row (output channel) 16 (warp % 4)
  // + lane / 4 + 8 ((i / 2) % 2), column 8 (i / 4) + 2 (lane % 4) + i % 2 = kw 32 + channel
  const int lane = tid & 31;
  const int m = 16 * ((tid >> 5) & 3) + (lane >> 2);
  float* out = scratch + static_cast<long long>(blockIdx.x) * 9 * CI * CO;
#pragma unroll
  for (int i = 0; i < kAccumulators; ++i) {
    const int n = 8 * (i / 4) + 2 * (lane & 3) + (i & 1);
    const int co = co0 + m + 8 * ((i >> 1) & 1), ch = ci0 + (n & 31), tap = 3 * wg + (n >> 5);
    if (n < 3 * kTileCi && ch < CI && co < CO)
      out[(static_cast<long long>(tap) * CI + ch) * CO + co] = acc[i];
  }
}

// out[i] = scratch[0][i] + scratch[1][i] + .. in that order
__global__ void __launch_bounds__(kJoinThreads)
join_kernel(const float* __restrict__ scratch, float* __restrict__ out, long long n_out,
            long long splits) {
  const long long i = static_cast<long long>(blockIdx.x) * kJoinThreads + threadIdx.x;
  if (i >= n_out) return;
  float s = scratch[i];
#pragma unroll 8
  for (long long k = 1; k < splits; ++k) s = __fadd_rn(s, scratch[k * n_out + i]);
  out[i] = s;
}

// The shapes taken: channel counts that are multiples of 8 (a 16-byte chunk is wholly inside
// or wholly outside the tensor); every count an int, and the positions B H/2 W/2 below 2^31,
// since a block counts its share of them in ints (tested in this order, no product
// overflows); conv_dw.cu's limits on the rest (offsets are 64-bit).
bool eligible(long long B, long long H, long long W, long long CI, long long CO) {
  const long long lim = 1LL << 31, big = 1LL << 40;
  if (B <= 0 || H <= 0 || W <= 0 || CI <= 0 || CO <= 0 || H % 2 != 0 || W % 2 != 0 ||
      CI % 8 != 0 || CO % 8 != 0)
    return false;
  if (B >= lim || H >= lim || W >= (1LL << 30) || CI >= (1LL << 20) || CO >= (1LL << 20))
    return false;
  const long long plane = (H / 2) * (W / 2);
  return plane < lim && B * plane < lim && 9 * CI * CO < lim && B * H * W < big / CI &&
         B * H * W < big / CO;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// as many splits of the positions as blocks fit on the card at once, shared among the
// channel tiles; at most one a stage of positions
cudaError_t plan(long long P, long long CI, long long CO, dim3* grid) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t rc = cudaGetDevice(&device);
  if (rc != cudaSuccess) return rc;
  rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (rc != cudaSuccess) return rc;
  rc = cudaFuncSetAttribute(conv_dw_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                            kSmemBytes);
  if (rc != cudaSuccess) return rc;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, conv_dw_wgmma_kernel, kThreads,
                                                     kSmemBytes);
  if (rc != cudaSuccess) return rc;
  const long long tiles_ci = (CI + kTileCi - 1) / kTileCi;
  const long long tiles_co = (CO + kTileCo - 1) / kTileCo;
  long long splits = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sms / (tiles_ci * tiles_co);
  const long long stages = (P + kTileP - 1) / kTileP;
  if (splits > stages) splits = stages;
  if (splits < 1) splits = 1;
  *grid = dim3(static_cast<unsigned>(splits), static_cast<unsigned>(tiles_ci),
               static_cast<unsigned>(tiles_co));
  return cudaSuccess;
}

}  // namespace

// x (B, H, W, CI) and dy (B, H/2, W/2, CO) contiguous bf16, both pointers 16-byte aligned,
// the shapes as eligible() takes them; anything else is refused (cudaErrorInvalidValue),
// never rerouted. ops/conv_dw.py's conv_dw_arrangement states the same rule.

// The number of partial results the launch will write for these shapes on the current
// device: the caller allocates splits * 9 * CI * CO floats of scratch. Negative: minus a
// CUDA error code.
extern "C" long long cdw_wgmma_splits(long long B, long long H, long long W, long long CI,
                                      long long CO) {
  if (!eligible(B, H, W, CI, CO)) return -static_cast<long long>(cudaErrorInvalidValue);
  dim3 grid;
  const cudaError_t rc = plan(B * (H / 2) * (W / 2), CI, CO, &grid);
  return rc == cudaSuccess ? static_cast<long long>(grid.x) : -static_cast<long long>(rc);
}

// out (3, 3, CI, CO) float32; scratch at least cdw_wgmma_splits(..) * 9 * CI * CO floats.
// Every element of out is written. Launches on `stream` and returns the CUDA error code.
extern "C" int cdw_wgmma_launch(const void* x, const void* dy, void* out, void* scratch,
                                long long scratch_floats, long long B, long long H, long long W,
                                long long CI, long long CO, void* stream) {
  if (!eligible(B, H, W, CI, CO) || !aligned16(x) || !aligned16(dy))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long OH = H / 2, OW = W / 2, P = B * OH * OW, n_out = 9 * CI * CO;
  dim3 grid;
  cudaError_t rc = plan(P, CI, CO, &grid);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (scratch_floats < static_cast<long long>(grid.x) * n_out)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* scr = static_cast<float*>(scratch);
  conv_dw_wgmma_kernel<<<grid, kThreads, kSmemBytes, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(dy), scr,
      static_cast<int>(W), static_cast<int>(CI), static_cast<int>(CO), static_cast<int>(OH),
      static_cast<int>(OW), static_cast<int>(P));
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const unsigned blocks = static_cast<unsigned>((n_out + kJoinThreads - 1) / kJoinThreads);
  join_kernel<<<blocks, kJoinThreads, 0, s>>>(scr, static_cast<float*>(out), n_out, grid.x);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cdw_wgmma_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
