// Weight gradient of a 3x3, stride-2, SAME convolution on even H and W:
//
//   dW[kh, kw, ci, co] = sum_{b, oh, ow} xpad[b, 2 oh + kh, 2 ow + kw, ci] * dy[b, oh, ow, co]
//
// x (B, H, W, CI) and dy (B, H/2, W/2, CO) are NHWC, both bf16 or both float32;
// xpad is x with one row of zeros below and one column of zeros to the right;
// dW (3, 3, CI, CO) is float32, summed in float32.
//
// Replaces the TPU kernel benchmarks/r18_conv_dw.py::_dw_kernel (launched by
// conv_dw_pallas). That kernel takes one image a grid step, reads the stride-2
// taps from four parity planes that XLA builds beforehand, and adds each
// image's (9 CI, CO) product into one output block, relying on the TPU's
// sequential grid. Neither the planes nor the sequential sum carry over: here x
// is read with its stride directly and blocks run in parallel.
//
// What bounds it on Hopper. As a matrix product it is (9 CI, P) @ (P, CO) with
// P = B H W / 4 positions: a long contraction into a tiny result. The operands
// are read once (0.34 ms at the encoder's first layer, batch 768, bf16, at the
// card's memory rate), but every position costs 2 * 9 CI * CO operations: 22
// GFLOP at (3 -> 32) and 119 GFLOP at (32 -> 64). The tensor cores would do that
// in 0.02 and 0.12 ms, so the bytes are the card's bound; this first version
// runs the product on CUDA cores (67 TFLOP/s at best: 0.33 and 1.8 ms), and is
// bound by their FMA rate and by the shared-memory reads that feed it. It
// reaches 14 and 31 TFLOP/s on an H100 at 700 W.
//
// The design. The rows of the result are ordered (kh, kw, ci): for a fixed kh
// the 3 CI values that one output position needs are CONTIGUOUS in an NHWC row
// of x, starting at pixel 2 ow. A block therefore stages, for a run of output
// positions of one output line (b, oh), the three input rows 2 oh .. 2 oh + 2
// as they lie in memory (a straight copy to float32 in shared memory, zeros
// where the row or the column is the padding), and the run's dy rows. No im2col
// matrix is ever built: a thread reads row r = (kh, kw, ci) of position p at
// Xs[kh][(2 p + kw) CI + ci], an offset it computes once. Each thread keeps a
// patch of float32 sums in registers, fed by fmaf (the file is built with
// --fmad=false, which would split a * b + c):
//   Big    8 warps; warp w owns the channels 4 w .. 4 w + 3 of all 9 taps (36
//          rows), a lane 2 of 64 columns: 288 x 64 sums, the whole result at
//          (32 -> 64). Per position nine 16-byte reads of x, the same for the
//          whole warp, and one 8-byte read of dy feed 72 FMAs; runs of up to 32
//          positions. The patch is shaped for those reads: 16 x 16 threads with
//          18 strided rows x 4 columns each need 18 scalar reads of x a
//          position, and the shared-memory pipe, not the FMAs, then sets the
//          time (a third more of it).
//   Small  for CI <= 3: 8 warps, each a 4 x 8 arrangement of 7 x 4 patches (28 x
//          32 sums) that takes every 8th position; the warps' patches are added
//          in shared memory, in warp order, at the end. A run is up to 160
//          positions, a whole line of the flagship's first layer: a warp does
//          so little arithmetic a position here that with short runs the two
//          barriers and the load latency of each run set the time.
// More channels are tiled over the grid (32 input channels, 64 or 32 output
// channels a block). The output lines are split evenly over as many blocks as
// fit on the card at once (the occupancy API says how many); each writes its
// partial result to its own slice of a scratch buffer that the caller
// allocates, and a second kernel adds the slices in index order. No float
// atomics: two runs give equal bits. All offsets are 64-bit.
// x and dy are read 16 bytes a thread where the pointer and the channel count
// allow it, element by element otherwise (always at CI = 3, whose 6-byte pixels
// line up with nothing; the staging is a small share of the work there). The
// order of the sums does not depend on which of the two it is.
// The tensor cores: bf16 operands with channel counts that are multiples of 8 on 16-byte
// boundaries go to conv_dw_wgmma.cu (wgmma fed by a cp.async im2col gather) instead; this
// kernel keeps float32, CI = 3 (6-byte pixels fit no 16-byte chunk) and ragged channel
// counts (ops/conv_dw.py's conv_dw_arrangement). Next here: CI = 3 on the tensor cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// 16 bytes at an aligned p, as float32 (bf16: the lower address in the lower half of a word)
__device__ __forceinline__ void load16(const float* p, float (&out)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&out)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const unsigned words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(words[i] << 16);
    out[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
  }
}

// V floats to a 16-byte aligned place in shared memory
template <int V>
__device__ __forceinline__ void store_f32(float* dst, const float (&v)[V]) {
#pragma unroll
  for (int i = 0; i < V; i += 4)
    *reinterpret_cast<float4*>(dst + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
}

// A block's threads: kGroups groups of TY x TX; group g takes the positions g, g + kGroups,
// .. of a run. A thread owns CN adjacent columns (CN tx ..) and kAcc rows of the result:
//   RW == 1  rows ty + TY i, i < RM, of the (tap, channel) order: one scalar read of x each;
//   RW == 4  the channels 4 ty .. 4 ty + 3 of every tap (RM = 9 taps): one 16-byte read of x
//            for each tap where the block's channel count is a multiple of 4 (VECA), four
//            scalar reads otherwise.
// A group covers the 9 taps of up to kCit input channels by CN TX columns; a run has up to
// kMaxKT positions.
template <int RM_, int RW_, int TY_, int TX_, int CN_, int CIT_, int MAX_KT_, int MIN_BLOCKS_>
struct Config {
  static constexpr int RM = RM_, RW = RW_, TY = TY_, TX = TX_, CN = CN_, kCit = CIT_;
  static constexpr int kMaxKT = MAX_KT_, kMinBlocks = MIN_BLOCKS_;
  static constexpr int kAcc = RM * RW;
  static constexpr int kGroups = kThreads / (TY * TX);
  static constexpr int kCols = CN * TX;
  static constexpr int kXsFloats = 3 * (2 * kMaxKT + 1) * kCit;
  static constexpr int kXsOffset = (kXsFloats + 3) / 4 * 4;  // Bs starts on a 16-byte boundary
  static constexpr int kBsFloats = kMaxKT * kCols;
  // the groups' patches meet in the staging buffers, which are free by then
  static constexpr int kRedFloats = kGroups > 1 ? kGroups * TY * TX * kAcc * CN : 0;
  static constexpr int kSmemFloats =
      kXsOffset + kBsFloats > kRedFloats ? kXsOffset + kBsFloats : kRedFloats;
  static_assert(kGroups * TY * TX == kThreads, "the groups fill the block");
  static_assert(RW == 1 ? TY * RM >= 9 * kCit : (RM == 9 && TY * RW >= kCit),
                "a group's rows hold every tap of its channels");
  static_assert(CN == 2 || CN == 4, "a thread reads its columns of dy in one load");
  static_assert(kSmemFloats * 4 <= 48 * 1024, "static shared memory");
};
// 28 x 32 sums a warp, 8 warps on every 8th position; a whole line of 150 positions a run
using Small = Config<7, 1, 4, 8, 4, 3, 160, 4>;
// 288 x 64 sums: warp ty owns channels 4 ty .. 4 ty + 3 of all 9 taps, a lane 2 columns
using Big = Config<9, 4, 8, 32, 2, 32, 32, 2>;

template <typename T, typename C, bool VECA>
__global__ void __launch_bounds__(kThreads, C::kMinBlocks)
conv_dw_kernel(const T* __restrict__ x, const T* __restrict__ dy, float* __restrict__ scratch,
               long long H, long long W, long long CI, long long CO, long long OH, long long OW,
               long long lines, int kt, int vec_x, int vec_dy) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  constexpr int RM = C::RM, RW = C::RW, CN = C::CN;
  __shared__ __align__(16) float smem[C::kSmemFloats];
  float* const Xs = smem;
  float* const Bs = smem + C::kXsOffset;

  const int tid = threadIdx.x;
  const int group = tid / (C::TY * C::TX);
  const int ty = (tid % (C::TY * C::TX)) / C::TX;
  const int tx = tid % C::TX;
  const long long ci0 = static_cast<long long>(blockIdx.y) * C::kCit;
  const long long c0 = static_cast<long long>(blockIdx.z) * C::kCols;
  const int cit = static_cast<int>(CI - ci0 < C::kCit ? CI - ci0 : C::kCit);
  const bool whole = cit == CI;  // a pixel's channels are all this block's: rows of x are runs
  const int npix = 2 * kt + 1;

  // where the thread's i-th read of x for position 0 lies in Xs. RW == 1: row ty + TY i =
  // (tap, cl); rows past the last read element 0. RW == 4: tap i, channels 4 ty ..; channels
  // past the last read what lies behind them. Both are dropped at the end.
  int aoff[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    if constexpr (RW == 1) {
      const int r = ty + C::TY * i;
      aoff[i] = 0;
      if (r < 9 * cit) {
        const int tap = r / cit, cl = r % cit;
        aoff[i] = ((tap / 3) * npix + tap % 3) * cit + cl;
      }
    } else {
      aoff[i] = ((i / 3) * npix + i % 3) * cit + RW * ty;
    }
  }
  float acc[C::kAcc][CN];
#pragma unroll
  for (int i = 0; i < C::kAcc; ++i)
#pragma unroll
    for (int j = 0; j < CN; ++j) acc[i][j] = 0.0f;

  const long long line_begin = lines * blockIdx.x / gridDim.x;
  const long long line_end = lines * (blockIdx.x + 1) / gridDim.x;
  for (long long line = line_begin; line < line_end; ++line) {
    const long long b = line / OH, oh = line % OH;
    for (long long ow0 = 0; ow0 < OW; ow0 += kt) {
      const int n = static_cast<int>(OW - ow0 < kt ? OW - ow0 : kt);
      const int count = (2 * n + 1) * cit;  // staged elements of one input row
      // pixels of the run that exist: the last one of a line's last run is the padding
      const int valid_pix = static_cast<int>(W - 2 * ow0 < 2 * n + 1 ? W - 2 * ow0 : 2 * n + 1);
      __syncthreads();  // the previous run's readers are done
      for (int kh = 0; kh < 3; ++kh) {
        const long long row = 2 * oh + kh;
        float* dst = Xs + kh * npix * cit;
        if (row >= H) {  // the padding below the image
          for (int e = tid; e < count; e += kThreads) dst[e] = 0.0f;
          continue;
        }
        const T* src = x + ((b * H + row) * W + 2 * ow0) * CI + ci0;
        if (whole && vec_x) {
          const int valid = valid_pix * cit;  // a multiple of V, as count is
          for (int e = tid * V; e < count; e += kThreads * V) {
            float v[V];
#pragma unroll
            for (int j = 0; j < V; ++j) v[j] = 0.0f;
            if (e < valid) load16(src + e, v);
            store_f32<V>(dst + e, v);
          }
        } else if (whole) {
          const int valid = valid_pix * cit;
          for (int e = tid; e < count; e += kThreads) dst[e] = e < valid ? to_f32(src[e]) : 0.0f;
        } else {
          for (int e = tid; e < count; e += kThreads) {
            const int pix = e / cit, cl = e - pix * cit;
            dst[e] = pix < valid_pix ? to_f32(src[pix * CI + cl]) : 0.0f;
          }
        }
      }
      const T* dsrc = dy + (line * OW + ow0) * CO + c0;
      if (vec_dy) {
        constexpr int kGroupsPerRow = C::kCols / V;
        for (int g = tid; g < n * kGroupsPerRow; g += kThreads) {
          const int pl = g / kGroupsPerRow, cc = (g % kGroupsPerRow) * V;
          float v[V];
#pragma unroll
          for (int j = 0; j < V; ++j) v[j] = 0.0f;
          if (c0 + cc < CO) load16(dsrc + pl * CO + cc, v);
          store_f32<V>(Bs + pl * C::kCols + cc, v);
        }
      } else {
        for (int e = tid; e < n * C::kCols; e += kThreads) {
          const int pl = e / C::kCols, cc = e % C::kCols;
          Bs[e] = c0 + cc < CO ? to_f32(dsrc[pl * CO + cc]) : 0.0f;
        }
      }
      __syncthreads();
#pragma unroll 2
      for (int pl = group; pl < n; pl += C::kGroups) {
        const float* xp = Xs + 2 * pl * cit;
        float d[CN];
        if constexpr (CN == 4) {
          const float4 v = *reinterpret_cast<const float4*>(Bs + pl * C::kCols + 4 * tx);
          d[0] = v.x, d[1] = v.y, d[2] = v.z, d[3] = v.w;
        } else {
          const float2 v = *reinterpret_cast<const float2*>(Bs + pl * C::kCols + 2 * tx);
          d[0] = v.x, d[1] = v.y;
        }
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          float a[RW];
          if constexpr (RW == 1) {
            a[0] = xp[aoff[i]];
          } else if constexpr (VECA) {
            const float4 v = *reinterpret_cast<const float4*>(xp + aoff[i]);
            a[0] = v.x, a[1] = v.y, a[2] = v.z, a[3] = v.w;
          } else {
#pragma unroll
            for (int k = 0; k < RW; ++k) a[k] = xp[aoff[i] + k];
          }
#pragma unroll
          for (int k = 0; k < RW; ++k)
#pragma unroll
            for (int j = 0; j < CN; ++j) acc[RW * i + k][j] = fmaf(a[k], d[j], acc[RW * i + k][j]);
        }
      }
    }
  }

  if constexpr (C::kGroups > 1) {  // the groups' patches, added in group order by group 0
    __syncthreads();               // the last run's readers are done: the buffers are free
    float* const Red = smem;
    const int slot = (ty * C::TX + tx) * C::kAcc * CN;
    constexpr int kPatch = C::TY * C::TX * C::kAcc * CN;
#pragma unroll
    for (int i = 0; i < C::kAcc; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) Red[group * kPatch + slot + i * CN + j] = acc[i][j];
    __syncthreads();
    if (group != 0) return;
#pragma unroll
    for (int i = 0; i < C::kAcc; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        float s = acc[i][j];
        for (int g = 1; g < C::kGroups; ++g) s = __fadd_rn(s, Red[g * kPatch + slot + i * CN + j]);
        acc[i][j] = s;
      }
  }
  float* out = scratch + static_cast<long long>(blockIdx.x) * 9 * CI * CO;
#pragma unroll
  for (int i = 0; i < C::kAcc; ++i) {
    int tap, cl;
    if constexpr (RW == 1) {
      const int r = ty + C::TY * i;
      if (r >= 9 * cit) continue;
      tap = r / cit, cl = r % cit;
    } else {
      tap = i / RW, cl = RW * ty + i % RW;
      if (cl >= cit) continue;
    }
    const long long out_row = static_cast<long long>(tap) * CI + ci0 + cl;
#pragma unroll
    for (int j = 0; j < CN; ++j) {
      const long long c = c0 + CN * tx + j;
      if (c < CO) out[out_row * CO + c] = acc[i][j];
    }
  }
}

// out[i] = scratch[0][i] + scratch[1][i] + .. in that order
__global__ void __launch_bounds__(kThreads)
join_kernel(const float* __restrict__ scratch, float* __restrict__ out, long long n_out,
            long long splits) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n_out) return;
  float s = scratch[i];
#pragma unroll 8
  for (long long k = 1; k < splits; ++k) s = __fadd_rn(s, scratch[k * n_out + i]);
  out[i] = s;
}

struct Plan {
  dim3 grid;
  int kt;
};

// The grid and the run length for one configuration: as many splits of the output lines
// as blocks fit on the card at once, shared among the channel tiles.
template <typename T, typename C>
cudaError_t make_plan(long long lines, long long OW, long long CI, long long CO, Plan* plan) {
  constexpr int kMaxKT = C::kMaxKT;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t rc = cudaGetDevice(&device);
  if (rc != cudaSuccess) return rc;
  rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (rc != cudaSuccess) return rc;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, conv_dw_kernel<T, C, true>, kThreads,
                                                     0);
  if (rc != cudaSuccess) return rc;
  const long long tiles_ci = (CI + C::kCit - 1) / C::kCit;
  const long long tiles_co = (CO + C::kCols - 1) / C::kCols;
  if (tiles_ci > 65535 || tiles_co > 65535) return cudaErrorInvalidValue;
  long long splits = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sms / (tiles_ci * tiles_co);
  if (splits > lines) splits = lines;
  if (splits < 1) splits = 1;
  const long long runs = (OW + kMaxKT - 1) / kMaxKT;
  long long kt = (OW + runs - 1) / runs;
  kt = (kt + C::kGroups - 1) / C::kGroups * C::kGroups;  // every group busy in a full run
  if (kt > kMaxKT) kt = kMaxKT;
  plan->grid = dim3(static_cast<unsigned>(splits), static_cast<unsigned>(tiles_ci),
                    static_cast<unsigned>(tiles_co));
  plan->kt = static_cast<int>(kt);
  return cudaSuccess;
}

template <typename T>
cudaError_t plan_for(long long lines, long long OW, long long CI, long long CO, Plan* plan) {
  return CI <= Small::kCit ? make_plan<T, Small>(lines, OW, CI, CO, plan)
                           : make_plan<T, Big>(lines, OW, CI, CO, plan);
}

template <typename T>
cudaError_t launch(const void* x, const void* dy, float* out, float* scratch,
                   long long scratch_floats, long long B, long long H, long long W, long long CI,
                   long long CO, cudaStream_t stream) {
  const long long OH = H / 2, OW = W / 2, lines = B * OH, n_out = 9 * CI * CO;
  Plan plan;
  cudaError_t rc = plan_for<T>(lines, OW, CI, CO, &plan);
  if (rc != cudaSuccess) return rc;
  if (scratch_floats < static_cast<long long>(plan.grid.x) * n_out) return cudaErrorInvalidValue;
  const T* xp = static_cast<const T*>(x);
  const T* dyp = static_cast<const T*>(dy);
  constexpr long long V = 16 / sizeof(T);
  const int vec_x = reinterpret_cast<uintptr_t>(x) % 16 == 0 && CI % V == 0;
  const int vec_dy = reinterpret_cast<uintptr_t>(dy) % 16 == 0 && CO % V == 0;
  if (CI <= Small::kCit)
    conv_dw_kernel<T, Small, false><<<plan.grid, kThreads, 0, stream>>>(
        xp, dyp, scratch, H, W, CI, CO, OH, OW, lines, plan.kt, vec_x, vec_dy);
  else if (CI % 4 == 0)  // then every tile's channel count is a multiple of 4
    conv_dw_kernel<T, Big, true><<<plan.grid, kThreads, 0, stream>>>(
        xp, dyp, scratch, H, W, CI, CO, OH, OW, lines, plan.kt, vec_x, vec_dy);
  else
    conv_dw_kernel<T, Big, false><<<plan.grid, kThreads, 0, stream>>>(
        xp, dyp, scratch, H, W, CI, CO, OH, OW, lines, plan.kt, vec_x, vec_dy);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return rc;
  const unsigned blocks = static_cast<unsigned>((n_out + kThreads - 1) / kThreads);
  join_kernel<<<blocks, kThreads, 0, stream>>>(scratch, out, n_out, plan.grid.x);
  return cudaGetLastError();
}

bool shape_ok(long long B, long long H, long long W, long long CI, long long CO) {
  const long long limit = 1LL << 40;  // far below where the 64-bit offsets would wrap
  return B > 0 && H > 0 && W > 0 && CI > 0 && CO > 0 && H % 2 == 0 && W % 2 == 0 &&
         W < (1LL << 30) && CI < (1LL << 20) && CO < (1LL << 20) && B * H < limit &&
         B * H * W < limit / CI && B * H * W < limit / CO && 9 * CI * CO < (1LL << 31);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (x and dy alike).

// The number of partial results the launch will write for these shapes on the current
// device: the caller allocates splits * 9 * CI * CO floats of scratch. Negative: minus a
// CUDA error code.
extern "C" long long conv_dw_splits(int dtype, long long B, long long H, long long W, long long CI,
                                    long long CO) {
  if ((dtype != 0 && dtype != 1) || !shape_ok(B, H, W, CI, CO))
    return -static_cast<long long>(cudaErrorInvalidValue);
  Plan plan;
  const cudaError_t rc = dtype == 0 ? plan_for<float>(B * (H / 2), W / 2, CI, CO, &plan)
                                    : plan_for<__nv_bfloat16>(B * (H / 2), W / 2, CI, CO, &plan);
  return rc == cudaSuccess ? static_cast<long long>(plan.grid.x) : -static_cast<long long>(rc);
}

// x (B, H, W, CI) and dy (B, H/2, W/2, CO) contiguous; out (3, 3, CI, CO) float32; scratch
// at least conv_dw_splits(..) * 9 * CI * CO floats. Every element of out is written.
// Launches on `stream` and returns the CUDA error code.
extern "C" int conv_dw_launch(const void* x, const void* dy, void* out, void* scratch,
                              long long scratch_floats, int dtype, long long B, long long H,
                              long long W, long long CI, long long CO, void* stream) {
  if ((dtype != 0 && dtype != 1) || !shape_ok(B, H, W, CI, CO))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* outp = static_cast<float*>(out);
  float* scr = static_cast<float*>(scratch);
  const cudaError_t rc =
      dtype == 0 ? launch<float>(x, dy, outp, scr, scratch_floats, B, H, W, CI, CO, s)
                 : launch<__nv_bfloat16>(x, dy, outp, scr, scratch_floats, B, H, W, CI, CO, s);
  return static_cast<int>(rc);
}

extern "C" const char* conv_dw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
