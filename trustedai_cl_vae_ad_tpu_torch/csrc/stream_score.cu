// Fused streaming anomaly scorer: one EMA scorer update per frame.
//
// Replaces the TPU kernel trustedai_cl_vae_ad_tpu/ops/stream_score.py::
// _stream_kernel (Pallas, launched by _stream_pallas). Per frame k it reads
// img, rec (H, W, C) f32 in HWC order, the EMA maps (2, H, W) and the
// scalars (6,), and writes the new maps and scalars, the normalized error map
// (H, W) and [score, count]:
//   err   = sum_c (x - x_hat)^2
//   EMA min/max of err -> norm = (err - min_ema) / (max_ema - min_ema or 1)
//   EMAs of err and err^2 (seeded from the first frame)
//   z     = (err - ema) * rsqrt(|ema2 - ema^2| + 1e-10)
//   zz    = (z - mean z) / (std z or 1); count = #(zz > 3)
//   EMAs of count and count^2 -> score = (count - ema_c) / sqrt(ema_c2 - ema_c^2)
// The score is NaN where the count variance is 0 or rounds negative, as in
// the JAX package and the TF original.
//
// What bounds it on Hopper: at 224x300x3 a frame moves about 3 MB, and the
// update holds two frame-wide reductions that depend on each other (min/max
// before the map update, the z mean and std before the count), so the cost
// is latency and synchronisation, not bandwidth or arithmetic.
// The design: one 1024-thread block per frame (grid = K frames), grid-stride
// loops over the H*W pixels, and block reductions through warp shuffles and
// shared memory between four passes. Pass 1 parks err in the norm output,
// pass 2 parks z in a scratch buffer the caller allocates; each thread reads
// back only the pixels it wrote itself. std is two-pass, as jnp.std is.
// Build with --fmad=false and without fast math: every elementwise step then
// rounds as PyTorch's ops do, so only the reductions' order differs from the
// plain version (ops/stream_score.py::stream_score_step_reference).
// A multi-camera tick launches it once with grid = K frames and a validity
// mask (one byte a frame, or null for "all valid"): a frame whose byte is 0
// (a camera that dropped the tick) keeps its maps and scalars and reports
// score NaN and count 0, decided where the results are written.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 1024;

struct SumOp {
  __device__ float operator()(float a, float b) const { return a + b; }
  static __device__ float identity() { return 0.0f; }
};

// min/max that propagate NaN, like jnp.min / jnp.max
struct MinOp {
  __device__ float operator()(float a, float b) const { return (a != a || a < b) ? a : b; }
  static __device__ float identity() { return CUDART_INF_F; }
};

struct MaxOp {
  __device__ float operator()(float a, float b) const { return (a != a || a > b) ? a : b; }
  static __device__ float identity() { return -CUDART_INF_F; }
};

// Reduce v over the block; every thread gets the result. red holds 33 floats.
template <class Op>
__device__ float block_allreduce(float v, Op op, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = (blockDim.x + 31) >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float w = lane < n_warps ? red[lane] : Op::identity();
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) w = op(w, __shfl_xor_sync(0xffffffffu, w, o));
    if (lane == 0) red[32] = w;
  }
  __syncthreads();
  const float r = red[32];
  __syncthreads();  // red is reused by the next reduction
  return r;
}

__global__ void __launch_bounds__(kThreads)
stream_score_kernel(const float* __restrict__ img, const float* __restrict__ rec,
                    const float* __restrict__ maps, const float* __restrict__ scalars,
                    float alpha, float* __restrict__ out_maps,
                    float* __restrict__ out_scalars, float* __restrict__ norm,
                    float* __restrict__ score_count, float* __restrict__ zbuf,
                    const unsigned char* __restrict__ valid, int hw, int c) {
  __shared__ float red[33];
  const size_t k = blockIdx.x;
  img += k * hw * c;
  rec += k * hw * c;
  maps += k * 2 * hw;
  out_maps += k * 2 * hw;
  scalars += k * 6;
  out_scalars += k * 6;
  norm += k * hw;
  zbuf += k * hw;
  score_count += k * 2;

  const bool keep = valid != nullptr && valid[k] == 0;  // a dropped frame: state kept
  const float oma = 1.0f - alpha;
  const bool initialized = scalars[4] > 0.0f;

  // pass 1: err (parked in norm) and its min / max
  float lmin = MinOp::identity();
  float lmax = MaxOp::identity();
  for (int p = threadIdx.x; p < hw; p += blockDim.x) {
    const float* a = img + static_cast<size_t>(p) * c;
    const float* b = rec + static_cast<size_t>(p) * c;
    float d = a[0] - b[0];
    float e = d * d;
    for (int ch = 1; ch < c; ++ch) {
      d = a[ch] - b[ch];
      e = e + d * d;
    }
    norm[p] = e;
    lmin = MinOp()(lmin, e);
    lmax = MaxOp()(lmax, e);
  }
  const float e_min = block_allreduce(lmin, MinOp(), red);
  const float e_max = block_allreduce(lmax, MaxOp(), red);
  const float min_ema = alpha * scalars[0] + oma * e_min;
  const float max_ema = alpha * scalars[1] + oma * e_max;
  const float denom = max_ema - min_ema;
  const float denom_safe = denom == 0.0f ? 1.0f : denom;

  // pass 2: norm, the new EMA maps, z (parked in zbuf) and sum z
  float lsum = 0.0f;
  for (int p = threadIdx.x; p < hw; p += blockDim.x) {
    const float e = norm[p];
    norm[p] = (e - min_ema) / denom_safe;
    const float prev = initialized ? maps[p] : e;
    const float prev2 = initialized ? maps[hw + p] : e * e;
    const float ema = alpha * prev + oma * e;
    const float ema2 = alpha * prev2 + (oma * e) * e;
    const float var = fabsf(ema2 - ema * ema);
    const float z = (e - ema) * (1.0f / sqrtf(var + 1e-10f));
    out_maps[p] = keep ? maps[p] : ema;
    out_maps[hw + p] = keep ? maps[hw + p] : ema2;
    zbuf[p] = z;
    lsum += z;
  }
  const float n = static_cast<float>(hw);
  const float z_mean = block_allreduce(lsum, SumOp(), red) / n;

  // pass 3: population std of z, two-pass
  float lsq = 0.0f;
  for (int p = threadIdx.x; p < hw; p += blockDim.x) {
    const float dz = zbuf[p] - z_mean;
    lsq += dz * dz;
  }
  const float z_std = sqrtf(block_allreduce(lsq, SumOp(), red) / n);
  const float std_safe = z_std == 0.0f ? 1.0f : z_std;

  // pass 4: count of zz > 3
  float lcount = 0.0f;
  for (int p = threadIdx.x; p < hw; p += blockDim.x) {
    const float zz = (zbuf[p] - z_mean) / std_safe;
    lcount += zz > 3.0f ? 1.0f : 0.0f;
  }
  const float count = block_allreduce(lcount, SumOp(), red);

  if (threadIdx.x == 0) {
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

}  // namespace

extern "C" int stream_score_launch(const float* img, const float* rec, const float* maps,
                                   const float* scalars, float alpha, float* out_maps,
                                   float* out_scalars, float* norm, float* score_count,
                                   float* zbuf, const unsigned char* valid, int k, int hw,
                                   int c, void* stream) {
  if (k <= 0 || hw <= 0 || c <= 0) return static_cast<int>(cudaErrorInvalidValue);
  stream_score_kernel<<<k, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      img, rec, maps, scalars, alpha, out_maps, out_scalars, norm, score_count, zbuf, valid,
      hw, c);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* stream_score_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
