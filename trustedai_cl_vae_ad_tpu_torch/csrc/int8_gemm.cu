// Skinny int8 GEMM for int8 serving: acc[m, n] = sum_{k0 <= k < k1} x[m, k] * w[n, k].
//
// Replaces the TPU kernel benchmarks/r4_int8_gemm.py::make_pallas_gemm::kernel
// (Pallas: int8 x int8 -> int32, a K-sequential accumulator per N tile). It is
// the product of ops/quant.py::_dense in "w8a8" mode: x (M, K) int8 holds the
// dynamically quantized activations of M = 1..16 frames, w (N, K) int8 holds a
// Dense kernel in the port's (out, in) layout, so the contraction axis is the
// contiguous one of both operands; out (M, N) is int32. The caller gives a
// K-range [k0, k1) of the full matrices: _dense calls once per chunk of at most
// 131072, where 127 * 127 * 131072 < 2^31 cannot overflow.
//
// What bounds it on Hopper: M is tiny, so every weight byte is used M times and
// the work is one stream of the weights through the card (1.075 GB for the
// flagship's encoder Dense): device memory bytes, until M is large enough that
// the CUDA cores' dp4a rate or the shared-memory reads of x take over (about
// M = 16 here). The TPU kernel walks K sequentially per N tile because its
// matrix unit wants (bk, bn) tiles in VMEM; none of that carries over.
// The design: a block of 8 warps owns 16 weight rows (2 per warp) and one split
// of the K-range. It walks its split in tiles: the tile of x (MT rows, MT *
// tile = 32 KB) is staged in shared memory once and read by every warp; a lane
// streams 16 contiguous bytes of each of its two weight rows per step (a warp
// reads 512 contiguous bytes of a row, evict-first), and does 4 dp4a per row
// and activation row against the staged x. The lanes' partial sums meet in a
// warp shuffle reduction; the K splits (chosen so that about four blocks per
// SM exist when N is small) meet in atomicAdd on an output that the launcher
// zeroes. Integer addition is associative, so any order gives the same bits.
// M > 32 is walked in tiles of 32 (the weights are then read once per tile).
// Sizes that are not multiples of 16, a K-range that does not start or end on
// one, or pointers that are not 16-byte aligned take the same kernel with
// byte-wise guarded loads: right, not fast.
//
// Overflow: all sums are taken modulo 2^32 (dp4a wraps in hardware; the
// reductions and the atomics are done on unsigned values, where wrapping is
// defined), and the result is that value read as two's-complement int32. For
// inputs in [-127, 127] and k1 - k0 <= 133144 no sum can leave int32, so the
// result is the exact product; a longer range gives the exact product modulo
// 2^32, which ops/int8_gemm.py::int8_gemm_reference reproduces.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 2;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;
constexpr int kSmemBytes = 32768;
constexpr int kMaxTile = 4096;
constexpr int kBlocksPerSm = 4;

template <int MT>
struct Tile {
  // bytes of K per tile: MT rows of it fill the shared buffer; a multiple of 512
  static constexpr int kBytes = (kSmemBytes / MT) < kMaxTile ? (kSmemBytes / MT) : kMaxTile;
};

// 16 bytes of `row` from k on, zeros from `end` on. VEC: row + k is 16-byte
// aligned and end - k is a multiple of 16.
template <bool VEC, bool STREAM>
__device__ __forceinline__ int4 load16(const int8_t* __restrict__ row, long long k,
                                       long long end) {
  if (VEC) {
    if (k >= end) return make_int4(0, 0, 0, 0);
    const int4* p = reinterpret_cast<const int4*>(row + k);
    return STREAM ? __ldcs(p) : *p;
  }
  unsigned words[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    unsigned v = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const long long kk = k + 4 * i + b;
      const unsigned byte = kk < end ? static_cast<unsigned>(static_cast<uint8_t>(row[kk])) : 0u;
      v |= byte << (8 * b);
    }
    words[i] = v;
  }
  return make_int4(static_cast<int>(words[0]), static_cast<int>(words[1]),
                   static_cast<int>(words[2]), static_cast<int>(words[3]));
}

template <int MT, bool VEC>
__global__ void __launch_bounds__(kThreads)
int8_gemm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                 unsigned* __restrict__ out, int m0, int m_total, int n_total, long long k_total,
                 long long k0, long long k1, long long k_per_split) {
  constexpr int KT = Tile<MT>::kBytes;
  constexpr int kGroups = KT / 16;  // 16-byte groups per row of the tile
  __shared__ int4 xs[MT * kGroups];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long split_begin = k0 + static_cast<long long>(blockIdx.y) * k_per_split;
  const long long split_end = split_begin + k_per_split < k1 ? split_begin + k_per_split : k1;

  int n[kRowsPerWarp];
  const int8_t* w_row[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    n[r] = blockIdx.x * kRowsPerBlock + warp * kRowsPerWarp + r;
    // rows past the end read the last row; their sums are dropped below
    const int n_load = n[r] < n_total ? n[r] : n_total - 1;
    w_row[r] = w + static_cast<long long>(n_load) * k_total;
  }

  int acc[MT][kRowsPerWarp];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) acc[m][r] = 0;

  for (long long kt = split_begin; kt < split_end; kt += KT) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = threadIdx.x; i < MT * kGroups; i += kThreads) {
      const int m = i / kGroups;
      const long long k = kt + 16LL * (i % kGroups);
      int4 v = make_int4(0, 0, 0, 0);
      if (m0 + m < m_total)
        v = load16<VEC, false>(x + static_cast<long long>(m0 + m) * k_total, k, split_end);
      xs[i] = v;
    }
    __syncthreads();
#pragma unroll 2
    for (int g = lane; g < kGroups; g += 32) {
      const long long k = kt + 16LL * g;
      if (k >= split_end) break;
      int4 wv[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) wv[r] = load16<VEC, true>(w_row[r], k, split_end);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const int4 xv = xs[m * kGroups + g];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          int a = acc[m][r];
          a = __dp4a(xv.x, wv[r].x, a);
          a = __dp4a(xv.y, wv[r].y, a);
          a = __dp4a(xv.z, wv[r].z, a);
          a = __dp4a(xv.w, wv[r].w, a);
          acc[m][r] = a;
        }
      }
    }
  }

#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      unsigned v = static_cast<unsigned>(acc[m][r]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane == 0 && n[r] < n_total && m0 + m < m_total)
        atomicAdd(out + static_cast<long long>(m0 + m) * n_total + n[r], v);
    }
  }
}

template <int MT, bool VEC>
cudaError_t launch_tile(const int8_t* x, const int8_t* w, unsigned* out, int m0, int m_total,
                        int n_total, long long k_total, long long k0, long long k1, int sms,
                        cudaStream_t stream) {
  constexpr int KT = Tile<MT>::kBytes;
  const long long n_tiles = (n_total + kRowsPerBlock - 1) / kRowsPerBlock;
  const long long k_tiles = (k1 - k0 + KT - 1) / KT;
  long long splits = (static_cast<long long>(sms) * kBlocksPerSm + n_tiles - 1) / n_tiles;
  if (splits > k_tiles) splits = k_tiles;
  if (splits < 1) splits = 1;
  const long long k_per_split = (k_tiles + splits - 1) / splits * KT;
  splits = (k1 - k0 + k_per_split - 1) / k_per_split;
  const dim3 grid(static_cast<unsigned>(n_tiles), static_cast<unsigned>(splits));
  int8_gemm_kernel<MT, VEC><<<grid, kThreads, 0, stream>>>(
      x, w, out, m0, m_total, n_total, k_total, k0, k1, k_per_split);
  return cudaGetLastError();
}

template <bool VEC>
cudaError_t launch_all(const int8_t* x, const int8_t* w, unsigned* out, int m_total, int n_total,
                       long long k_total, long long k0, long long k1, int sms,
                       cudaStream_t stream) {
  for (int m0 = 0; m0 < m_total; m0 += 32) {
    const int rem = m_total - m0;
    cudaError_t rc;
#define TILE(MT) launch_tile<MT, VEC>(x, w, out, m0, m_total, n_total, k_total, k0, k1, sms, stream)
    if (rem > 16) rc = TILE(32);
    else if (rem > 8) rc = TILE(16);
    else if (rem > 4) rc = TILE(8);
    else if (rem > 2) rc = TILE(4);
    else if (rem == 2) rc = TILE(2);
    else rc = TILE(1);
#undef TILE
    if (rc != cudaSuccess) return rc;
  }
  return cudaSuccess;
}

}  // namespace

// x (m, k_total) int8 and w (n, k_total) int8, both row-major; out (m, n) int32.
// Contracts over [k0, k1). Zeroes out, then launches; returns the CUDA error code.
extern "C" int int8_gemm_launch(const void* x, const void* w, void* out, int m, int n,
                                long long k_total, long long k0, long long k1, void* stream) {
  if (m <= 0 || n <= 0 || k_total <= 0 || k0 < 0 || k1 <= k0 || k1 > k_total)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int device = 0, sms = 0;
  cudaError_t rc = cudaGetDevice(&device);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  rc = cudaMemsetAsync(out, 0, sizeof(int32_t) * static_cast<size_t>(m) * n, s);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const bool vec = k_total % 16 == 0 && k0 % 16 == 0 && k1 % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const int8_t* xp = static_cast<const int8_t*>(x);
  const int8_t* wp = static_cast<const int8_t*>(w);
  unsigned* op = static_cast<unsigned*>(out);
  rc = vec ? launch_all<true>(xp, wp, op, m, n, k_total, k0, k1, sms, s)
           : launch_all<false>(xp, wp, op, m, n, k_total, k0, k1, sms, s);
  return static_cast<int>(rc);
}

extern "C" const char* int8_gemm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
