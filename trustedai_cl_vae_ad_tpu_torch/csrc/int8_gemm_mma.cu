// Skinny int8 GEMM for int8 serving on Hopper's tensor cores:
//   out[c, m, n] = sum over k in chunk c of x[m, k] * w[n, k]
// with the chunks [k0 + c * chunk, min(k0 + (c + 1) * chunk, k1)) of the range [k0, k1).
//
// Replaces the TPU kernel benchmarks/r4_int8_gemm.py::make_pallas_gemm::kernel
// (benchmarks/r4_int8_gemm.py:45; Pallas: int8 x int8 -> int32, a K-sequential
// accumulator per N tile), beside csrc/int8_gemm.cu, which does the same on CUDA
// cores (dp4a) and takes what this kernel refuses. ops/int8_gemm.py picks between
// the two by dtype, shape and alignment (int8_gemm_arrangement). It is the product
// of ops/quant.py::_dense in "w8a8" mode: x (M, K) int8 holds the dynamically
// quantized activations of M = 1..16 frames, w (N, K) int8 holds a Dense kernel in
// the port's (out, in) layout, so both operands are contiguous along K. The
// encoder Dense contracts over K = 268800 in chunks of 131072 (127 * 127 * 131072
// < 2^31: no chunk's sum can leave int32); this kernel writes each chunk's int32
// partial into its own slice of a (C, M, N) output, so a quantized Dense is one
// launch whatever its number of chunks.
//
// What bounds it on Hopper: at M <= 32 the product does 2 M operations a weight
// byte, 64 at most, against the int8 ridge of 1979e12 / 3.35e12 = 590 operations a
// byte: one stream of the weights through device memory (1.075 GB for the
// flagship's encoder Dense: 0.321 ms at 3.35 TB/s; 0.269 GB for the decoder's:
// 0.080 ms). The CUDA-core kernel misses that bound from M = 8 up: it issues
// M N K / 4 dp4a (8.6 G at M = 32, 4 multiply-adds a lane each) and reads x from
// shared memory M / 2 times per weight byte.
//
// The design: mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 with the operands
// swapped, so no transpose is needed. A is 16 weight rows x 32 bytes of K (row
// major, K contiguous: w as stored), B is 8 activation rows x 32 bytes (column
// major, K contiguous: x as stored), and the tile computed is out^T: 16 output
// channels x 8 frames. M is covered by NT n8 tiles (1 at M <= 8, 2 at M <= 16, 4
// above); M > 32 walks tiles of 32 in the grid's z. One mma does 4096 multiply-adds
// a warp, where one dp4a does 128. No .satfinite: the sums wrap modulo 2^32.
// A block of 8 warps owns 128 weight rows (16 a warp) and one K split. A 4-stage
// ring in shared memory holds, per stage, the 128 weight rows x 128 bytes of K (16
// KB) and the block's MT = 8 NT activation rows x 128 bytes; cp.async.cg copies
// 16-byte chunks into it, bypassing L1, three stages ahead of the warps, which
// keeps about 60 KB in flight a block (2 or 3 blocks an SM). (An L2 evict-first
// hint on the weights' copies, .L2::cache_hint with a createpolicy.fractional
// policy, builds but stops the kernel with cudaErrorIllegalInstruction on the
// H100 with CUDA 12.8, so the copies carry no hint.) Chunk c of row r sits at r * 128 + ((c ^ r
// % 8) * 16): the XOR swizzle puts the 8 rows that one ldmatrix phase reads at one
// logical chunk into 8 different bank groups. Fragments come from ldmatrix (x4 for
// A, x4 or x2 for B); a warp loads B once per k32 step and uses it for its 16
// rows. x's L2 re-reads are MT / 128 of the weight bytes: a quarter at M = 32.
// Edges: chunks past the end of a split (the decoder's K = 2000 ends half way
// through a k32 step), weight rows past N and activation rows past M are zero
// filled through cp.async's src-size 0; the store is masked.
// K splits: about kWaves waves of blocks where N alone gives too few (the encoder
// Dense's 32 N tiles); every split lies inside one chunk. Where a chunk has more
// than one split they meet in unsigned atomicAdd on an output the launcher zeroes
// (integer addition wraps and is associative: any order gives the same bits);
// where every chunk is one split (the decoder Dense) the blocks store directly and
// no memset is made.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 128;             // weight rows a block owns: 16 a warp
constexpr int kStageK = 128;           // bytes of K a stage holds
constexpr int kChunks = kStageK / 16;  // 16-byte chunks of a row of a stage
constexpr int kStages = 4;
constexpr int kWaves = 8;              // K splits aim at this many waves of resident blocks
constexpr int kMinSplitStages = 16;    // a split holds at least 2 KB of K (256 KB of weights)
constexpr int kMaxGridYZ = 65535;
constexpr int kMaxDevices = 64;

static_assert(kWarps * 16 == kRows, "a warp owns 16 weight rows (one m16 tile)");
static_assert(kChunks == 8, "the swizzle XORs a chunk index of 3 bits");

template <int NT>
struct Shape {
  static constexpr int kTileM = 8 * NT;  // activation rows of a stage
  static constexpr int kStageBytes = (kRows + kTileM) * kStageK;
  static constexpr int kSmemBytes = kStages * kStageBytes;
};

// byte offset of 16-byte chunk c of row r in a tile of 128-byte rows
__device__ __forceinline__ int swizzled(int r, int c) { return r * kStageK + ((c ^ (r & 7)) << 4); }

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_16(unsigned dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

__device__ __forceinline__ void ldmatrix_x2(unsigned (&r)[2], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(addr) : "memory");
}

// d += a (16 x 32, row) * b (32 x 8, col), s8 x s8 -> s32, wrapping
__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4], unsigned b0,
                                       unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int NT>
__global__ void __launch_bounds__(kThreads)
i8mma_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w, int* __restrict__ out,
             int m_total, int n_total, long long k_total, long long k0, long long k1,
             long long chunk, long long split_k, int splits_per_chunk, int atomic) {
  constexpr int MT = Shape<NT>::kTileM;
  constexpr int kWRows = kRows * kChunks / kThreads;  // weight chunks a thread copies a stage
  extern __shared__ __align__(128) uint8_t smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long n0 = static_cast<long long>(blockIdx.x) * kRows;
  const long long m0 = static_cast<long long>(blockIdx.z) * MT;
  // the chunk and the split of it that this block sums (only the last chunk can be
  // shorter, so it has no more splits than the others)
  const int c = blockIdx.y / splits_per_chunk, s = blockIdx.y % splits_per_chunk;
  const long long chunk_begin = k0 + c * chunk;
  const long long chunk_end = chunk_begin + chunk < k1 ? chunk_begin + chunk : k1;
  const long long begin = chunk_begin + s * split_k;
  const long long end = begin + split_k < chunk_end ? begin + split_k : chunk_end;
  const int n_stages = static_cast<int>((end - begin + kStageK - 1) / kStageK);

  // what this thread copies each stage: chunk `cc` of weight rows r_w + 32 j and, if
  // tid < MT * 8, chunk `cc` of activation row r_x
  const int cc = tid % kChunks;
  const int r_w = tid / kChunks;
  const int8_t* w_row[kWRows];
  bool w_ok[kWRows];
#pragma unroll
  for (int j = 0; j < kWRows; ++j) {
    const long long n = n0 + r_w + j * (kThreads / kChunks);
    w_ok[j] = n < n_total;
    w_row[j] = w + (w_ok[j] ? n * k_total : 0);
  }
  const bool x_copies = tid < MT * kChunks;
  const long long m_x = m0 + r_w;
  const bool x_ok = x_copies && m_x < m_total;
  const int8_t* x_row = x + (x_ok ? m_x * k_total : 0);

  auto load_stage = [&](int stage, int buffer) {
    uint8_t* ws = smem + buffer * Shape<NT>::kStageBytes;
    uint8_t* xs = ws + kRows * kStageK;
    const long long k = begin + static_cast<long long>(stage) * kStageK + 16 * cc;
    const bool k_ok = k < end;  // every bound is a multiple of 16
#pragma unroll
    for (int j = 0; j < kWRows; ++j) {
      const bool ok = w_ok[j] && k_ok;
      cp_async_16(smem_u32(ws + swizzled(r_w + j * (kThreads / kChunks), cc)),
                  ok ? w_row[j] + k : w, ok ? 16 : 0);
    }
    if (x_copies) {
      const bool ok = x_ok && k_ok;
      cp_async_16(smem_u32(xs + swizzled(r_w, cc)), ok ? x_row + k : x, ok ? 16 : 0);
    }
  };

  int acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0;

  // ldmatrix addresses: A, lanes 0-7 / 8-15 / 16-23 / 24-31 give rows 0-7 / 8-15 /
  // 0-7 / 8-15 of the warp's 16 at the step's first / first / second / second chunk
  // (a0..a3 of m16n8k32); B, rows 0-7 of n8 tile j at the first / second chunk (b0,
  // b1), lanes 16-31 the same for tile j + 1
  const int a_row = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_half = lane >> 4;
  const int b_row = (lane & 7) + (NT > 1 ? 8 * (lane >> 4) : 0);
  const int b_half = (lane >> 3) & 1;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_stages) load_stage(st, st);
    cp_async_commit();
  }
  for (int st = 0; st < n_stages; ++st) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage st is in; every warp is done with stage st - 1's buffer
    const int ahead = st + kStages - 1;
    if (ahead < n_stages) load_stage(ahead, ahead % kStages);
    cp_async_commit();

    const uint8_t* ws = smem + (st % kStages) * Shape<NT>::kStageBytes;
    const uint8_t* xs = ws + kRows * kStageK;
#pragma unroll
    for (int ks = 0; ks < kStageK / 32; ++ks) {
      unsigned a[4];
      ldmatrix_x4(a, smem_u32(ws + swizzled(a_row, 2 * ks + a_half)));
      unsigned b[NT][2];
      if (NT == 1) {
        ldmatrix_x2(b[0], smem_u32(xs + swizzled(b_row, 2 * ks + b_half)));
      } else {
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          unsigned r[4];
          ldmatrix_x4(r, smem_u32(xs + swizzled(8 * j + b_row, 2 * ks + b_half)));
          b[j][0] = r[0];
          b[j][1] = r[1];
          b[(j + 1) % NT][0] = r[2];
          b[(j + 1) % NT][1] = r[3];
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_s8(acc[j], a, b[j][0], b[j][1]);
    }
  }
  cp_async_wait<0>();

  // d0, d1: weight row g of the warp's 16, frames 2 t and 2 t + 1 of tile j; d2, d3: row g + 8
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long n = n0 + warp * 16 + g + (i >= 2 ? 8 : 0);
      const long long m = m0 + 8 * j + 2 * t + (i & 1);
      if (n < n_total && m < m_total) {
        int* p = out + (static_cast<long long>(c) * m_total + m) * n_total + n;
        if (atomic)
          atomicAdd(reinterpret_cast<unsigned*>(p), static_cast<unsigned>(acc[j][i]));
        else
          *p = acc[j][i];
      }
    }
  }
}

struct Resident {
  bool ready[3];
  int blocks_per_sm[3];
  int sms;
};
Resident g_resident[kMaxDevices];

template <int NT>
cudaError_t prepare(int device, int slot, Resident& res) {
  if (res.ready[slot]) return cudaSuccess;
  cudaError_t rc = cudaFuncSetAttribute(i8mma_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        Shape<NT>::kSmemBytes);
  if (rc != cudaSuccess) return rc;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&res.blocks_per_sm[slot], i8mma_kernel<NT>,
                                                     kThreads, Shape<NT>::kSmemBytes);
  if (rc != cudaSuccess) return rc;
  if (res.blocks_per_sm[slot] < 1) return cudaErrorInvalidConfiguration;
  rc = cudaDeviceGetAttribute(&res.sms, cudaDevAttrMultiProcessorCount, device);
  if (rc != cudaSuccess) return rc;
  res.ready[slot] = true;
  return cudaSuccess;
}

template <int NT>
cudaError_t launch(const int8_t* x, const int8_t* w, int* out, int m, int n, long long k_total,
                   long long k0, long long k1, long long chunk, cudaStream_t stream) {
  int device = 0;
  cudaError_t rc = cudaGetDevice(&device);
  if (rc != cudaSuccess) return rc;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  const int slot = NT == 1 ? 0 : NT == 2 ? 1 : 2;
  Resident& res = g_resident[device];
  rc = prepare<NT>(device, slot, res);
  if (rc != cudaSuccess) return rc;

  const long long span = k1 - k0;
  const long long chunks = (span + chunk - 1) / chunk;
  const long long full_stages = (chunk + kStageK - 1) / kStageK;
  const long long last_stages = (span - (chunks - 1) * chunk + kStageK - 1) / kStageK;
  const long long total_stages = (chunks - 1) * full_stages + last_stages;
  const long long n_tiles = (n + kRows - 1) / kRows;
  const long long m_tiles = (m + Shape<NT>::kTileM - 1) / Shape<NT>::kTileM;
  const long long target = static_cast<long long>(res.sms) * res.blocks_per_sm[slot] * kWaves;
  const long long want_splits = (target + n_tiles * m_tiles - 1) / (n_tiles * m_tiles);
  long long split_stages = full_stages;
  if (want_splits > chunks) {
    split_stages = (total_stages + want_splits - 1) / want_splits;
    if (split_stages < kMinSplitStages) split_stages = kMinSplitStages;
    if (split_stages > full_stages) split_stages = full_stages;
  }
  long long per_chunk, grid_y;
  for (;;) {
    per_chunk = (full_stages + split_stages - 1) / split_stages;
    grid_y = (chunks - 1) * per_chunk + (last_stages + split_stages - 1) / split_stages;
    if (grid_y <= kMaxGridYZ || split_stages >= full_stages) break;
    split_stages = split_stages * 2 < full_stages ? split_stages * 2 : full_stages;
  }
  if (grid_y > kMaxGridYZ || m_tiles > kMaxGridYZ || n_tiles >= (1LL << 31))
    return cudaErrorInvalidValue;
  const int atomic = grid_y > chunks;  // some chunk has more than one split
  if (atomic) {
    rc = cudaMemsetAsync(out, 0, sizeof(int) * static_cast<size_t>(chunks) * m * n, stream);
    if (rc != cudaSuccess) return rc;
  }
  const dim3 grid(static_cast<unsigned>(n_tiles), static_cast<unsigned>(grid_y),
                  static_cast<unsigned>(m_tiles));
  i8mma_kernel<NT><<<grid, kThreads, Shape<NT>::kSmemBytes, stream>>>(
      x, w, out, m, n, k_total, k0, k1, chunk, split_stages * kStageK,
      static_cast<int>(per_chunk), atomic);
  return cudaGetLastError();
}

}  // namespace

// x (m, k_total) and w (n, k_total) int8, row-major, both on 16-byte boundaries;
// out (C, m, n) int32 with C = ceil((k1 - k0) / chunk): slice c is the product over
// [k0 + c chunk, min(k0 + (c + 1) chunk, k1)). k_total, k0, k1 and chunk are
// multiples of 16 (a chunk longer than the range is the range). Zeroes out where
// the splits meet in atomics, then launches once; returns the CUDA error code
// (cudaErrorInvalidValue for what ops/int8_gemm.py::int8_gemm_arrangement excludes).
extern "C" int i8mma_launch(const void* x, const void* w, void* out, int m, int n,
                            long long k_total, long long k0, long long k1, long long chunk,
                            void* stream) {
  if (m <= 0 || n <= 0 || k_total <= 0 || k0 < 0 || k1 <= k0 || k1 > k_total || chunk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (chunk > k1 - k0) chunk = k1 - k0;
  if (k_total % 16 || k0 % 16 || k1 % 16 || chunk % 16 ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(w) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int8_t* xp = static_cast<const int8_t*>(x);
  const int8_t* wp = static_cast<const int8_t*>(w);
  int* op = static_cast<int*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t rc;
  if (m <= 8) rc = launch<1>(xp, wp, op, m, n, k_total, k0, k1, chunk, s);
  else if (m <= 16) rc = launch<2>(xp, wp, op, m, n, k_total, k0, k1, chunk, s);
  else rc = launch<4>(xp, wp, op, m, n, k_total, k0, k1, chunk, s);
  return static_cast<int>(rc);
}

extern "C" const char* i8mma_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
