// A bf16 tensor-core mainloop for Hopper (sm_90a): one block of two warpgroups sums
// A^T B into a 128 x 128 tile of float32 accumulators, where A (K, M) and B (K, N) are
// row-major with M and N contiguous, i.e. both operands are MN-major. With A_K_MAJOR, A is
// given as (M, K) row-major instead (K contiguous, K % 8 == 0): see "K-major A" below.
//
// Loads: cp.async.cg 16-byte copies into a ring of STAGES stages of shared memory, each
// stage 64 rows of K by 128 columns of A and of B (2 x 16 KB). Rows past K and columns
// past M or N are zero-filled through cp.async's src-size, so any K >= 1 is taken; M and N
// must be multiples of 8 (a 16-byte chunk is wholly inside or wholly outside) and both
// base pointers 16-byte aligned.
//
// Layout: the 128-byte swizzle of an MN-major operand that wgmma's descriptors name.
// Each 64 columns of a stage's operand are one "atom column" of 64 rows x 128 bytes
// (8 KB); inside it, row k's 16-byte chunk c sits at k * 128 + ((c ^ (k % 8)) * 16). A
// descriptor (start, LBO, SBO, 128-byte swizzle) reads from it: for an MN-major layout
// with this swizzle, LBO is the distance between atom columns along M or N (8 KB) and SBO
// the distance between groups of 8 rows along K (1 KB). Stages start on 1 KB boundaries,
// so the swizzle's phase is that of the address.
//
// Product: warpgroup w owns rows [64 w, 64 w + 64) of the tile and issues one
// wgmma.mma_async m64n128k16 (dense, f32 += bf16 x bf16, both transpose bits set) per 16
// rows of K: 64 float32 accumulators a thread. K is summed by one block, in one order.
//
// K-major A: a stage's A is 128 rows of M by 64 of K, 128 bytes a row, in the K-major
// 128-byte swizzle: row m's chunk c (8 values of K) at m * 128 + ((c ^ (m % 8)) * 16), so a
// warpgroup's 64 rows are 8 KB from the stage's start as before. Its descriptor has SBO =
// 1024 (8 rows) and LBO unused (16); the k16 steps advance the start by 32 bytes inside the
// swizzle atom, and the instruction's transpose bit for A is 0. Rows past M and chunks past K
// are zero-filled.
//
// Ring: wait for stage kt's copies, fence them into the async proxy, barrier, start the
// copies of stage kt + STAGES - 1 into the slot that stage kt - 1 used, then run stage
// kt's four wgmma and wait for them. The wait at the end of a stage is what frees its
// slot for the copies issued after the next barrier.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace wgmma_bf16 {

constexpr int kThreads = 256;            // two consumer warpgroups
constexpr int kTileM = 128, kTileN = 128, kTileK = 64;
constexpr int kAtomBytes = kTileK * 128;  // one atom column: 64 rows x 128 bytes
constexpr int kOperandBytes = 2 * kAtomBytes;
constexpr int kStageBytes = 2 * kOperandBytes;
constexpr int kAccumulators = 64;  // m64n128 f32: 64 x 128 / 128 threads

template <int STAGES>
constexpr int smem_bytes() {
  return STAGES * kStageBytes + 1024;  // + room to align the ring to 1 KB
}

__device__ __forceinline__ uint32_t smem_address(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset in a stage's operand of the 16-byte chunk c (0..15) of row k (0..63)
__device__ __forceinline__ uint32_t swizzled_offset(int k, int c) {
  return (c >> 3) * kAtomBytes + k * 128 + (((c & 7) ^ (k & 7)) << 4);
}

// 16 bytes from global to shared memory; zeros when !valid (src is then not read)
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the writes of this thread in the generic proxy (cp.async) become visible to wgmma
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// shared-memory matrix descriptor with the 128-byte swizzle; distances in bytes
__device__ __forceinline__ uint64_t make_descriptor(uint32_t address, uint32_t lbo,
                                                    uint32_t sbo) {
  return static_cast<uint64_t>((address & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of the accumulators across the
// asynchronous wgmma that owns them
__device__ __forceinline__ void fence_accumulators(float (&d)[kAccumulators]) {
#pragma unroll
  for (int i = 0; i < kAccumulators; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// the 64 accumulators of m64n128 as "+f" operands %0..%63 of an asm statement
#define WGMMA_BF16_ACCUMULATORS(d)                                                             \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),         \
  "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),     \
  "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),               \
  "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),               \
  "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),               \
  "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),               \
  "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),               \
  "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),               \
  "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),               \
  "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),               \
  "+f"(d[62]), "+f"(d[63])

// d (64 x 128, f32) += A (64 x 16) B (16 x 128), both read MN-major from shared memory
__device__ __forceinline__ void wgmma_m64n128k16_mn(float (&d)[kAccumulators], uint64_t a,
                                                    uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 1, 1;\n"
      "}\n"
      : WGMMA_BF16_ACCUMULATORS(d)
      : "l"(a), "l"(b), "r"(1));
}

// the same with A read K-major (transpose bit 0) and B MN-major
__device__ __forceinline__ void wgmma_m64n128k16_ka(float (&d)[kAccumulators], uint64_t a,
                                                    uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : WGMMA_BF16_ACCUMULATORS(d)
      : "l"(a), "l"(b), "r"(1));
}

// acc += A[:, m0 : m0 + 128]^T B[:, n0 : n0 + 128] over all K rows, A (K, M) and B (K, N)
// row-major bf16; with A_K_MAJOR, A is given as (M, K) row-major (K % 8 == 0) and the same
// sum is taken. Called by all 256 threads of the block; `smem` holds smem_bytes<STAGES>().
// Thread t's accumulator i ends at row 64 (t / 128) + 16 ((t / 32) % 4) + (t % 32) / 4
// + 8 ((i / 2) % 2) and column 8 (i / 4) + 2 (t % 4) + i % 2 of the tile (the wgmma
// fragment of D).
template <int STAGES, bool A_K_MAJOR = false>
__device__ __forceinline__ void mainloop(const __nv_bfloat16* __restrict__ a,
                                         const __nv_bfloat16* __restrict__ b, long long K,
                                         long long M, long long N, long long m0, long long n0,
                                         uint8_t* smem, float (&acc)[kAccumulators]) {
  static_assert(STAGES >= 2, "a ring of at least two stages");
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const uint32_t ring = (smem_address(smem) + 1023u) & ~1023u;
  const int ktiles = static_cast<int>((K + kTileK - 1) / kTileK);

  auto load = [&](int kt) {
    const uint32_t sa = ring + (kt % STAGES) * kStageBytes, sb = sa + kOperandBytes;
    const long long k0 = static_cast<long long>(kt) * kTileK;
#pragma unroll
    for (int i = 0; i < kTileK * 16 / kThreads; ++i) {
      const int id = tid + kThreads * i;
      const int k = id >> 4, c = id & 15;  // a warp takes two whole rows of 256 bytes
      const long long row = k0 + k, nb = n0 + 8 * c;
      const uint32_t off = swizzled_offset(k, c);
      if constexpr (A_K_MAJOR) {
        const int m = id >> 3, ck = id & 7;  // a warp takes four whole rows of 128 bytes
        const long long ra = m0 + m, ka = k0 + 8 * ck;
        const bool va = ra < M && ka < K;
        cp_async_16(sa + m * 128 + ((ck ^ (m & 7)) << 4), va ? a + ra * K + ka : a, va);
      } else {
        const long long ma = m0 + 8 * c;
        const bool va = row < K && ma < M;
        cp_async_16(sa + off, va ? a + row * M + ma : a, va);
      }
      const bool vb = row < K && nb < N;
      cp_async_16(sb + off, vb ? b + row * N + nb : b, vb);
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) load(s);
    cp_async_commit();  // empty groups keep the count of groups uniform
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of stage kt have landed
    fence_proxy_async();
    __syncthreads();  // everyone's copies of kt; everyone done with kt - 1's slot
    if (kt + STAGES - 1 < ktiles) load(kt + STAGES - 1);
    cp_async_commit();
    const uint32_t sa = ring + (kt % STAGES) * kStageBytes + wg * kAtomBytes;
    const uint32_t sb = ring + (kt % STAGES) * kStageBytes + kOperandBytes;
    fence_accumulators(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kTileK / 16; ++ks) {  // 16 rows of K = two groups of 8, 2 KB
      if constexpr (A_K_MAJOR)  // 16 values of K = 32 bytes of each 128-byte row
        wgmma_m64n128k16_ka(acc, make_descriptor(sa + ks * 32, 16, 1024),
                            make_descriptor(sb + ks * 2048, kAtomBytes, 1024));
      else
        wgmma_m64n128k16_mn(acc, make_descriptor(sa + ks * 2048, kAtomBytes, 1024),
                            make_descriptor(sb + ks * 2048, kAtomBytes, 1024));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_accumulators(acc);
  }
}

}  // namespace wgmma_bf16
