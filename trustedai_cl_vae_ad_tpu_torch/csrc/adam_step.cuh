// The Adam step of the dense-update kernels, shared by csrc/dense_grad_adam.cu (the CUDA-core
// tile kernels and the streaming epilogues, kernels 4-9) and csrc/dense_grad_adam_wgmma.cu (kernels
// 4 and 5 on the tensor cores), so that both compute it with the same code: the fused tensor-core
// kernel equals the streaming epilogue applied to the product, bit for bit, by construction.
//
// Element access (float32 in registers, T in memory, 16-byte vectors) and the step itself:
// adam_f32 is adam_epilogue of benchmarks/r11_kernel.py in float32, adam_bf16 is epi_bf16 of
// benchmarks/r11_diag.py. Every operation rounds once (__fmul_rn and friends; the sources are
// built with --fmad=false), in the order of the plain PyTorch versions.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace adam_step {

struct AdamScalars {
  float lr, b1, b2, eps, bc1, bc2;
};

// ---- element access: float32 in registers, T in memory -------------------------------------

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// 32-bit words of memory <-> E elements as float32 (a word holds one float or two bf16,
// the lower address in the lower half)
template <typename T, int E>
struct Words {
  static constexpr int kCount = E * static_cast<int>(sizeof(T)) / 4;
};
template <typename T>
struct Tag {};

template <int E>
__device__ __forceinline__ void unpack(const unsigned (&words)[Words<float, E>::kCount],
                                       float (&out)[E], Tag<float>) {
#pragma unroll
  for (int i = 0; i < E; ++i) out[i] = __uint_as_float(words[i]);
}
template <int E>
__device__ __forceinline__ void unpack(const unsigned (&words)[Words<__nv_bfloat16, E>::kCount],
                                       float (&out)[E], Tag<__nv_bfloat16>) {
#pragma unroll
  for (int i = 0; i < E / 2; ++i) {
    out[2 * i] = __uint_as_float(words[i] << 16);
    out[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
  }
}
template <int E>
__device__ __forceinline__ void pack(const float (&in)[E],
                                     unsigned (&words)[Words<float, E>::kCount], Tag<float>) {
#pragma unroll
  for (int i = 0; i < E; ++i) words[i] = __float_as_uint(in[i]);
}
template <int E>
__device__ __forceinline__ void pack(const float (&in)[E],
                                     unsigned (&words)[Words<__nv_bfloat16, E>::kCount],
                                     Tag<__nv_bfloat16>) {
#pragma unroll
  for (int i = 0; i < E / 2; ++i) {
    const unsigned lo = __bfloat16_as_ushort(__float2bfloat16_rn(in[2 * i]));
    const unsigned hi = __bfloat16_as_ushort(__float2bfloat16_rn(in[2 * i + 1]));
    words[i] = lo | (hi << 16);
  }
}

// E contiguous elements at p, which is aligned to min(16, E * sizeof(T)) bytes
template <typename T, int E>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[E]) {
  constexpr int kWords = Words<T, E>::kCount;
  static_assert(kWords == 2 || kWords % 4 == 0, "8 bytes or a multiple of 16");
  unsigned words[kWords];
  if constexpr (kWords == 2) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    words[0] = v.x;
    words[1] = v.y;
  } else {
#pragma unroll
    for (int c = 0; c < kWords / 4; ++c) {
      const uint4 v = reinterpret_cast<const uint4*>(p)[c];
      words[4 * c] = v.x;
      words[4 * c + 1] = v.y;
      words[4 * c + 2] = v.z;
      words[4 * c + 3] = v.w;
    }
  }
  unpack<E>(words, out, Tag<T>());
}

template <typename T, int E>
__device__ __forceinline__ void store_vec(T* p, const float (&in)[E]) {
  constexpr int kWords = Words<T, E>::kCount;
  static_assert(kWords == 2 || kWords % 4 == 0, "8 bytes or a multiple of 16");
  unsigned words[kWords];
  pack<E>(in, words, Tag<T>());
  if constexpr (kWords == 2) {
    *reinterpret_cast<uint2*>(p) = make_uint2(words[0], words[1]);
  } else {
#pragma unroll
    for (int c = 0; c < kWords / 4; ++c)
      reinterpret_cast<uint4*>(p)[c] =
          make_uint4(words[4 * c], words[4 * c + 1], words[4 * c + 2], words[4 * c + 3]);
  }
}

// ---- the step ------------------------------------------------------------------------------

// adam_epilogue of benchmarks/r11_kernel.py in float32; the caller rounds w, mu, nu to T.
// Every operation rounds once (no contraction), in the order of the plain PyTorch version.
template <typename T>
__device__ __forceinline__ void adam_f32(float g32, float& w, float& mu, float& nu,
                                         const AdamScalars& s, float omb1, float omb2) {
  const float g = to_f32(from_f32<T>(g32));  // the gradient of a T parameter is a T
  const float mu_n = __fadd_rn(__fmul_rn(s.b1, mu), __fmul_rn(omb1, g));
  const float nu_n = __fadd_rn(__fmul_rn(s.b2, nu), __fmul_rn(omb2, __fmul_rn(g, g)));
  const float m_hat = __fdiv_rn(mu_n, s.bc1);
  const float v_hat = __fdiv_rn(nu_n, s.bc2);
  const float upd = __fdiv_rn(__fmul_rn(s.lr, m_hat), __fadd_rn(__fsqrt_rn(v_hat), s.eps));
  w = __fsub_rn(w, upd);
  mu = mu_n;
  nu = nu_n;
}

// epi_bf16 of benchmarks/r11_diag.py: the scalars cast to bf16 (by the caller: `s` holds
// bf16 values, omb1 and omb2 the bf16 differences) and every operation rounded to bf16.
__device__ __forceinline__ void adam_bf16(float g, float& w, float& mu, float& nu,
                                          const AdamScalars& s, float omb1, float omb2) {
  const float mu_n = round_bf16(
      __fadd_rn(round_bf16(__fmul_rn(s.b1, mu)), round_bf16(__fmul_rn(omb1, g))));
  const float gg = round_bf16(__fmul_rn(g, g));
  const float nu_n = round_bf16(
      __fadd_rn(round_bf16(__fmul_rn(s.b2, nu)), round_bf16(__fmul_rn(omb2, gg))));
  const float m_hat = round_bf16(__fdiv_rn(mu_n, s.bc1));
  const float v_hat = round_bf16(__fdiv_rn(nu_n, s.bc2));
  const float num = round_bf16(__fmul_rn(s.lr, m_hat));
  const float den = round_bf16(__fadd_rn(round_bf16(__fsqrt_rn(v_hat)), s.eps));
  const float upd = round_bf16(__fdiv_rn(num, den));
  w = __fsub_rn(w, upd);  // rounded to bf16 where it is stored
  mu = mu_n;
  nu = nu_n;
}

template <bool BF16>
struct StepScalars {
  AdamScalars s;
  float omb1, omb2;
  __device__ explicit StepScalars(const AdamScalars& in) : s(in) {
    if (BF16) {
      s.lr = round_bf16(in.lr);
      s.b1 = round_bf16(in.b1);
      s.b2 = round_bf16(in.b2);
      s.eps = round_bf16(in.eps);
      s.bc1 = round_bf16(in.bc1);
      s.bc2 = round_bf16(in.bc2);
      omb1 = round_bf16(__fsub_rn(1.0f, s.b1));
      omb2 = round_bf16(__fsub_rn(1.0f, s.b2));
    } else {
      omb1 = __fsub_rn(1.0f, in.b1);
      omb2 = __fsub_rn(1.0f, in.b2);
    }
  }
  template <typename T>
  __device__ __forceinline__ void apply(float g, float& w, float& mu, float& nu) const {
    if (BF16) adam_bf16(g, w, mu, nu, s, omb1, omb2);
    else adam_f32<T>(g, w, mu, nu, s, omb1, omb2);
  }
};

}  // namespace adam_step
