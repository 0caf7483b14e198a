// 16 bytes of fp32, bf16 or fp16 elements as floats and back, shared by the
// kernels of this directory that move rows as 16-byte vectors
// (fused_norm.cu, paged_attention.cu; rope.cu packs its 8-byte vectors of
// bf16 and fp16 with Vec16Half's word helpers). A vector is a uint4 in
// registers; Vec16<T>::get widens its E elements to fp32, Vec16<T>::put
// rounds E floats to T (round to nearest even) and packs them. Each source
// includes it once and compiles it into its own library.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float v) {
  return __float2half_rn(v);
}

template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int E = 4;
  static __device__ __forceinline__ void get(const uint4& v, float* f) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
  static __device__ __forceinline__ uint4 put(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

// Two 16-bit elements a 32-bit word, the lower one first (memory order).
template <typename T>
struct Vec16Half {
  static constexpr int E = 8;
  static __device__ __forceinline__ float lo(uint32_t u);
  static __device__ __forceinline__ float hi(uint32_t u);
  static __device__ __forceinline__ uint32_t pack(float a, float b);
  static __device__ __forceinline__ void get(const uint4& v, float* f) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = lo(w[i]);
      f[2 * i + 1] = hi(w[i]);
    }
  }
  static __device__ __forceinline__ uint4 put(const float* f) {
    return make_uint4(pack(f[0], f[1]), pack(f[2], f[3]), pack(f[4], f[5]),
                      pack(f[6], f[7]));
  }
};

template <>
__device__ __forceinline__ float Vec16Half<__nv_bfloat16>::lo(uint32_t u) {
  return __uint_as_float(u << 16);
}
template <>
__device__ __forceinline__ float Vec16Half<__nv_bfloat16>::hi(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}
template <>
__device__ __forceinline__ uint32_t
Vec16Half<__nv_bfloat16>::pack(float a, float b) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(a))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(b)))
          << 16);
}
template <>
__device__ __forceinline__ float Vec16Half<__half>::lo(uint32_t u) {
  return __half2float(__ushort_as_half(static_cast<unsigned short>(u)));
}
template <>
__device__ __forceinline__ float Vec16Half<__half>::hi(uint32_t u) {
  return __half2float(__ushort_as_half(static_cast<unsigned short>(u >> 16)));
}
template <>
__device__ __forceinline__ uint32_t Vec16Half<__half>::pack(float a,
                                                           float b) {
  return static_cast<uint32_t>(__half_as_ushort(__float2half_rn(a))) |
         (static_cast<uint32_t>(__half_as_ushort(__float2half_rn(b))) << 16);
}

template <>
struct Vec16<__nv_bfloat16> : Vec16Half<__nv_bfloat16> {};
template <>
struct Vec16<__half> : Vec16Half<__half> {};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace
