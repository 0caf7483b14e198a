// Rotary position embedding (rotate-half) of q and k for Hopper (sm_90a).
//
// rope_qk_kernel replaces both TPU kernels of paddle_tpu/ops/pallas/rope.py:
// `_rope_kernel` (via `_apply`: contiguous positions, cos/sin [s, d], token t
// of a row takes table row t) and `_rope_packed_kernel` (via
// `_apply_packed`: per-token positions pos [b, s] into cos/sin tables
// [P, d], clamped to [0, P-1]). Both compute
//     out = x * cos + sign * rot(x) * sin,   rot(x) = [-x2, x1],
// each product and the sum rounded in fp32 as the plain version rounds them
// (no fused multiply-add), then cast once to x's dtype; sign -1 is the
// transposed rotation, the backward of either. The tables are general fp32
// [rows, d]: their two halves need not be equal. fp32, bf16 and fp16.
//
// What bounds it on the H100: bytes, and at decode's few tokens the host.
// Each element of q and k is read once and written once with 3 flops. One
// launch rotates both q [tokens, hq, d] and k [tokens, hkv, d] (hq != hkv
// under GQA), so a layer costs the host one call, not two. The design:
//   * a thread owns one column slice c of 4 elements of the half-row: it
//     loads the token's cos and sin values of slice c in both halves once
//     (fp32, 16 values, through the read-only path; the table is read once
//     a token from device memory and from L1/L2 after) and keeps them in
//     registers for every head it rotates, of q and of k;
//   * x1 and x2 of a head's slice are one vector each (16 bytes of fp32, 8
//     bytes of bf16 or fp16), so the rotate-half pair sits in one thread's
//     registers with no shuffle, and both are stored as vectors;
//     neighbouring threads take neighbouring slices and heads, so a warp's
//     loads and stores are whole lines. (16-byte slices of bf16 held twice
//     the table values in registers, fitted half the blocks on an SM, and
//     ran slower at the training shape: the kernel is bound by the bytes in
//     flight, which the warps an SM carry);
//   * the heads of a token are spread over `hg` threads per slice: as many
//     as keep the launch within the threads the card holds at once (read
//     from the occupancy of this instantiation) and a token within one
//     block. At decode (8 tokens x 64 heads) a thread rotates one or two
//     heads; at training (8192 tokens) one thread rotates every head of a
//     token's slice, and blocks stride over the tokens, one wave of blocks;
//   * the scalar path, one element a "vector", serves every other case:
//     d % 8 != 0, or a tensor or table off its vector's alignment. The
//     entry point chooses before anything launches.
//
// C interface (loaded with ctypes): rope_qk returns cudaGetLastError()
// after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "vec16.cuh"

namespace {

constexpr int kBlock = 256;       // threads a block when a token needs fewer
constexpr int kMaxThreads = 512;  // threads a token at most (one block)
constexpr int kSlice = 4;         // elements a vector on the vector path

// kSlice elements of T as one vector: 16 bytes of fp32, 8 of bf16 or fp16.
template <typename T>
struct Slice {
  using V = uint2;
  static __device__ __forceinline__ void get(const V& v, float* f) {
    f[0] = Vec16Half<T>::lo(v.x);
    f[1] = Vec16Half<T>::hi(v.x);
    f[2] = Vec16Half<T>::lo(v.y);
    f[3] = Vec16Half<T>::hi(v.y);
  }
  static __device__ __forceinline__ V put(const float* f) {
    return make_uint2(Vec16Half<T>::pack(f[0], f[1]),
                      Vec16Half<T>::pack(f[2], f[3]));
  }
};
template <>
struct Slice<float> {
  using V = uint4;
  static __device__ __forceinline__ void get(const V& v, float* f) {
    Vec16<float>::get(v, f);
  }
  static __device__ __forceinline__ V put(const float* f) {
    return Vec16<float>::put(f);
  }
};

// E consecutive fp32 table values from p (16-byte aligned when E % 4 == 0)
// through the read-only path.
template <int E>
__device__ __forceinline__ void load_table(const float* p, float* f) {
  if constexpr (E % 4 == 0) {
#pragma unroll
    for (int i = 0; i < E / 4; ++i) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(p) + i);
      f[4 * i] = v.x;
      f[4 * i + 1] = v.y;
      f[4 * i + 2] = v.z;
      f[4 * i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < E; ++i) f[i] = __ldg(p + i);
  }
}

// grid-stride over tokens, `tpb` tokens a block, ct * hg threads a token:
// thread (slot, h0, c0) rotates slices c0, c0 + ct, ... of heads h0,
// h0 + hg, ... of token blockIdx.x * tpb + slot (+ gridDim.x * tpb, ...).
// Heads [0, hq) are q's, [hq, hq + hkv) k's; q, qo (k, ko) are unused when
// hq (hkv) is 0. pos null: token t takes table row t % s.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kMaxThreads) rope_qk_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const float* __restrict__ cos, const float* __restrict__ sin,
    const int* __restrict__ pos, T* __restrict__ qo, T* __restrict__ ko,
    int tokens, int s, int hq, int hkv, int d, int rows, float sign, int ct,
    int hg, int tpb) {
  using V = typename std::conditional<kVec, typename Slice<T>::V, T>::type;
  constexpr int E = kVec ? kSlice : 1;  // elements a vector
  const int half = d / 2, nv = half / E, heads = hq + hkv;
  const int tpt = ct * hg;
  const int slot = threadIdx.x / tpt, lane = threadIdx.x - slot * tpt;
  const int c0 = lane % ct, h0 = lane / ct;

  auto widen = [](const V& v, float* f) {
    if constexpr (kVec) {
      Slice<T>::get(v, f);
    } else {
      f[0] = to_float(v);
    }
  };
  auto narrow = [](const float* f) -> V {
    if constexpr (kVec) {
      return Slice<T>::put(f);
    } else {
      return from_float<T>(f[0]);
    }
  };

  for (int64_t tok = static_cast<int64_t>(blockIdx.x) * tpb + slot;
       tok < tokens; tok += static_cast<int64_t>(gridDim.x) * tpb) {
    int p;
    if (pos != nullptr) {
      p = min(max(pos[tok], 0), rows - 1);
    } else {
      p = static_cast<int>(tok % s);
    }
    const float* cr = cos + static_cast<int64_t>(p) * d;
    const float* sr = sin + static_cast<int64_t>(p) * d;
    for (int c = c0; c < nv; c += ct) {
      float c1[E], c2[E], s1[E], s2[E];
      load_table<E>(cr + c * E, c1);
      load_table<E>(cr + half + c * E, c2);
      load_table<E>(sr + c * E, s1);
      load_table<E>(sr + half + c * E, s2);
#pragma unroll 2
      for (int h = h0; h < heads; h += hg) {
        const bool is_q = h < hq;
        const int64_t row = is_q ? tok * hq + h : tok * hkv + (h - hq);
        const T* x = (is_q ? q : k) + row * d + c * E;
        T* o = (is_q ? qo : ko) + row * d + c * E;
        float x1[E], x2[E], o1[E], o2[E];
        widen(*reinterpret_cast<const V*>(x), x1);
        widen(*reinterpret_cast<const V*>(x + half), x2);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          // rot = [-x2, x1], times sign (exact): the plain version's
          // x * cos + rot * sin, each operation rounded once
          o1[e] = __fadd_rn(__fmul_rn(x1[e], c1[e]),
                            __fmul_rn(-sign * x2[e], s1[e]));
          o2[e] = __fadd_rn(__fmul_rn(x2[e], c2[e]),
                            __fmul_rn(sign * x1[e], s2[e]));
        }
        *reinterpret_cast<V*>(o) = narrow(o1);
        *reinterpret_cast<V*>(o + half) = narrow(o2);
      }
    }
  }
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 132;
  return n;
}

// Blocks of kBlock threads of this instantiation resident on one SM.
template <typename T, bool kVec>
int blocks_per_sm() {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, rope_qk_kernel<T, kVec>, kBlock, 0) != cudaSuccess ||
      n < 1)
    return 1;
  return n;
}

template <typename T, bool kVec>
cudaError_t launch(const void* q, const void* k, const float* cos,
                   const float* sin, const int* pos, void* qo, void* ko,
                   int tokens, int s, int hq, int hkv, int d, int rows,
                   float sign, cudaStream_t stream) {
  constexpr int E = kVec ? kSlice : 1;
  static const int sms = sm_count();
  static const int per_sm = blocks_per_sm<T, kVec>();
  const int64_t resident = static_cast<int64_t>(sms) * per_sm * kBlock;
  const int nv = d / 2 / E, heads = hq + hkv;
  const int ct = nv < kBlock ? nv : kBlock;  // slice threads a token
  // head threads a slice: double while the launch stays within the threads
  // the card holds at once and a token within one block
  int hg = 1;
  while (hg < heads && 2 * hg * ct <= kMaxThreads &&
         static_cast<int64_t>(tokens) * 2 * hg * ct <= resident)
    hg *= 2;
  if (hg > heads) hg = heads;
  const int tpt = ct * hg;
  const int tpb = tpt >= kBlock ? 1 : kBlock / tpt;  // tokens a block
  const int block = tpb * tpt;
  const int64_t want = (tokens + tpb - 1) / tpb;
  const int64_t cap = resident / block > 0 ? resident / block : 1;
  const int grid = static_cast<int>(want < cap ? want : cap);
  rope_qk_kernel<T, kVec><<<grid, block, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), cos, sin, pos,
      static_cast<T*>(qo), static_cast<T*>(ko), tokens, s, hq, hkv, d, rows,
      sign, ct, hg, tpb);
  return cudaGetLastError();
}

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

template <typename T>
cudaError_t dispatch(bool vec, const void* q, const void* k,
                     const float* cos, const float* sin, const int* pos,
                     void* qo, void* ko, int tokens, int s, int hq, int hkv,
                     int d, int rows, float sign, cudaStream_t stream) {
  if (vec)
    return launch<T, true>(q, k, cos, sin, pos, qo, ko, tokens, s, hq, hkv,
                           d, rows, sign, stream);
  return launch<T, false>(q, k, cos, sin, pos, qo, ko, tokens, s, hq, hkv, d,
                          rows, sign, stream);
}

}  // namespace

// q, qo [tokens, hq, d] and k, ko [tokens, hkv, d] contiguous, tokens = b * s
// (hq or hkv may be 0, and its pointers null); cos, sin fp32 [rows, d]; pos
// int32 [tokens] or null (then token t of a row takes table row t % s, and
// rows >= s); sign 1 or -1; dtype 0 = float32, 1 = bfloat16, 2 = float16
// (q, k and the outputs share it). The vector path where d % 8 == 0, the
// tables are 16-byte aligned and q, k and the outputs are aligned to their
// vector (4 elements: 16 bytes of fp32, 8 of bf16 or fp16); the scalar path
// otherwise.
extern "C" int rope_qk(const void* q, const void* k, const void* cos,
                       const void* sin, const void* pos, void* qo, void* ko,
                       int tokens, int s, int hq, int hkv, int d, int rows,
                       int sign, int dtype, void* stream) {
  if (tokens < 1 || s < 1 || hq < 0 || hkv < 0 || hq + hkv < 1 || d < 2 ||
      d % 2 || rows < 1 || (pos == nullptr && rows < s) ||
      (sign != 1 && sign != -1) || dtype < 0 || dtype > 2 ||
      cos == nullptr || sin == nullptr ||
      (hq > 0 && (q == nullptr || qo == nullptr)) ||
      (hkv > 0 && (k == nullptr || ko == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t vbytes = dtype == 0 ? 16 : 8;
  const bool vec = (d / 2) % kSlice == 0 && aligned(cos, 16) &&
                   aligned(sin, 16) &&
                   (hq == 0 || (aligned(q, vbytes) && aligned(qo, vbytes))) &&
                   (hkv == 0 || (aligned(k, vbytes) && aligned(ko, vbytes)));
  const float* c = static_cast<const float*>(cos);
  const float* sn = static_cast<const float*>(sin);
  const int* p = static_cast<const int*>(pos);
  const float sg = static_cast<float>(sign);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch<float>(vec, q, k, c, sn, p, qo, ko, tokens, s, hq, hkv, d,
                          rows, sg, st);
  else if (dtype == 1)
    err = dispatch<__nv_bfloat16>(vec, q, k, c, sn, p, qo, ko, tokens, s, hq,
                                  hkv, d, rows, sg, st);
  else
    err = dispatch<__half>(vec, q, k, c, sn, p, qo, ko, tokens, s, hq, hkv, d,
                           rows, sg, st);
  return static_cast<int>(err);
}
