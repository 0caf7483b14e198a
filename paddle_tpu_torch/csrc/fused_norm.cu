// RMSNorm forward for Hopper (sm_90a).
//
// rms_fwd_kernel replaces the TPU kernel paddle_tpu/ops/pallas/fused_norm.py
// `_fwd_kernel` (launched by `_run_fwd`): over the last axis of x [n, d],
// rstd = rsqrt(mean(x^2) + eps) and y = x * rstd * w, statistics and
// products in fp32, y cast once to x's dtype, and the fp32 rstd of each row
// stored where asked (the backward reads it). fp32, bf16 and fp16.
//
// What bounds it on the H100: bytes. It reads each row once and writes it
// once with ~4 flops an element. At training's 8192 rows of 4096 that is
// the time; at decode's 8 rows the device work is a few microseconds and a
// call costs what the host spends launching it, which the Python wrapper
// keeps short. The design:
//   * a row is read from device memory once: each thread keeps its share
//     of x and of w in registers as kVecPerThread 16-byte vectors across
//     the reduction (squares summed in fp32 in vector order, then a warp
//     shuffle, then one shared-memory step over the row's warps, summed in
//     warp order), and stores y as 16-byte vectors; a row wider than 1024
//     threads' registers hold reads the rest a second time, from L2;
//   * one row a block, of the fewest whole warps whose registers hold it
//     (several rows a block timed no faster at 8 or 8192 rows);
//   * the scalar path, one element a "vector", serves every other case
//     (d * itemsize % 16 != 0, a tensor off 16-byte alignment, a weight of
//     another dtype); the entry point chooses before anything launches.
//
// C interface (loaded with ctypes): rms_norm_fwd returns cudaGetLastError()
// after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "vec16.cuh"

namespace {

constexpr int kVecPerThread = 4;  // vectors of x (and of w) a thread keeps
constexpr int kMaxThreads = 1024;

// grid (n), block (threads a row); the threads of a row are whole warps.
// rstd may be null.
template <typename T, typename W, bool kVec>
__global__ void __launch_bounds__(kMaxThreads) rms_fwd_kernel(
    const T* __restrict__ x, const W* __restrict__ w, T* __restrict__ y,
    float* __restrict__ rstd, int d, float eps) {
  static_assert(!kVec || std::is_same<T, W>::value,
                "the vector path takes w in x's dtype");
  using XV = typename std::conditional<kVec, uint4, T>::type;
  using WV = typename std::conditional<kVec, uint4, W>::type;
  constexpr int E = kVec ? Vec16<T>::E : 1;  // elements a vector
  __shared__ float part[kMaxThreads / 32];   // one partial sum a warp

  const int tpr = blockDim.x, wpr = tpr >> 5;
  const int64_t row = blockIdx.x;
  const int nv = d / E;                      // vectors in the row
  const XV* xr = reinterpret_cast<const XV*>(x + row * d);
  const WV* wr = reinterpret_cast<const WV*>(w);
  XV* yr = reinterpret_cast<XV*>(y + row * d);

  auto widen = [](const auto& v, float* f) {
    if constexpr (kVec) {
      Vec16<T>::get(v, f);
    } else {
      f[0] = to_float(v);
    }
  };

  XV xv[kVecPerThread];
  WV wv[kVecPerThread];
#pragma unroll
  for (int i = 0; i < kVecPerThread; ++i) {
    const int c = threadIdx.x + i * tpr;
    if (c < nv) {
      xv[i] = xr[c];
      wv[i] = wr[c];
    }
  }
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < kVecPerThread; ++i) {
    if (threadIdx.x + i * tpr < nv) {
      float f[E];
      widen(xv[i], f);
#pragma unroll
      for (int e = 0; e < E; ++e) ss = fmaf(f[e], f[e], ss);
    }
  }
  for (int c = threadIdx.x + kVecPerThread * tpr; c < nv; c += tpr) {
    float f[E];
    widen(xr[c], f);
#pragma unroll
    for (int e = 0; e < E; ++e) ss = fmaf(f[e], f[e], ss);
  }
  ss = warp_sum(ss);
  if (wpr > 1) {  // uniform over the block
    if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = ss;
    __syncthreads();
    ss = 0.f;
    for (int k = 0; k < wpr; ++k) ss += part[k];
  }
  const float r = rsqrtf(ss / d + eps);
  if (rstd != nullptr && threadIdx.x == 0) rstd[row] = r;

  auto scale = [&](const XV& xa, const WV& wa) -> XV {
    float f[E], g[E];
    widen(xa, f);
    widen(wa, g);
#pragma unroll
    for (int e = 0; e < E; ++e) f[e] = f[e] * r * g[e];
    if constexpr (kVec) {
      return Vec16<T>::put(f);
    } else {
      return from_float<T>(f[0]);
    }
  };
#pragma unroll
  for (int i = 0; i < kVecPerThread; ++i) {
    const int c = threadIdx.x + i * tpr;
    if (c < nv) yr[c] = scale(xv[i], wv[i]);
  }
  for (int c = threadIdx.x + kVecPerThread * tpr; c < nv; c += tpr)
    yr[c] = scale(xr[c], wr[c]);
}

// The threads of a row: the fewest whole warps whose kVecPerThread
// vectors each hold the row's `vectors`, at most kMaxThreads.
int threads_per_row(int vectors) {
  const int t = (vectors + kVecPerThread - 1) / kVecPerThread;
  const int warps = (t + 31) / 32;
  return warps < 1 ? 32 : warps * 32 > kMaxThreads ? kMaxThreads : warps * 32;
}

template <typename T, typename W, bool kVec>
cudaError_t launch(const void* x, const void* w, void* y, float* rstd, int n,
                   int d, float eps, cudaStream_t s) {
  constexpr int E = kVec ? Vec16<T>::E : 1;
  rms_fwd_kernel<T, W, kVec><<<n, threads_per_row(d / E), 0, s>>>(
      static_cast<const T*>(x), static_cast<const W*>(w), static_cast<T*>(y),
      rstd, d, eps);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

size_t itemsize(int dtype) { return dtype == 0 ? 4 : 2; }

template <typename T, typename W>
cudaError_t dispatch_w(bool vec, const void* x, const void* w, void* y,
                       float* rstd, int n, int d, float eps, cudaStream_t s) {
  if constexpr (std::is_same<T, W>::value) {
    if (vec) return launch<T, W, true>(x, w, y, rstd, n, d, eps, s);
  }
  return launch<T, W, false>(x, w, y, rstd, n, d, eps, s);
}

template <typename T>
cudaError_t dispatch(bool vec, int wdtype, const void* x, const void* w,
                     void* y, float* rstd, int n, int d, float eps,
                     cudaStream_t s) {
  if (wdtype == 0)
    return dispatch_w<T, float>(vec, x, w, y, rstd, n, d, eps, s);
  if (wdtype == 1)
    return dispatch_w<T, __nv_bfloat16>(vec, x, w, y, rstd, n, d, eps, s);
  return dispatch_w<T, __half>(vec, x, w, y, rstd, n, d, eps, s);
}

}  // namespace

// x, y [n, d] contiguous, w [d], rstd [n] fp32 or null; dtype and wdtype:
// 0 = float32, 1 = bfloat16, 2 = float16 (x and y share dtype). The vector
// path where w has x's dtype, d * itemsize % 16 == 0 and x, w, y are
// 16-byte aligned; the scalar path otherwise.
extern "C" int rms_norm_fwd(const void* x, const void* w, void* y,
                            void* rstd, int n, int d, float eps, int dtype,
                            int wdtype, void* stream) {
  if (n < 1 || d < 1 || dtype < 0 || dtype > 2 || wdtype < 0 || wdtype > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = wdtype == dtype && d * itemsize(dtype) % 16 == 0 &&
                   aligned16(x) && aligned16(w) && aligned16(y);
  float* r = static_cast<float*>(rstd);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch<float>(vec, wdtype, x, w, y, r, n, d, eps, s);
  else if (dtype == 1)
    err = dispatch<__nv_bfloat16>(vec, wdtype, x, w, y, r, n, d, eps, s);
  else
    err = dispatch<__half>(vec, wdtype, x, w, y, r, n, d, eps, s);
  return static_cast<int>(err);
}
