// Ragged paged decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/paged_attention.py
// `_decode_kernel` (launched by `_paged_pallas`): one query token per slot
// against a paged KV pool, addressed through the slot's block table and
// context length, fp32 online softmax, split-K partials combined by
// logsumexp weighting.
//
// What bounds it on the H100: bytes. A decode step reads every live K and V
// row of every slot once (context x kv_heads x head_dim x 2 x itemsize) and
// does 4 flops per element read, far below the ~295 flops per byte at which
// the tensor cores would become the limit. The design follows from that:
//   * one block per (slot, kv_head, split) reads its own block-table row and
//     context length (the TPU's scalar prefetch) and walks only the live
//     context, so pages past a slot's length are never read;
//   * the g = q_heads / kv_heads query rows of a kv head share one block, so
//     each K/V row is read from device memory once for all g heads (GQA);
//   * K rows are read by one warp per token with neighbouring lanes on
//     neighbouring elements (coalesced), V rows by all threads across the
//     head dimension (coalesced);
//   * split-K over each slot's live context (splits > 1) adds blocks when
//     slots x kv_heads is small against the 132 SMs and shortens the walk of
//     the longest slot, which otherwise sets the step's time; the Python
//     wrapper chooses the count. A second small kernel combines the splits
//     as the TPU's XLA epilogue does.
// This first version keeps each tile's scores in shared memory and does the
// q.k and p.v products on the CUDA cores in fp32; staging K/V tiles through
// shared memory with cp.async/TMA and mma is later work.
//
// C interface (loaded with ctypes): paged_attention_decode returns
// cudaGetLastError() after its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;  // context tokens per tile (one per lane in softmax)
constexpr int kMaxG = 8;
constexpr int kMaxD = 256;
constexpr int kAccPerThread = kMaxG * kMaxD / kThreads;
constexpr float kNegInf = -1e30f;  // the reference's NEG_INF

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// grid (slots, kv_heads, splits), kThreads threads.
// splits == 1: writes the normalised output to `out` [slots, hq, d].
// splits > 1: writes unnormalised partials acc [slots, hkv, splits, g, d]
// and (m, l) [slots, hkv, splits, g, 2] for paged_combine_kernel.
template <typename T>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* __restrict__ block_tables,
    const int* __restrict__ context_lens, T* __restrict__ out,
    float* __restrict__ part_acc, float* __restrict__ part_ml, int hkv,
    int g, int d, int block_size, int max_blocks, int splits, float scale) {
  const int slot = blockIdx.x, h = blockIdx.y, split = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hq = hkv * g;
  const int gd = g * d;

  __shared__ float q_s[kMaxG * kMaxD];
  __shared__ float p_s[kMaxG][kTile];
  __shared__ float alpha_s[kMaxG];
  __shared__ float m_s[kMaxG];
  __shared__ float l_s[kMaxG];
  __shared__ int64_t row_s[kTile];  // element offset of (page, off, h, 0)

  // The slot's own live context (never past its table) is cut into `splits`
  // runs of whole tiles, so every split of a long slot walks an equal share
  // and the splits of a short slot past its context do nothing.
  const int ctx = min(context_lens[slot], max_blocks * block_size);
  const int tiles_per_split = ((ctx + kTile - 1) / kTile + splits - 1) / splits;
  const int tok_begin = split * tiles_per_split * kTile;
  const int tok_end = min(ctx, tok_begin + tiles_per_split * kTile);

  const T* q_rows = q + ((int64_t)slot * hq + (int64_t)h * g) * d;
  for (int e = tid; e < gd; e += kThreads) q_s[e] = to_float(q_rows[e]) * scale;
  if (tid < kMaxG) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[kAccPerThread];
#pragma unroll
  for (int i = 0; i < kAccPerThread; ++i) acc[i] = 0.f;
  __syncthreads();

  const int* table = block_tables + (int64_t)slot * max_blocks;
  const int64_t tok_stride = (int64_t)hkv * d;

  for (int t0 = tok_begin; t0 < tok_end; t0 += kTile) {
    const int n = min(kTile, tok_end - t0);
    if (tid < kTile) {
      int64_t row = 0;
      if (tid < n) {
        const int pos = t0 + tid;
        const int64_t blk = table[pos / block_size];
        row = (blk * block_size + pos % block_size) * tok_stride +
              (int64_t)h * d;
      }
      row_s[tid] = row;
    }
    __syncthreads();

    // scores q.k: one warp per token, lanes across the head dimension
    for (int t = warp; t < n; t += kWarps) {
      const T* krow = k_pages + row_s[t];
      float part[kMaxG];
#pragma unroll
      for (int r = 0; r < kMaxG; ++r) part[r] = 0.f;
      for (int e = lane; e < d; e += 32) {
        const float kv = to_float(krow[e]);
#pragma unroll
        for (int r = 0; r < kMaxG; ++r)
          if (r < g) part[r] += q_s[r * d + e] * kv;
      }
#pragma unroll
      for (int r = 0; r < kMaxG; ++r) {
        if (r < g) {
          const float s = warp_sum(part[r]);
          if (lane == 0) p_s[r][t] = s;
        }
      }
    }
    __syncthreads();

    // online softmax: one warp per query row, one lane per token
    for (int r = warp; r < g; r += kWarps) {
      const float s = lane < n ? p_s[r][lane] : kNegInf;
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(s));
      const float p = lane < n ? expf(s - m_new) : 0.f;
      const float l_add = warp_sum(p);
      p_s[r][lane] = p;
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        alpha_s[r] = alpha;
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + l_add;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p.v: each thread owns elements tid + i*kThreads
#pragma unroll
    for (int i = 0; i < kAccPerThread; ++i) {
      const int e = tid + i * kThreads;
      if (e < gd) {
        const int r = e / d, c = e - r * d;
        float a = acc[i] * alpha_s[r];
        for (int t = 0; t < n; ++t)
          a += p_s[r][t] * to_float(v_pages[row_s[t] + c]);
        acc[i] = a;
      }
    }
    __syncthreads();
  }

  if (splits == 1) {
    T* o = out + ((int64_t)slot * hq + (int64_t)h * g) * d;
#pragma unroll
    for (int i = 0; i < kAccPerThread; ++i) {
      const int e = tid + i * kThreads;
      if (e < gd) store(o + e, acc[i] / fmaxf(l_s[e / d], 1e-30f));
    }
  } else {
    const int64_t part = ((int64_t)slot * hkv + h) * splits + split;
    float* pa = part_acc + part * gd;
#pragma unroll
    for (int i = 0; i < kAccPerThread; ++i) {
      const int e = tid + i * kThreads;
      if (e < gd) pa[e] = acc[i];
    }
    if (tid < g) {
      part_ml[(part * g + tid) * 2] = m_s[tid];
      part_ml[(part * g + tid) * 2 + 1] = l_s[tid];
    }
  }
}

// grid (slots, kv_heads): logsumexp-weighted sum of the split partials, as
// the reference's epilogue (paged_attention.py:156-161).
template <typename T>
__global__ void __launch_bounds__(kThreads) paged_combine_kernel(
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    T* __restrict__ out, int hkv, int g, int d, int splits) {
  const int slot = blockIdx.x, h = blockIdx.y;
  const int gd = g * d;
  const int64_t base = ((int64_t)slot * hkv + h) * splits;
  T* o = out + ((int64_t)slot * hkv * g + (int64_t)h * g) * d;
  for (int e = threadIdx.x; e < gd; e += kThreads) {
    const int r = e / d;
    float m_g = kNegInf;
    for (int s = 0; s < splits; ++s)
      m_g = fmaxf(m_g, part_ml[((base + s) * g + r) * 2]);
    float num = 0.f, den = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float w = expf(part_ml[((base + s) * g + r) * 2] - m_g);
      num += part_acc[(base + s) * gd + e] * w;
      den += part_ml[((base + s) * g + r) * 2 + 1] * w;
    }
    store(o + e, num / fmaxf(den, 1e-30f));
  }
}

template <typename T>
void launch(const void* q, const void* k_pages, const void* v_pages,
            const int* block_tables, const int* context_lens, void* out,
            float* part_acc, float* part_ml, int slots, int hkv, int g, int d,
            int block_size, int max_blocks, int splits, float scale,
            cudaStream_t stream) {
  paged_decode_kernel<T><<<dim3(slots, hkv, splits), kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), block_tables, context_lens,
      static_cast<T*>(out), part_acc, part_ml, hkv, g, d, block_size,
      max_blocks, splits, scale);
  if (splits > 1) {
    paged_combine_kernel<T><<<dim3(slots, hkv), kThreads, 0, stream>>>(
        part_acc, part_ml, static_cast<T*>(out), hkv, g, d, splits);
  }
}

}  // namespace

// q [slots, hkv*g, d]; k_pages, v_pages [num_blocks, block_size, hkv, d];
// block_tables [slots, max_blocks] int32; context_lens [slots] int32;
// out [slots, hkv*g, d]; part_acc [slots*hkv*splits*g*d] and
// part_ml [slots*hkv*splits*g*2] fp32 scratch (unused when splits == 1).
// dtype: 0 = float32, 1 = bfloat16. All tensors contiguous, on one device.
extern "C" int paged_attention_decode(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_tables, const void* context_lens, void* out,
    void* part_acc, void* part_ml, int slots, int hkv, int g, int d,
    int block_size, int max_blocks, int splits, float scale, int dtype,
    void* stream) {
  if (slots < 1 || hkv < 1 || g < 1 || g > kMaxG || d < 1 || d > kMaxD ||
      block_size < 1 || max_blocks < 1 || splits < 1 || splits > max_blocks ||
      (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* bt = static_cast<const int*>(block_tables);
  const int* cl = static_cast<const int*>(context_lens);
  float* pa = static_cast<float*>(part_acc);
  float* pml = static_cast<float*>(part_ml);
  if (dtype == 0) {
    launch<float>(q, k_pages, v_pages, bt, cl, out, pa, pml, slots, hkv, g, d,
                  block_size, max_blocks, splits, scale, s);
  } else {
    launch<__nv_bfloat16>(q, k_pages, v_pages, bt, cl, out, pa, pml, slots,
                          hkv, g, d, block_size, max_blocks, splits, scale, s);
  }
  return static_cast<int>(cudaGetLastError());
}
