// Ragged paged attention for Hopper (sm_90a): decode and the speculative
// verify window.
//
// paged_decode_ring_kernel replaces the TPU kernel
// paddle_tpu/ops/pallas/paged_attention.py `_decode_kernel` (launched by
// `_paged_pallas`): one query token per slot against a paged KV pool,
// addressed through the slot's block table and context length, fp32 online
// softmax, split-K partials combined by logsumexp weighting.
// paged_verify_kernel and paged_verify_mma_kernel replace `_verify_kernel`
// (launched by `_paged_pallas_multi`): the same walk for a window of sq
// query tokens a slot, causal inside the window (their design notes are
// above them).
//
// What bounds both on the H100: bytes. A decode step reads every live K and V
// row of every slot once (context x kv_heads x head_dim x 2 x itemsize) and
// does 4 flops per element read, far below the ~295 flops per byte at which
// the tensor cores would become the limit. So the kernels keep bytes in
// flight:
//   * one block per (slot, kv_head, split) reads its own block-table row and
//     context length (the TPU's scalar prefetch) and walks only the live
//     context, so pages past a slot's length are never read;
//   * the g = q_heads / kv_heads query rows of a kv head share one block, so
//     each K/V row is read from device memory once for all g heads (GQA);
//   * the block's four warps split its run of the context: each warp finds
//     its own tiles of tokens through the block table and copies their K and
//     V rows by 16-byte cp.async into a private two-stage ring of shared
//     memory, so its next tile is in flight while it computes this one and
//     the walk needs no block barrier; the warps merge (m, l, O) through
//     shared memory at the end (the decode kernel below, and the verify
//     window's tensor-core kernel);
//   * split-K over each slot's live context (splits > 1) adds blocks when
//     slots x kv_heads is small against the 132 SMs and shortens the walk of
//     the longest slot, which otherwise sets the step's time; the Python
//     wrapper chooses the count. A second small kernel combines the splits
//     as the TPU's XLA epilogue does.
// ptxas (sm_90a) for the decode kernel: at d 128 and g 1, 64 registers a
// thread in bf16 and fp16, 48 in fp32; at g 8, 254-255; no spills but 12
// bytes at fp32, d 64, g 2. Its 64 KB of dynamic shared memory (four warps'
// rings) lets 3 blocks share an SM (2 at g 8, by registers).
// The decode kernel moves rows as 16-byte vectors: it serves g <= kMaxG = 8
// query rows a kv head where d * itemsize % 16 == 0 and q, the pages and
// the output are 16-byte aligned. Every other decode step (a larger GQA
// group: 32 heads over 2 kv heads, or MQA; another head_dim or alignment)
// runs the verify kernel as a window of one token whose base is the
// context minus one. The Python wrapper chooses the kernel (`route`) and
// passes it to the entry points, which launch it or, where the arguments
// do not meet its needs, refuse before anything launches.
//
// Types: fp32, bf16 and fp16 on the CUDA-core kernels, which compute in
// fp32; the bf16 verify window on the tensor cores where head_dim % 8 ==
// 0 and q, the pages and the output are 16-byte aligned.
//
// C interface (loaded with ctypes): paged_attention_decode and
// paged_attention_verify return cudaGetLastError() after their launches.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"
#include "vec16.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;  // CUDA-core verify: tokens a tile, one a lane
constexpr int kMaxG = 8;
constexpr int kMaxD = 256;
constexpr float kNegInf = -1e30f;  // the reference's NEG_INF

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ void store(__half* p, float v) {
  *p = __float2half_rn(v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ---------------------------------------------------------------- decode
// The decode step's layout. A warp's tile of K (or V) is kRingTileBytes: 16
// tokens of a bf16 or fp16 d-128 row, 8 of an fp32 one. A row is CH
// 16-byte chunks; LPT lanes hold one token's row (JC chunks each), so one
// pass of the warp covers TPP tokens and NP passes a tile. d 128 bf16: 16
// lanes a token, 2 tokens a pass, 8 passes; fp32: 32 lanes, 1 token, 8.
constexpr int kRingTileBytes = 4096;
constexpr size_t kRingSmem = (size_t)kWarps * 2 * 2 * kRingTileBytes;

template <typename T, int D>
struct Ring {
  static constexpr int E = Vec16<T>::E;  // elements a chunk
  static constexpr int CH = D / E;       // chunks a row
  static constexpr int TOK = kRingTileBytes / (D * (int)sizeof(T));
  static constexpr int LPT = CH < 32 ? CH : 32;
  static constexpr int JC = CH / LPT;
  static constexpr int TPP = 32 / LPT;
  static constexpr int NP = TOK / TPP;
  static constexpr int STAGE = TOK * D;  // elements of one K (or V) tile
  static_assert(TOK >= 1 && TOK <= 32 && TOK % TPP == 0, "tile shape");
};

// grid (slots, kv_heads, splits), kThreads threads, kRingSmem bytes of
// dynamic shared memory. D >= d and G >= g are compile-time bounds (rows
// past g compute on zeros and are not stored).
//   * Each warp walks the tiles warp, warp + 4, ... of the split's run.
//     For a tile, lanes 0..TOK-1 find one token's row each through the
//     block table, and the warp copies the TOK rows of K and of V into its
//     ring stage (zeros past the run); it loads the next tile before it
//     waits on this one.
//   * Scores: lane l holds chunks l % LPT (+ j LPT) of the token l / LPT of
//     each pass, and q's same chunks for every row in registers (fp32,
//     times scale * log2 e); a score is an fp32 dot product reduced over
//     the token's LPT lanes by shuffles.
//   * Online softmax in the log2 domain over U passes at a time (a whole
//     tile for g <= 2, half a tile for more rows, fewer live registers),
//     positions past the run masked to NEG_INF and exactly 0 in P; then O
//     += P V, each lane accumulating its chunks over its own tokens.
//   * At the end the lanes of a pass (different tokens) sum l and O, the
//     four warps merge (m, l, O) through shared memory (the ring, now
//     free), and the block writes the normalised output (one split) or the
//     split's partial for paged_combine_kernel: acc [slots, hkv, splits, g,
//     d] and (m in natural log, l) [slots, hkv, splits, g, 2].
template <typename T, int D, int G>
__global__ void __launch_bounds__(kThreads) paged_decode_ring_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* __restrict__ block_tables,
    const int* __restrict__ context_lens, T* __restrict__ out,
    float* __restrict__ part_acc, float* __restrict__ part_ml, int hkv,
    int g, int d, int block_size, int max_blocks, int splits, float scale) {
  using R = Ring<T, D>;
  constexpr int E = R::E, CH = R::CH, TOK = R::TOK, LPT = R::LPT;
  constexpr int JC = R::JC, TPP = R::TPP, NP = R::NP, STAGE = R::STAGE;
  constexpr int U = G > 2 && NP % 2 == 0 ? NP / 2 : NP;  // passes an update
  static_assert((size_t)kWarps * G * (D + 2) * sizeof(float) <= kRingSmem,
                "the merge fits in the ring");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);         // [warp][stage][K, V]
  float* mrg = reinterpret_cast<float*>(smem_raw);  // after the walk

  const int slot = blockIdx.x, h = blockIdx.y, split = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane / LPT, cl = lane % LPT;
  const int hq = hkv * g, dch = d / E;

  // The slot's own live context (never past its table) is cut into
  // `splits` runs of whole tiles, so every split of a long slot walks an
  // equal share and the splits of a short slot past its context do nothing.
  const int ctx = max(0, min(context_lens[slot], max_blocks * block_size));
  const int per_split = ((ctx + TOK - 1) / TOK + splits - 1) / splits;
  const int tok_begin = split * per_split * TOK;
  const int tok_end = min(ctx, tok_begin + per_split * TOK);
  const int ntiles =
      tok_end > tok_begin ? (tok_end - tok_begin + TOK - 1) / TOK : 0;
  const int* table = block_tables + (int64_t)slot * max_blocks;
  const int64_t tok_stride = (int64_t)hkv * d;
  T* Kw = ring + warp * 4 * STAGE;  // this warp's [stage][K, V]

  auto load_tile = [&](int i, int st) {
    const int pos = tok_begin + i * TOK + lane;
    int64_t off = -1;
    if (lane < TOK && pos < tok_end)
      off = ((int64_t)table[pos / block_size] * block_size +
             pos % block_size) * tok_stride + (int64_t)h * d;
    T* Kt = Kw + st * 2 * STAGE;
#pragma unroll
    for (int k = 0; k < TOK * CH / 32; ++k) {
      const int e = lane + k * 32, r = e / CH, c = e % CH;
      const int64_t ro = __shfl_sync(0xffffffffu, off, r);
      const bool in = ro >= 0 && c < dch;
      cp_async16(Kt + r * D + c * E, in ? k_pages + ro + c * E : k_pages,
                 in);
      cp_async16(Kt + STAGE + r * D + c * E,
                 in ? v_pages + ro + c * E : v_pages, in);
    }
  };

  int i = warp, st = 0;
  if (i < ntiles) load_tile(i, 0);
  cp_async_commit();

  const float sl2 = scale * kLog2e;
  float qf[G][JC][E], acc[G][JC][E], m[G], l[G];
#pragma unroll
  for (int r = 0; r < G; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < JC; ++j) {
      const int c = cl + j * LPT;
      if (r < g && c < dch) {
        Vec16<T>::get(*reinterpret_cast<const uint4*>(
                          q + ((int64_t)slot * hq + (int64_t)h * g + r) * d +
                          c * E),
                      qf[r][j]);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) qf[r][j][e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < E; ++e) {
        qf[r][j][e] *= sl2;
        acc[r][j][e] = 0.f;
      }
    }
  }

  while (i < ntiles) {
    const int nx = i + kWarps;
    if (nx < ntiles) {  // the warp's next tile loads while this one computes
      load_tile(nx, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    const T* Kt = Kw + st * 2 * STAGE;
    const T* Vt = Kt + STAGE;
    const int t0 = tok_begin + i * TOK;
#pragma unroll
    for (int p0 = 0; p0 < NP; p0 += U) {
      float s[G][U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int t = (p0 + u) * TPP + grp;
        float part[G];
#pragma unroll
        for (int r = 0; r < G; ++r) part[r] = 0.f;
#pragma unroll
        for (int j = 0; j < JC; ++j) {
          float kf[E];
          Vec16<T>::get(*reinterpret_cast<const uint4*>(
                            Kt + t * D + (cl + j * LPT) * E),
                        kf);
#pragma unroll
          for (int r = 0; r < G; ++r)
#pragma unroll
            for (int e = 0; e < E; ++e)
              part[r] = fmaf(qf[r][j][e], kf[e], part[r]);
        }
        const bool live = t0 + t < tok_end;
#pragma unroll
        for (int r = 0; r < G; ++r) {
#pragma unroll
          for (int o = LPT / 2; o > 0; o >>= 1)
            part[r] += __shfl_xor_sync(0xffffffffu, part[r], o);
          s[r][u] = live ? part[r] : kNegInf;
        }
      }
      // online softmax over these U * TPP tokens; a masked position adds
      // exactly 0
#pragma unroll
      for (int r = 0; r < G; ++r) {
        float mx = s[r][0];
#pragma unroll
        for (int u = 1; u < U; ++u) mx = fmaxf(mx, s[r][u]);
#pragma unroll
        for (int o = LPT; o < 32; o <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float mn = fmaxf(m[r], mx);
        const float alpha = ex2(m[r] - mn);
        m[r] = mn;
        float sum = 0.f;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          float& x = s[r][u];
          x = x == kNegInf ? 0.f : ex2(x - mn);
          sum += x;
        }
        l[r] = l[r] * alpha + sum;  // this lane's tokens; summed at the end
#pragma unroll
        for (int j = 0; j < JC; ++j)
#pragma unroll
          for (int e = 0; e < E; ++e) acc[r][j][e] *= alpha;
      }
      // O += P V over the same tokens
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int t = (p0 + u) * TPP + grp;
#pragma unroll
        for (int j = 0; j < JC; ++j) {
          float vf[E];
          Vec16<T>::get(*reinterpret_cast<const uint4*>(
                            Vt + t * D + (cl + j * LPT) * E),
                        vf);
#pragma unroll
          for (int r = 0; r < G; ++r)
#pragma unroll
            for (int e = 0; e < E; ++e)
              acc[r][j][e] = fmaf(s[r][u], vf[e], acc[r][j][e]);
        }
      }
    }
    __syncwarp();  // this stage's readers are done before it refills
    i = nx;
    st ^= 1;
  }

  // the lanes of a pass held different tokens: sum their l and O
#pragma unroll
  for (int r = 0; r < G; ++r)
#pragma unroll
    for (int o = LPT; o < 32; o <<= 1) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], o);
#pragma unroll
      for (int j = 0; j < JC; ++j)
#pragma unroll
        for (int e = 0; e < E; ++e)
          acc[r][j][e] += __shfl_xor_sync(0xffffffffu, acc[r][j][e], o);
    }
  // merge the four warps through shared memory (the ring, now free)
  __syncthreads();
  float* mo = mrg;                     // [warp][row][D]
  float* mml = mrg + kWarps * G * D;   // [warp][row][2]
  if (grp == 0) {
#pragma unroll
    for (int r = 0; r < G; ++r)
#pragma unroll
      for (int j = 0; j < JC; ++j)
#pragma unroll
        for (int e = 0; e < E; ++e)
          mo[(warp * G + r) * D + (cl + j * LPT) * E + e] = acc[r][j][e];
  }
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < G; ++r) {
      mml[(warp * G + r) * 2] = m[r];
      mml[(warp * G + r) * 2 + 1] = l[r];
    }
  }
  __syncthreads();
  const int64_t part = ((int64_t)slot * hkv + h) * splits + split;
  for (int e = threadIdx.x; e < g * d; e += kThreads) {
    const int r = e / d, c = e - r * d;
    float mw = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      mw = fmaxf(mw, mml[(w * G + r) * 2]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = ex2(mml[(w * G + r) * 2] - mw);
      num += mo[(w * G + r) * D + c] * wt;
      den += mml[(w * G + r) * 2 + 1] * wt;
    }
    if (splits == 1) {
      store(out + ((int64_t)slot * hq + (int64_t)h * g + r) * d + c,
            num / fmaxf(den, 1e-30f));
    } else {
      part_acc[(part * g + r) * d + c] = num;
      if (c == 0) {  // natural-log m, as the combine kernel reads it
        part_ml[(part * g + r) * 2] = mw == kNegInf ? kNegInf : mw * kLn2;
        part_ml[(part * g + r) * 2 + 1] = den;
      }
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

template <typename T, int D, int G>
cudaError_t launch_decode(const void* q, const void* k_pages,
                          const void* v_pages, const int* block_tables,
                          const int* context_lens, void* out,
                          float* part_acc, float* part_ml, int slots, int hkv,
                          int g, int d, int block_size, int max_blocks,
                          int splits, float scale, cudaStream_t stream) {
  auto fn = paged_decode_ring_kernel<T, D, G>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kRingSmem);
  if (err != cudaSuccess) return err;
  fn<<<dim3(slots, hkv, splits), kThreads, kRingSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), block_tables, context_lens,
      static_cast<T*>(out), part_acc, part_ml, hkv, g, d, block_size,
      max_blocks, splits, scale);
  if (splits > 1) {
    paged_combine_kernel<T><<<dim3(slots, hkv), kThreads, 0, stream>>>(
        part_acc, part_ml, static_cast<T*>(out), hkv, g, d, splits);
  }
  return cudaSuccess;
}

// The decode kernel's instantiation for d and g: D the smallest of 64,
// 128, 256 that holds d, G the smallest of 1, 2, 4, 8 that holds g.
template <typename T, int D>
cudaError_t decode_for_g(const void* q, const void* k, const void* v,
                         const int* bt, const int* cl, void* out, float* pa,
                         float* pml, int slots, int hkv, int g, int d, int bs,
                         int maxb, int splits, float scale, cudaStream_t s) {
  auto fn = g <= 1   ? launch_decode<T, D, 1>
            : g <= 2 ? launch_decode<T, D, 2>
            : g <= 4 ? launch_decode<T, D, 4>
                     : launch_decode<T, D, 8>;
  return fn(q, k, v, bt, cl, out, pa, pml, slots, hkv, g, d, bs, maxb,
            splits, scale, s);
}

template <typename T>
cudaError_t run_decode(const void* q, const void* k, const void* v,
                       const int* bt, const int* cl, void* out, float* pa,
                       float* pml, int slots, int hkv, int g, int d, int bs,
                       int maxb, int splits, float scale, cudaStream_t s) {
  auto fn = d <= 64    ? decode_for_g<T, 64>
            : d <= 128 ? decode_for_g<T, 128>
                       : decode_for_g<T, 256>;
  return fn(q, k, v, bt, cl, out, pa, pml, slots, hkv, g, d, bs, maxb,
            splits, scale, s);
}

// ---------------------------------------------------------------- verify
// The speculative verify window (replaces `_verify_kernel`, launched by
// `_paged_pallas_multi`): sq query tokens a slot, q [slots, sq, hq, d],
// context_lens + base_off the BASE length (tokens cached before the window,
// whose own K/V are already in the pages; base_off is 0 for a window and -1
// for a decode step run as a window of one). Query i sees pos < base + i +
// 1: the full
// context and, causally, the window. As in the reference the sq x g query
// rows of one kv head are folded into rows r = i * g + head, so one block
// reads each K/V row once for all the rows it holds. A block holds kRows of
// them; a window with more (a GQA model with a long draft) takes more row
// tiles, a grid dimension beside the splits, so any sq * g is served. The
// block walks the live context only as far as its last row can see, cut
// into `splits` equal runs of whole kTile tiles; the live mask is per row.
// Each thread owns head-dim columns for all of the block's rows, so a V
// element, like a K element, is read once for every row it serves.
// kRows = 8 keeps a thread's registers (part[] and acc[][]) at 56: 16 rows
// need up to 119, fewer blocks fit an SM, and a W = 5 window takes twice
// as long.
constexpr int kRows = 8;
constexpr int kCols = kMaxD / kThreads;  // head-dim columns a thread owns

// grid (slots, kv_heads, splits * row_tiles), kThreads threads; z = tile *
// splits + split. splits == 1: writes the normalised output to `out`
// [slots, sq, hq, d]. splits > 1: unnormalised partials acc [slots, hkv,
// splits, rows, d] and (m, l) [slots, hkv, splits, rows, 2].
template <typename T>
__global__ void __launch_bounds__(kThreads) paged_verify_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* __restrict__ block_tables,
    const int* __restrict__ context_lens, T* __restrict__ out,
    float* __restrict__ part_acc, float* __restrict__ part_ml, int sq,
    int hkv, int g, int d, int block_size, int max_blocks, int splits,
    float scale, int base_off) {
  const int slot = blockIdx.x, h = blockIdx.y;
  const int split = blockIdx.z % splits, row0 = blockIdx.z / splits * kRows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hq = hkv * g;
  const int rows = sq * g;
  const int nrows = min(kRows, rows - row0);

  __shared__ float q_s[kRows * kMaxD];
  __shared__ float p_s[kRows][kTile];
  __shared__ float alpha_s[kRows];
  __shared__ float m_s[kRows];
  __shared__ float l_s[kRows];
  __shared__ int lim_s[kRows];      // row r sees positions < lim_s[r]
  __shared__ int64_t row_s[kTile];  // element offset of (page, off, h, 0)

  const int base = context_lens[slot] + base_off;
  const int ctx = min(base + (row0 + nrows - 1) / g + 1,
                      max_blocks * block_size);
  const int tiles_per_split = ((ctx + kTile - 1) / kTile + splits - 1) / splits;
  const int tok_begin = split * tiles_per_split * kTile;
  const int tok_end = min(ctx, tok_begin + tiles_per_split * kTile);

  for (int e = tid; e < nrows * d; e += kThreads) {
    const int r = e / d, c = e - r * d;
    const int qi = (row0 + r) / g, head = h * g + (row0 + r) % g;
    q_s[e] = to_float(q[(((int64_t)slot * sq + qi) * hq + head) * d + c]) *
             scale;
  }
  if (tid < kRows) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
    lim_s[tid] = base + (row0 + tid) / g + 1;
  }
  float acc[kCols][kRows];
#pragma unroll
  for (int j = 0; j < kCols; ++j)
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[j][r] = 0.f;
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
      float part[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) part[r] = 0.f;
      for (int e = lane; e < d; e += 32) {
        const float kv = to_float(krow[e]);
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          if (r < nrows) part[r] += q_s[r * d + e] * kv;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r < nrows) {
          const float s = warp_sum(part[r]);
          if (lane == 0) p_s[r][t] = s;
        }
      }
    }
    __syncthreads();

    // online softmax: one warp per row, one lane per token; a position the
    // row may not see scores NEG_INF and adds exactly 0 to P
    for (int r = warp; r < nrows; r += kWarps) {
      const bool live = lane < n && t0 + lane < lim_s[r];
      const float s = live ? p_s[r][lane] : kNegInf;
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(s));
      const float p = live ? expf(s - m_new) : 0.f;
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

    // acc = acc * alpha + p.v: column c = tid + j*kThreads of every row
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = tid + j * kThreads;
      if (c < d) {
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          if (r < nrows) acc[j][r] *= alpha_s[r];
        for (int t = 0; t < n; ++t) {
          const float vv = to_float(v_pages[row_s[t] + c]);
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            if (r < nrows) acc[j][r] += p_s[r][t] * vv;
        }
      }
    }
    __syncthreads();
  }

  const int64_t part = ((int64_t)slot * hkv + h) * splits + split;
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    const int c = tid + j * kThreads;
    if (c >= d) continue;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r >= nrows) continue;
      if (splits == 1) {
        const int qi = (row0 + r) / g, head = h * g + (row0 + r) % g;
        store(out + (((int64_t)slot * sq + qi) * hq + head) * d + c,
              acc[j][r] / fmaxf(l_s[r], 1e-30f));
      } else {
        part_acc[(part * rows + row0 + r) * d + c] = acc[j][r];
      }
    }
  }
  if (splits > 1 && tid < nrows) {
    part_ml[(part * rows + row0 + tid) * 2] = m_s[tid];
    part_ml[(part * rows + row0 + tid) * 2 + 1] = l_s[tid];
  }
}

// grid (slots, kv_heads): the logsumexp-weighted sum of the verify
// partials (paged_attention.py:280-285); an empty split (m = NEG_INF) gets
// weight 0. Row r goes back to query r / g, head h * g + r % g.
template <typename T>
__global__ void __launch_bounds__(kThreads) paged_verify_combine_kernel(
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    T* __restrict__ out, int sq, int hkv, int g, int d, int splits) {
  const int slot = blockIdx.x, h = blockIdx.y;
  const int rows = sq * g, hq = hkv * g;
  const int64_t base = ((int64_t)slot * hkv + h) * splits;
  for (int e = threadIdx.x; e < rows * d; e += kThreads) {
    const int r = e / d, c = e - r * d;
    float m_g = kNegInf;
    for (int s = 0; s < splits; ++s)
      m_g = fmaxf(m_g, part_ml[((base + s) * rows + r) * 2]);
    float num = 0.f, den = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float w = expf(part_ml[((base + s) * rows + r) * 2] - m_g);
      num += part_acc[((base + s) * rows + r) * d + c] * w;
      den += part_ml[((base + s) * rows + r) * 2 + 1] * w;
    }
    const int qi = r / g, head = h * g + r % g;
    store(out + (((int64_t)slot * sq + qi) * hq + head) * d + c,
          num / fmaxf(den, 1e-30f));
  }
}

// ------------------------------------------------ verify, tensor cores
// The bf16 window on the tensor cores. The CUDA-core kernel above reads K by
// one warp per token (four tokens in flight a block), V one column a thread
// in a serial per-token loop, and does every product on the CUDA cores: it
// waits on latency, at 12% of its byte bound at the speculative slice's
// shape. Here each warp keeps its own ring of K/V tiles in flight:
//   * a block holds one m-tile of 16 (query, head) rows of one kv head, r =
//     i * g + head as above (sq * g rows take ceil(sq * g / 16) row tiles on
//     grid.z beside the splits), so each K/V row is read once for all the
//     rows of its tile: a window of 5 tokens with g = 1, or a decode step
//     with g = 16, fills one tile;
//   * its four warps split the block's run of the context: warp w takes the
//     16-token tiles w, w + 4, ... . A tile is gathered through the block
//     table by 16-byte cp.async (one token's head row is d x 2 contiguous
//     bytes), zero-filled past the run, into the warp's own two-stage ring,
//     so the warp loads its next tile while it computes this one and needs
//     no block barrier;
//   * S = Q K^T and O += P V run on mma.sync m16n8k16 bf16 -> fp32 (K as
//     the B operand by ldmatrix, V by ldmatrix.trans, Q from shared memory),
//     with the online softmax on the accumulators in the log2 domain and
//     the per-row mask (row r sees positions < base + r / g + 1) on every
//     tile. P enters P V as two bf16 terms (hi + lo, x to 2^-16): one
//     rounding (2^-9) misses the one-ulp bound that holds the kernel to its
//     plain version (tests/test_torch_speculative.py);
//   * the four warps' (m, l, O) merge through shared memory, reused from
//     the ring, into the normalised output (one split) or the split's
//     partial, which paged_verify_combine_kernel combines as before.
constexpr int kVTok = 16;   // tokens a warp tile
constexpr int kVRows = 16;  // (query, head) rows a block

template <int D>
constexpr size_t verify_mma_smem() {
  const size_t ring = (size_t)kWarps * 2 * 2 * kVTok * (D + 8) * 2;
  const size_t merge = (size_t)kWarps * kVRows * (D + 2) * sizeof(float);
  return (size_t)kVRows * (D + 8) * 2 + (ring > merge ? ring : merge);
}

// grid (slots, kv_heads, splits * row_tiles), z = tile * splits + split,
// kThreads threads. Outputs as paged_verify_kernel's.
template <int D>
__global__ void __launch_bounds__(kThreads) paged_verify_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k_pages,
    const bf16* __restrict__ v_pages, const int* __restrict__ block_tables,
    const int* __restrict__ context_lens, bf16* __restrict__ out,
    float* __restrict__ part_acc, float* __restrict__ part_ml, int sq,
    int hkv, int grp, int d, int block_size, int max_blocks, int splits,
    float scale, int base_off) {
  constexpr int LDS = D + 8, CH = D / 8, ND = D / 8;
  constexpr int STAGE = kVTok * LDS;            // one K (or V) tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [kVRows][LDS]
  bf16* ring = Qs + kVRows * LDS;                // [warp][stage][K, V]
  float* mrg = reinterpret_cast<float*>(ring);   // after the walk

  const int slot = blockIdx.x, h = blockIdx.y;
  const int split = blockIdx.z % splits, row0 = blockIdx.z / splits * kVRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int hq = hkv * grp, rows = sq * grp;
  const int nrows = min(kVRows, rows - row0);
  const int base = context_lens[slot] + base_off;
  const int ctx = min(base + (row0 + nrows - 1) / grp + 1,
                      max_blocks * block_size);
  const int n_all = (max(ctx, 0) + kVTok - 1) / kVTok;
  const int per_split = (n_all + splits - 1) / splits;
  const int tok_begin = split * per_split * kVTok;
  const int tok_end = min(ctx, tok_begin + per_split * kVTok);
  const int ntiles = tok_end > tok_begin
                         ? (tok_end - tok_begin + kVTok - 1) / kVTok : 0;
  // this thread's rows g and g + 8 of the tile see positions < lim
  const int lim0 = g < nrows ? base + (row0 + g) / grp + 1 : 0;
  const int lim1 = g + 8 < nrows ? base + (row0 + g + 8) / grp + 1 : 0;
  const int* table = block_tables + (int64_t)slot * max_blocks;
  const int64_t tok_stride = (int64_t)hkv * d;
  bf16* Kw = ring + warp * 4 * STAGE;  // [stage][K, V]

  // Q rows of the tile; zeros past the rows and past d
  for (int e = threadIdx.x; e < kVRows * CH; e += kThreads) {
    const int r = e / CH, c = (e % CH) * 8;
    const bool in = r < nrows && c < d;
    const int qi = (row0 + r) / grp, head = h * grp + (row0 + r) % grp;
    cp_async16(Qs + r * LDS + c,
               in ? q + (((int64_t)slot * sq + qi) * hq + head) * d + c : q,
               in);
  }
  cp_async_commit();
  // the warp's tile i of the run into stage st: lanes 0-15 find the row of
  // one token each through the table, then the warp copies the 16 rows
  auto load_tile = [&](int i, int st) {
    const int pos = tok_begin + i * kVTok + (lane & 15);
    int64_t off = -1;
    if (pos < tok_end)
      off = ((int64_t)table[pos / block_size] * block_size +
             pos % block_size) * tok_stride + (int64_t)h * d;
    bf16* Kt = Kw + st * 2 * STAGE;
#pragma unroll
    for (int e = lane; e < kVTok * CH; e += 32) {
      const int r = e / CH, c = (e % CH) * 8;
      const int64_t ro = __shfl_sync(0xffffffffu, off, r);
      const bool in = ro >= 0 && c < d;
      cp_async16(Kt + r * LDS + c, in ? k_pages + ro + c : k_pages, in);
      cp_async16(Kt + STAGE + r * LDS + c, in ? v_pages + ro + c : v_pages,
                 in);
    }
  };

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, oacc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;
  const float sl2 = scale * kLog2e;

  int i = warp, st = 0;
  if (i < ntiles) load_tile(i, 0);
  cp_async_commit();
  cp_async_wait<1>();  // Q has landed
  __syncthreads();
  while (i < ntiles) {
    const int in = i + kWarps;
    if (in < ntiles) {  // the warp's next tile loads while this one computes
      load_tile(in, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    const bf16* Kt = Kw + st * 2 * STAGE;
    const bf16* Vt = Kt + STAGE;
    const int t0 = tok_begin + i * kVTok;

    // S = Q K^T: 16 rows x 16 tokens
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4], b[4];
      ldsm_x4<false>(a, Qs + (lane & 15) * LDS + kk * 16 + (lane >> 4) * 8);
      ldsm_x4<false>(b, Kt + (((lane >> 4) << 3) + (lane & 7)) * LDS +
                            kk * 16 + ((lane >> 3) & 1) * 8);
      mma(s[0], a, b[0], b[1]);
      mma(s[1], a, b[2], b[3]);
    }
    // per-row mask, online softmax in the log2 domain; a position the row
    // may not see adds exactly 0, even before any it may
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int lim = min(hf ? lim1 : lim0, tok_end);
      float mx = kNegInf;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[n][2 * hf + e];
          if (t0 + n * 8 + 2 * t + e >= lim) x = kNegInf;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mn = fmaxf(m[hf], mx == kNegInf ? kNegInf : mx * sl2);
      const float alpha = ex2(m[hf] - mn);
      m[hf] = mn;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[n][2 * hf + e];
          x = x == kNegInf ? 0.f : ex2(fmaf(x, sl2, -mn));
          sum += x;
        }
      l[hf] = l[hf] * alpha + sum;  // summed over the row's lanes at the end
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        oacc[n][2 * hf] *= alpha;
        oacc[n][2 * hf + 1] *= alpha;
      }
    }
    // O += P V, P as two bf16 terms; V is the k-major operand
    uint32_t ph[4], pl[4];
    c_to_a(s[0], s[1], ph, pl);
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t b[4];
      ldsm_x4<true>(b, Vt + (((lane >> 3) & 1) * 8 + (lane & 7)) * LDS +
                           dp * 16 + (lane >> 4) * 8);
      mma(oacc[2 * dp], ph, b[0], b[1]);
      mma(oacc[2 * dp + 1], ph, b[2], b[3]);
      mma(oacc[2 * dp], pl, b[0], b[1]);
      mma(oacc[2 * dp + 1], pl, b[2], b[3]);
    }
    __syncwarp();  // this stage's readers are done before it refills
    i = in;
    st ^= 1;
  }

  // merge the four warps: each writes its rows' (m, l) and O to shared
  // memory (the ring, now free); then every thread takes whole elements
  __syncthreads();
  float* mo = mrg;                                // [warp][row][D]
  float* mml = mrg + kWarps * kVRows * D;         // [warp][row][2]
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float lr = l[hf];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const int r = g + hf * 8;
    if (t == 0) {
      mml[(warp * kVRows + r) * 2] = m[hf];
      mml[(warp * kVRows + r) * 2 + 1] = lr;
    }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int c = n * 8 + 2 * t;
      mo[(warp * kVRows + r) * D + c] = oacc[n][2 * hf];
      mo[(warp * kVRows + r) * D + c + 1] = oacc[n][2 * hf + 1];
    }
  }
  __syncthreads();
  const int64_t part = ((int64_t)slot * hkv + h) * splits + split;
  for (int e = threadIdx.x; e < nrows * d; e += kThreads) {
    const int r = e / d, c = e - r * d;
    float mw = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      mw = fmaxf(mw, mml[(w * kVRows + r) * 2]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = ex2(mml[(w * kVRows + r) * 2] - mw);
      num += mo[(w * kVRows + r) * D + c] * wt;
      den += mml[(w * kVRows + r) * 2 + 1] * wt;
    }
    if (splits == 1) {
      const int qi = (row0 + r) / grp, head = h * grp + (row0 + r) % grp;
      out[(((int64_t)slot * sq + qi) * hq + head) * d + c] =
          __float2bfloat16(num / fmaxf(den, 1e-30f));
    } else {
      part_acc[(part * rows + row0 + r) * d + c] = num;
      if (c == 0) {  // natural-log m, as the combine kernel reads it
        part_ml[(part * rows + row0 + r) * 2] =
            mw == kNegInf ? kNegInf : mw * kLn2;
        part_ml[(part * rows + row0 + r) * 2 + 1] = den;
      }
    }
  }
}

// The verify window's split combine (nothing to combine at one split).
template <typename T>
void launch_combine(float* part_acc, float* part_ml, void* out, int slots,
                    int sq, int hkv, int g, int d, int splits,
                    cudaStream_t stream) {
  if (splits > 1)
    paged_verify_combine_kernel<T><<<dim3(slots, hkv), kThreads, 0, stream>>>(
        part_acc, part_ml, static_cast<T*>(out), sq, hkv, g, d, splits);
}

template <typename T>
cudaError_t launch_verify(const void* q, const void* k_pages,
                          const void* v_pages, const int* block_tables,
                          const int* context_lens, void* out, float* part_acc,
                          float* part_ml, int slots, int sq, int hkv, int g,
                          int d, int block_size, int max_blocks, int splits,
                          float scale, int base_off, cudaStream_t stream) {
  const int row_tiles = (sq * g + kRows - 1) / kRows;
  paged_verify_kernel<T>
      <<<dim3(slots, hkv, splits * row_tiles), kThreads, 0, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k_pages),
          static_cast<const T*>(v_pages), block_tables, context_lens,
          static_cast<T*>(out), part_acc, part_ml, sq, hkv, g, d, block_size,
          max_blocks, splits, scale, base_off);
  launch_combine<T>(part_acc, part_ml, out, slots, sq, hkv, g, d, splits,
                    stream);
  return cudaSuccess;
}

template <int D>
cudaError_t launch_verify_mma(const void* q, const void* k_pages,
                              const void* v_pages, const int* block_tables,
                              const int* context_lens, void* out,
                              float* part_acc, float* part_ml, int slots,
                              int sq, int hkv, int g, int d, int block_size,
                              int max_blocks, int splits, float scale,
                              int base_off, cudaStream_t stream) {
  auto fn = paged_verify_mma_kernel<D>;
  constexpr size_t smem = verify_mma_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int row_tiles = (sq * g + kVRows - 1) / kVRows;
  fn<<<dim3(slots, hkv, splits * row_tiles), kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k_pages),
      static_cast<const bf16*>(v_pages), block_tables, context_lens,
      static_cast<bf16*>(out), part_acc, part_ml, sq, hkv, g, d, block_size,
      max_blocks, splits, scale, base_off);
  launch_combine<bf16>(part_acc, part_ml, out, slots, sq, hkv, g, d, splits,
                       stream);
  return cudaSuccess;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The kernels a call names (the wrapper's `route`).
enum Kernel { kDecode = 0, kVerifyCudaCores = 1, kVerifyTensorCores = 2 };

// What the tensor-core verify kernel needs: bf16, head_dim % 8 == 0, and q,
// the pages and the output 16-byte aligned (its 16-byte cp.async rows).
bool mma_fits(const void* q, const void* k_pages, const void* v_pages,
              const void* out, int d, int dtype) {
  return dtype == 1 && d % 8 == 0 && aligned16(q) && aligned16(k_pages) &&
         aligned16(v_pages) && aligned16(out);
}

// The verify window (any dtype on the CUDA cores, bf16 on the tensor
// cores where tc) and its split combine. dtype: 0 = float32, 1 = bfloat16,
// 2 = float16.
cudaError_t run_verify(const void* q, const void* k_pages,
                       const void* v_pages, const int* bt, const int* cl,
                       void* out, float* pa, float* pml, int slots, int sq,
                       int hkv, int g, int d, int block_size, int max_blocks,
                       int splits, float scale, int dtype, bool tc,
                       int base_off, cudaStream_t s) {
  auto fn = dtype == 0   ? launch_verify<float>
            : dtype == 2 ? launch_verify<__half>
                         : launch_verify<__nv_bfloat16>;
  if (tc)
    fn = d <= 64    ? launch_verify_mma<64>
         : d <= 128 ? launch_verify_mma<128>
                    : launch_verify_mma<256>;
  const cudaError_t err =
      fn(q, k_pages, v_pages, bt, cl, out, pa, pml, slots, sq, hkv, g, d,
         block_size, max_blocks, splits, scale, base_off, s);
  return err != cudaSuccess ? err : cudaGetLastError();
}

bool verify_args_ok(int slots, int sq, int hkv, int g, int d, int block_size,
                    int max_blocks, int splits, int dtype, int kernel,
                    const void* q, const void* k_pages, const void* v_pages,
                    const void* out) {
  const bool tc = kernel == kVerifyTensorCores;
  if (tc && !mma_fits(q, k_pages, v_pages, out, d, dtype)) return false;
  const long long rows = tc ? kVRows : kRows;  // (query, head) rows a block
  const long long row_tiles = ((long long)sq * g + rows - 1) / rows;
  return slots >= 1 && sq >= 1 && hkv >= 1 && g >= 1 && d >= 1 &&
         d <= kMaxD && block_size >= 1 && max_blocks >= 1 && splits >= 1 &&
         splits <= max_blocks && splits * row_tiles <= 65535 &&
         hkv <= 65535 && dtype >= 0 && dtype <= 2 &&
         (kernel == kVerifyCudaCores || tc);
}


// What the decode kernel needs: g <= kMaxG query rows a kv head, rows of
// whole 16-byte chunks (d * itemsize % 16 == 0), and q, the pages and the
// output 16-byte aligned.
bool decode_fits(const void* q, const void* k_pages, const void* v_pages,
                 const void* out, int g, int d, int dtype) {
  const int itemsize = dtype == 0 ? 4 : 2;
  return g <= kMaxG && d * itemsize % 16 == 0 && aligned16(q) &&
         aligned16(k_pages) && aligned16(v_pages) && aligned16(out);
}

}  // namespace

// q [slots, hkv*g, d]; k_pages, v_pages [num_blocks, block_size, hkv, d];
// block_tables [slots, max_blocks] int32; context_lens [slots] int32;
// out [slots, hkv*g, d]; part_acc [slots*hkv*splits*g*d] and
// part_ml [slots*hkv*splits*g*2] fp32 scratch (unused when splits == 1).
// dtype: 0 = float32, 1 = bfloat16, 2 = float16. All tensors contiguous, on
// one device. kernel: 0 the decode kernel, 1 or 2 the verify kernel (CUDA
// cores, tensor cores) as a window of one token; a kernel the arguments do
// not fit is refused (cudaErrorInvalidValue) before anything launches.
extern "C" int paged_attention_decode(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_tables, const void* context_lens, void* out,
    void* part_acc, void* part_ml, int slots, int hkv, int g, int d,
    int block_size, int max_blocks, int splits, int kernel, float scale,
    int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* bt = static_cast<const int*>(block_tables);
  const int* cl = static_cast<const int*>(context_lens);
  float* pa = static_cast<float*>(part_acc);
  float* pml = static_cast<float*>(part_ml);
  if (kernel != kDecode) {
    if (!verify_args_ok(slots, 1, hkv, g, d, block_size, max_blocks, splits,
                        dtype, kernel, q, k_pages, v_pages, out))
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(run_verify(
        q, k_pages, v_pages, bt, cl, out, pa, pml, slots, 1, hkv, g, d,
        block_size, max_blocks, splits, scale, dtype,
        kernel == kVerifyTensorCores, -1, s));
  }
  if (!decode_fits(q, k_pages, v_pages, out, g, d, dtype) || slots < 1 || hkv < 1 || hkv > 65535 || g < 1 || d < 1 || d > kMaxD ||
      block_size < 1 || max_blocks < 1 || splits < 1 || splits > max_blocks ||
      splits > 65535 || dtype < 0 || dtype > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto fn = dtype == 0   ? run_decode<float>
            : dtype == 2 ? run_decode<__half>
                         : run_decode<__nv_bfloat16>;
  const cudaError_t err = fn(q, k_pages, v_pages, bt, cl, out, pa, pml,
                             slots, hkv, g, d, block_size, max_blocks,
                             splits, scale, s);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// q, out [slots, sq, hkv*g, d]; k_pages, v_pages [num_blocks, block_size,
// hkv, d]; block_tables [slots, max_blocks] int32; context_lens [slots]
// int32, the tokens cached before the window; part_acc
// [slots*hkv*splits*sq*g*d] and part_ml [slots*hkv*splits*sq*g*2] fp32
// scratch (unused when splits == 1). dtype: 0 = float32, 1 = bfloat16, 2 =
// float16. kernel: 1 the CUDA-core verify kernel, 2 the tensor-core one; a
// kernel the arguments do not fit is refused (cudaErrorInvalidValue).
extern "C" int paged_attention_verify(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_tables, const void* context_lens, void* out,
    void* part_acc, void* part_ml, int slots, int sq, int hkv, int g, int d,
    int block_size, int max_blocks, int splits, int kernel, float scale,
    int dtype, void* stream) {
  if (!verify_args_ok(slots, sq, hkv, g, d, block_size, max_blocks, splits,
                      dtype, kernel, q, k_pages, v_pages, out))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(run_verify(
      q, k_pages, v_pages, static_cast<const int*>(block_tables),
      static_cast<const int*>(context_lens), out,
      static_cast<float*>(part_acc), static_cast<float*>(part_ml), slots, sq,
      hkv, g, d, block_size, max_blocks, splits, scale, dtype,
      kernel == kVerifyTensorCores, 0, static_cast<cudaStream_t>(stream)));
}
