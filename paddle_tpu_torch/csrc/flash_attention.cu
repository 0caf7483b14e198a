// Flash attention forward and backward for Hopper (sm_90a), dense and
// segmented.
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/flash_attention.py:
//   * `_fwd_kernel` (launched by `_fwd`): o and the fp32 logsumexp of each
//     query row, by online softmax over K/V tiles;
//   * `_dq_kernel` (launched by `_bwd`): dQ, recomputing P from q, k and lse;
//   * `_dkv_kernel` (launched by `_bwd`): dK and dV, walking the q tiles at
//     or after its k tile when causal;
//   * `_fwd_seg_kernel` (via `_seg_fwd`), `_bwd_seg_kernel` and
//     `_dkv_seg_kernel` (via `_seg_bwd`): the same three with segment ids
//     (packed documents): query i sees key j only where seg_q[i] ==
//     seg_k[j] (and j <= i when causal). Padding carries -1, which matches
//     only itself. A score that is masked contributes exactly 0 to P, so a
//     row with no live key gives o = 0 (lse = -1e30 + log(1e-30)) and zero
//     gradients, as in the TPU kernels.
// Inputs are [b, s, h, d] (contiguous), the causal mask is top-left aligned
// (query i sees keys j <= i), masked scores take -1e30 and the softmax
// denominator is clamped to 1e-30, as in the TPU kernels. delta =
// rowsum(dO * O) is computed outside, as the reference does in XLA.
//
// What bounds them on the H100: operations. Causal attention at b 4, s 2048,
// h 16, d 128 does 2*b*h*s^2*d flops in the forward over 134 MB of bf16
// inputs and outputs, about 500 flops a byte, above the ~295 at which the
// tensor cores, not the memory, become the limit. This first version does
// the products on the CUDA cores in fp32 (for bf16 inputs as well), so it
// runs far from that bound; `wgmma` with TMA-fed tiles is later work. What
// the design does keep from the TPU kernels is that nothing of size s x s
// reaches device memory: each block keeps its q tile (or its k/v tile) in
// shared memory, streams the other operand through shared memory one tile
// at a time, and holds the fp32 accumulators in registers.
//
// Blocks are independent (the TPU's sequential grid carried nothing
// between q blocks either): forward and dQ take one q tile per block, dK/dV
// one k tile per block, each with a loop over the other axis. 256 threads
// form a 16 x 16 grid; thread (ty, tx) owns rows ty + 16 i and columns
// tx + 16 j of every tile product, so shared-memory rows padded by one word
// are read without bank conflicts. Tiles are 64 rows for head_dim <= 128 and
// 32 rows for head_dim <= 256 (shared memory holds four fp32 tiles of
// [rows, head_dim]); head_dim is padded with zeros to 64, 128 or 256.
//
// Segments are the same templates with kSeg set: each thread keeps the
// segment ids of its own rows and columns in registers (read straight from
// device memory, [b, s] int32), and ANDs seg_q == seg_k into the live mask.
// A k tile (a q tile in dK/dV) in which no pair is live is skipped: every
// thread tests its own pairs and __syncthreads_or decides for the block.
// Under the online softmax a tile with no live pair leaves m, l and the
// accumulators exactly as they were (alpha = 1, P = 0), so skipping gives
// the same bits as computing it. Packed documents are short beside the row,
// so most tiles off the diagonal blocks are skipped; the TPU kernels skip
// nothing.
//
// C interface (loaded with ctypes): each entry point returns
// cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;  // the reference's NEG_INF

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Sums and maxima over the 16 threads (tx = 0..15) that share a tile row.
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Rows [row0, row0 + B) of one head of a [b, s, h, d] tensor (g points at
// row 0 of that head, rows apart by `stride` elements) into shared memory
// as fp32 [B][D + 1], times `mul`; zeros past `rows` and past d.
template <typename T, int D, int B>
__device__ __forceinline__ void load_tile(float* sm, const T* __restrict__ g,
                                          int row0, int rows, int d,
                                          long stride, float mul) {
  for (int e = threadIdx.x; e < B * D; e += kThreads) {
    const int r = e / D, c = e % D;
    float x = 0.f;
    if (row0 + r < rows && c < d)
      x = to_float(g[(long)(row0 + r) * stride + c]) * mul;
    sm[r * (D + 1) + c] = x;
  }
}

// acc[i][j] = sum_k A[ty + 16 i][k] * Bm[tx + 16 j][k] over k < d: a tile of
// A Bm^T from two [B][D + 1] shared tiles.
template <int D, int B>
__device__ __forceinline__ void tile_abt(float (&acc)[B / 16][B / 16],
                                         const float* A, const float* Bm,
                                         int d, int ty, int tx) {
  constexpr int T = B / 16, LD = D + 1;
#pragma unroll
  for (int i = 0; i < T; ++i)
#pragma unroll
    for (int j = 0; j < T; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int k = 0; k < d; ++k) {
    float a[T], b[T];
#pragma unroll
    for (int i = 0; i < T; ++i) a[i] = A[(ty + 16 * i) * LD + k];
#pragma unroll
    for (int j = 0; j < T; ++j) b[j] = Bm[(tx + 16 * j) * LD + k];
#pragma unroll
    for (int i = 0; i < T; ++i)
#pragma unroll
      for (int j = 0; j < T; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc[i][c] += sum_r P[r][ty + 16 i or as given] * M[r][tx + 16 c]: P read
// row-major ([row][r], transposed = false) or column-major ([r][row],
// transposed = true) from a [B][B + 1] shared tile, M a [B][D + 1] tile.
template <int D, int B, bool kTransposed>
__device__ __forceinline__ void tile_pm(float (&acc)[B / 16][D / 16],
                                        const float* P, const float* M,
                                        int ty, int tx) {
  constexpr int T = B / 16, TD = D / 16, LB = B + 1, LD = D + 1;
#pragma unroll 2
  for (int r = 0; r < B; ++r) {
    float a[T], m[TD];
#pragma unroll
    for (int i = 0; i < T; ++i)
      a[i] = kTransposed ? P[r * LB + ty + 16 * i] : P[(ty + 16 * i) * LB + r];
#pragma unroll
    for (int c = 0; c < TD; ++c) m[c] = M[r * LD + tx + 16 * c];
#pragma unroll
    for (int i = 0; i < T; ++i)
#pragma unroll
      for (int c = 0; c < TD; ++c) acc[i][c] = fmaf(a[i], m[c], acc[i][c]);
  }
}

// Store rows [row0, row0 + B) of one head from per-thread accumulators.
template <typename T, int D, int B>
__device__ __forceinline__ void store_tile(T* __restrict__ g,
                                           const float (&acc)[B / 16][D / 16],
                                           int row0, int rows, int d,
                                           long stride, float mul, int ty,
                                           int tx) {
#pragma unroll
  for (int i = 0; i < B / 16; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= rows) continue;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      const int col = tx + 16 * c;
      if (col < d) store(&g[(long)r * stride + col], acc[i][c] * mul);
    }
  }
}

// Segment ids of the rows (or columns) ty + 16 i (tx + 16 i) of a tile at
// row0 of one batch row's [s] ids; 0 past s (those rows are never live).
template <int B>
__device__ __forceinline__ void load_seg(int (&out)[B / 16],
                                         const int* __restrict__ seg,
                                         int row0, int rows, int lane) {
#pragma unroll
  for (int i = 0; i < B / 16; ++i) {
    const int r = row0 + lane + 16 * i;
    out[i] = r < rows ? seg[r] : 0;
  }
}

// True for the block when any (q, k) pair of the tile is live: every thread
// tests its own pairs. A barrier for the whole block.
template <int B>
__device__ __forceinline__ bool tile_live(const int (&sq_r)[B / 16],
                                          const int (&sk_r)[B / 16], int q0,
                                          int k0, int sq, int sk, int causal,
                                          int ty, int tx) {
  bool any = false;
#pragma unroll
  for (int i = 0; i < B / 16; ++i) {
    const int qi = q0 + ty + 16 * i;
#pragma unroll
    for (int jj = 0; jj < B / 16; ++jj) {
      const int kj = k0 + tx + 16 * jj;
      any |= qi < sq && kj < sk && !(causal && qi < kj) &&
             sq_r[i] == sk_r[jj];
    }
  }
  return __syncthreads_or(any) != 0;
}

// grid (ceil(sq / B), b * h). o [b, sq, h, d]; lse [b * h, sq] fp32;
// seg_q [b, sq], seg_k [b, sk] int32 when kSeg.
template <typename T, int D, int B, bool kSeg>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ seg_q,
                     const int* __restrict__ seg_k, T* __restrict__ o,
                     float* __restrict__ lse, int h, int sq, int sk, int d,
                     float scale, int causal) {
  constexpr int TM = B / 16, TD = D / 16, LD = D + 1, LB = B + 1;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + B * LD;
  float* Vs = Ks + B * LD;
  float* Ps = Vs + B * LD;
  const int bh = blockIdx.y, bi = bh / h, hi = bh % h;
  const int q0 = blockIdx.x * B;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const long stride = (long)h * d;
  const long qoff = ((long)bi * sq * h + hi) * d;
  const long koff = ((long)bi * sk * h + hi) * d;

  load_tile<T, D, B>(Qs, q + qoff, q0, sq, d, stride, scale);
  int sq_r[TM], sk_r[TM];
  if constexpr (kSeg) load_seg<B>(sq_r, seg_q + (long)bi * sq, q0, sq, ty);
  float m[TM], l[TM], acc[TM][TD];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < TD; ++c) acc[i][c] = 0.f;
  }
  int nk = (sk + B - 1) / B;
  if (causal) nk = min(nk, (q0 + B - 1) / B + 1);  // tiles starting <= q end

  for (int j = 0; j < nk; ++j) {
    const int k0 = j * B;
    if constexpr (kSeg) {
      load_seg<B>(sk_r, seg_k + (long)bi * sk, k0, sk, tx);
      if (!tile_live<B>(sq_r, sk_r, q0, k0, sq, sk, causal, ty, tx)) continue;
    }
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D, B>(Ks, k + koff, k0, sk, d, stride, 1.f);
    load_tile<T, D, B>(Vs, v + koff, k0, sk, d, stride, 1.f);
    __syncthreads();
    float s[TM][TM];
    bool live[TM][TM];
    tile_abt<D, B>(s, Qs, Ks, d, ty, tx);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int qi = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int jj = 0; jj < TM; ++jj) {
        const int kj = k0 + tx + 16 * jj;
        live[i][jj] = kj < sk && !(causal && qi < kj);
        if constexpr (kSeg) live[i][jj] = live[i][jj] && sq_r[i] == sk_r[jj];
        if (!live[i][jj]) s[i][jj] = kNegInf;
        mx = fmaxf(mx, s[i][jj]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < TM; ++jj) {
        // segments: a masked score is exactly 0 even in a row with no live
        // key so far (where m_new is the mask value itself)
        const float p =
            kSeg && !live[i][jj] ? 0.f : expf(s[i][jj] - m_new);
        Ps[(ty + 16 * i) * LB + tx + 16 * jj] = p;
        sum += p;
      }
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < TD; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
    tile_pm<D, B, false>(acc, Ps, Vs, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int qi = q0 + ty + 16 * i;
    const float li = fmaxf(l[i], 1e-30f);
    if (qi < sq && tx == 0) lse[(long)bh * sq + qi] = m[i] + logf(li);
#pragma unroll
    for (int c = 0; c < TD; ++c) acc[i][c] /= li;
  }
  store_tile<T, D, B>(o + qoff, acc, q0, sq, d, stride, 1.f, ty, tx);
}

// grid (ceil(sq / B), b * h). dq [b, sq, h, d]; lse, delta [b * h, sq].
template <typename T, int D, int B, bool kSeg>
__global__ void __launch_bounds__(kThreads)
    flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ seg_q,
                    const int* __restrict__ seg_k, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int h, int sq, int sk, int d, float scale, int causal) {
  constexpr int TM = B / 16, TD = D / 16, LD = D + 1, LB = B + 1;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + B * LD;
  float* Ks = dOs + B * LD;
  float* Vs = Ks + B * LD;
  float* dSs = Vs + B * LD;
  const int bh = blockIdx.y, bi = bh / h, hi = bh % h;
  const int q0 = blockIdx.x * B;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const long stride = (long)h * d;
  const long qoff = ((long)bi * sq * h + hi) * d;
  const long koff = ((long)bi * sk * h + hi) * d;

  load_tile<T, D, B>(Qs, q + qoff, q0, sq, d, stride, scale);
  load_tile<T, D, B>(dOs, dout + qoff, q0, sq, d, stride, 1.f);
  int sq_r[TM], sk_r[TM];
  if constexpr (kSeg) load_seg<B>(sq_r, seg_q + (long)bi * sq, q0, sq, ty);
  float lse_r[TM], delta_r[TM], acc[TM][TD];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int qi = q0 + ty + 16 * i;
    lse_r[i] = qi < sq ? lse[(long)bh * sq + qi] : 0.f;
    delta_r[i] = qi < sq ? delta[(long)bh * sq + qi] : 0.f;
#pragma unroll
    for (int c = 0; c < TD; ++c) acc[i][c] = 0.f;
  }
  int nk = (sk + B - 1) / B;
  if (causal) nk = min(nk, (q0 + B - 1) / B + 1);

  for (int j = 0; j < nk; ++j) {
    const int k0 = j * B;
    if constexpr (kSeg) {
      load_seg<B>(sk_r, seg_k + (long)bi * sk, k0, sk, tx);
      if (!tile_live<B>(sq_r, sk_r, q0, k0, sq, sk, causal, ty, tx)) continue;
    }
    __syncthreads();
    load_tile<T, D, B>(Ks, k + koff, k0, sk, d, stride, 1.f);
    load_tile<T, D, B>(Vs, v + koff, k0, sk, d, stride, 1.f);
    __syncthreads();
    float s[TM][TM], dp[TM][TM];
    tile_abt<D, B>(s, Qs, Ks, d, ty, tx);
    tile_abt<D, B>(dp, dOs, Vs, d, ty, tx);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int qi = q0 + ty + 16 * i;
#pragma unroll
      for (int jj = 0; jj < TM; ++jj) {
        const int kj = k0 + tx + 16 * jj;
        bool live = kj < sk && !(causal && qi < kj);
        if constexpr (kSeg) live = live && sq_r[i] == sk_r[jj];
        const float p = live ? expf(s[i][jj] - lse_r[i]) : 0.f;
        dSs[(ty + 16 * i) * LB + tx + 16 * jj] = p * (dp[i][jj] - delta_r[i]);
      }
    }
    __syncthreads();
    tile_pm<D, B, false>(acc, dSs, Ks, ty, tx);
  }
  store_tile<T, D, B>(dq + qoff, acc, q0, sq, d, stride, scale, ty, tx);
}

// grid (ceil(sk / B), b * h). dk, dv [b, sk, h, d].
template <typename T, int D, int B, bool kSeg>
__global__ void __launch_bounds__(kThreads)
    flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ seg_q,
                     const int* __restrict__ seg_k,
                     const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int h, int sq, int sk, int d,
                     float scale, int causal) {
  constexpr int TM = B / 16, TD = D / 16, LD = D + 1, LB = B + 1;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + B * LD;
  float* Qs = Vs + B * LD;
  float* dOs = Qs + B * LD;
  float* Ps = dOs + B * LD;
  float* dSs = Ps + B * LB;
  float* lses = dSs + B * LB;
  float* deltas = lses + B;
  const int bh = blockIdx.y, bi = bh / h, hi = bh % h;
  const int k0 = blockIdx.x * B;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const long stride = (long)h * d;
  const long qoff = ((long)bi * sq * h + hi) * d;
  const long koff = ((long)bi * sk * h + hi) * d;

  load_tile<T, D, B>(Ks, k + koff, k0, sk, d, stride, 1.f);
  load_tile<T, D, B>(Vs, v + koff, k0, sk, d, stride, 1.f);
  int sq_r[TM], sk_r[TM];
  if constexpr (kSeg) load_seg<B>(sk_r, seg_k + (long)bi * sk, k0, sk, tx);
  float dk_acc[TM][TD], dv_acc[TM][TD];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int c = 0; c < TD; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;
  const int nq = (sq + B - 1) / B;
  const int j0 = causal ? k0 / B : 0;  // q tiles ending before k0 see none

  for (int j = j0; j < nq; ++j) {
    const int q0 = j * B;
    if constexpr (kSeg) {
      load_seg<B>(sq_r, seg_q + (long)bi * sq, q0, sq, ty);
      if (!tile_live<B>(sq_r, sk_r, q0, k0, sq, sk, causal, ty, tx)) continue;
    }
    __syncthreads();
    load_tile<T, D, B>(Qs, q + qoff, q0, sq, d, stride, scale);
    load_tile<T, D, B>(dOs, dout + qoff, q0, sq, d, stride, 1.f);
    for (int r = threadIdx.x; r < B; r += kThreads) {
      const bool in = q0 + r < sq;
      lses[r] = in ? lse[(long)bh * sq + q0 + r] : 0.f;
      deltas[r] = in ? delta[(long)bh * sq + q0 + r] : 0.f;
    }
    __syncthreads();
    float s[TM][TM], dp[TM][TM];
    tile_abt<D, B>(s, Qs, Ks, d, ty, tx);
    tile_abt<D, B>(dp, dOs, Vs, d, ty, tx);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = ty + 16 * i, qi = q0 + r;
#pragma unroll
      for (int jj = 0; jj < TM; ++jj) {
        const int c = tx + 16 * jj, kj = k0 + c;
        bool live = qi < sq && kj < sk && !(causal && qi < kj);
        if constexpr (kSeg) live = live && sq_r[i] == sk_r[jj];
        const float p = live ? expf(s[i][jj] - lses[r]) : 0.f;
        Ps[r * LB + c] = p;
        dSs[r * LB + c] = p * (dp[i][jj] - deltas[r]);
      }
    }
    __syncthreads();
    tile_pm<D, B, true>(dv_acc, Ps, dOs, ty, tx);   // dV += P^T dO
    tile_pm<D, B, true>(dk_acc, dSs, Qs, ty, tx);   // dK += dS^T (q * scale)
  }
  store_tile<T, D, B>(dk + koff, dk_acc, k0, sk, d, stride, 1.f, ty, tx);
  store_tile<T, D, B>(dv + koff, dv_acc, k0, sk, d, stride, 1.f, ty, tx);
}

template <int D, int B>
constexpr size_t fwd_smem() {
  return (3 * B * (D + 1) + B * (B + 1)) * sizeof(float);
}
template <int D, int B>
constexpr size_t dq_smem() {
  return (4 * B * (D + 1) + B * (B + 1)) * sizeof(float);
}
template <int D, int B>
constexpr size_t dkv_smem() {
  return (4 * B * (D + 1) + 2 * B * (B + 1) + 2 * B) * sizeof(float);
}

struct Args {
  const void *q, *k, *v, *dout;
  const int *seg_q, *seg_k;  // both null: dense
  const float *lse_in, *delta;
  void *o, *dq, *dk, *dv;
  float* lse_out;
  int b, h, sq, sk, d, causal;
  float scale;
  cudaStream_t stream;
};

enum Kind { kFwd = 0, kDq = 1, kDkv = 2 };

template <typename T, int D, int B, bool kSeg>
cudaError_t launch(Kind kind, const Args& a) {
  const dim3 qgrid((a.sq + B - 1) / B, a.b * a.h);
  const dim3 kgrid((a.sk + B - 1) / B, a.b * a.h);
  cudaError_t err;
  if (kind == kFwd) {
    auto fn = flash_fwd_kernel<T, D, B, kSeg>;
    constexpr size_t smem = fwd_smem<D, B>();
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    fn<<<qgrid, kThreads, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), a.seg_q, a.seg_k, static_cast<T*>(a.o),
        a.lse_out, a.h,
        a.sq, a.sk, a.d, a.scale, a.causal);
  } else if (kind == kDq) {
    auto fn = flash_dq_kernel<T, D, B, kSeg>;
    constexpr size_t smem = dq_smem<D, B>();
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    fn<<<qgrid, kThreads, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), a.seg_q, a.seg_k,
        static_cast<const T*>(a.dout), a.lse_in, a.delta,
        static_cast<T*>(a.dq), a.h, a.sq, a.sk, a.d, a.scale,
        a.causal);
  } else {
    auto fn = flash_dkv_kernel<T, D, B, kSeg>;
    constexpr size_t smem = dkv_smem<D, B>();
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    fn<<<kgrid, kThreads, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), a.seg_q, a.seg_k,
        static_cast<const T*>(a.dout), a.lse_in, a.delta,
        static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.h, a.sq,
        a.sk, a.d, a.scale, a.causal);
  }
  return cudaGetLastError();
}

template <typename T, bool kSeg>
cudaError_t dispatch_d(Kind kind, const Args& a) {
  if (a.d <= 64) return launch<T, 64, 64, kSeg>(kind, a);
  if (a.d <= 128) return launch<T, 128, 64, kSeg>(kind, a);
  return launch<T, 256, 32, kSeg>(kind, a);
}

template <bool kSeg>
cudaError_t dispatch(Kind kind, const Args& a, int dtype) {
  return dtype == 0 ? dispatch_d<float, kSeg>(kind, a)
                    : dispatch_d<__nv_bfloat16, kSeg>(kind, a);
}

int run(Kind kind, const Args& a, int dtype) {
  if (a.b < 1 || a.h < 1 || a.sq < 1 || a.sk < 1 || a.d < 1 || a.d > 256 ||
      (long)a.b * a.h > 65535 || (dtype != 0 && dtype != 1) ||
      (a.seg_q == nullptr) != (a.seg_k == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = a.seg_q != nullptr ? dispatch<true>(kind, a, dtype)
                                             : dispatch<false>(kind, a, dtype);
  return static_cast<int>(err);
}

}  // namespace

// q [b, sq, h, d]; k, v [b, sk, h, d]; o [b, sq, h, d]; lse [b * h, sq]
// fp32. seg_q [b, sq], seg_k [b, sk] int32 segment ids (padding -1), or both
// null for dense attention. dtype: 0 = float32, 1 = bfloat16. All
// contiguous, on one device.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, const void* seg_q,
                                   const void* seg_k, void* o, void* lse,
                                   int b, int h, int sq, int sk, int d,
                                   float scale, int causal, int dtype,
                                   void* stream) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.seg_q = static_cast<const int*>(seg_q);
  a.seg_k = static_cast<const int*>(seg_k);
  a.o = o;
  a.lse_out = static_cast<float*>(lse);
  a.b = b;
  a.h = h;
  a.sq = sq;
  a.sk = sk;
  a.d = d;
  a.causal = causal;
  a.scale = scale;
  a.stream = static_cast<cudaStream_t>(stream);
  return run(kFwd, a, dtype);
}

// dout, dq [b, sq, h, d]; lse, delta [b * h, sq] fp32.
extern "C" int flash_attention_dq(const void* q, const void* k, const void* v,
                                  const void* seg_q, const void* seg_k,
                                  const void* dout, const void* lse,
                                  const void* delta, void* dq, int b, int h,
                                  int sq, int sk, int d, float scale,
                                  int causal, int dtype, void* stream) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.seg_q = static_cast<const int*>(seg_q);
  a.seg_k = static_cast<const int*>(seg_k);
  a.dout = dout;
  a.lse_in = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dq = dq;
  a.b = b;
  a.h = h;
  a.sq = sq;
  a.sk = sk;
  a.d = d;
  a.causal = causal;
  a.scale = scale;
  a.stream = static_cast<cudaStream_t>(stream);
  return run(kDq, a, dtype);
}

// dk, dv [b, sk, h, d].
extern "C" int flash_attention_dkv(const void* q, const void* k,
                                   const void* v, const void* seg_q,
                                   const void* seg_k, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dk, void* dv, int b, int h, int sq,
                                   int sk, int d, float scale, int causal,
                                   int dtype, void* stream) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.seg_q = static_cast<const int*>(seg_q);
  a.seg_k = static_cast<const int*>(seg_k);
  a.dout = dout;
  a.lse_in = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dk = dk;
  a.dv = dv;
  a.b = b;
  a.h = h;
  a.sq = sq;
  a.sk = sk;
  a.d = d;
  a.causal = causal;
  a.scale = scale;
  a.stream = static_cast<cudaStream_t>(stream);
  return run(kDkv, a, dtype);
}
