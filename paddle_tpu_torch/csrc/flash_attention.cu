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
// denominator is clamped to 1e-30, as in the TPU kernels. lse is the
// natural-log one, fp32 [b * h, sq]. delta = rowsum(dO * O) is computed
// outside, as the reference does in XLA.
//
// What bounds them on the H100: operations. Causal attention at b 4, s 2048,
// h 16, d 128 does 2*b*h*s^2*d flops in the forward over 134 MB of bf16
// inputs and outputs, about 500 flops a byte, above the ~295 at which the
// tensor cores, not the memory, become the limit. Nothing of size s x s
// reaches device memory: each block keeps its q tile (or its k/v tile) and
// streams the other operand through shared memory one tile at a time.
//
// Two families of templates; `use_mma` chooses between them before either
// launches (no fallback):
//
// * Tensor cores (`flash_fwd_mma_kernel`, `flash_dq_mma_kernel`,
//   `flash_dkv_mma_kernel`): bf16 where head_dim % 8 == 0 and every tensor
//   the kernel reads or writes by 16-byte copies is 16-byte aligned.
//   Products are `mma.sync.m16n8k16` bf16 x bf16 -> fp32; operands come
//   from shared memory by `ldmatrix` (`.trans` where a tile is the k-major
//   operand: V in the forward, K in dQ, dO and Q in dK/dV); tiles arrive by
//   16-byte `cp.async` (zero-filled past the ragged edge and past d) in two
//   stages, so the next tile loads while this one computes. Shared rows are
//   padded by 16 bytes (D + 8 elements), so the eight row addresses of an
//   `ldmatrix` fall in distinct banks. head_dim is zero-padded to D = 64,
//   128 or 256 in shared memory only.
//   - Forward: four warps; a warp owns 16 MT q rows (MT = 2 at D 64, 1
//     above; two m-tiles share each K/V fragment), K/V tiles of 64 rows (32
//     at D 256). Q stays in shared memory and is re-read by `ldmatrix`. S
//     stays in the accumulators; the online softmax runs on them in the
//     log2 domain (log2 e folded into the scale: one FMA and one
//     `ex2.approx`), row max and sum over the four lanes of a row by
//     `__shfl_xor_sync`; P turns into A fragments in registers (the C
//     layout of two neighbouring m16n8 tiles is the m16k16 A layout) and
//     never touches shared memory. Causal: tiles past the q tile's end are
//     not visited, the element mask runs only on tiles that cross the
//     diagonal or the ragged edge, and the heaviest q tiles launch first.
//   - dQ: four warps; a block owns 64 q rows, a warp 16 (at D 256, 32 rows:
//     two warps share q rows and split dQ's columns, so its fp32
//     accumulators stay in registers). Q and dO stay in shared memory; K
//     and V tiles of 64 keys (32 at D 256) stream in. The warp computes S =
//     Q K^T and dP = dO V^T, then P = exp2(S scale log2 e - lse log2 e) and
//     dS = P (dP - delta) in the accumulators; dS is already the A fragment
//     of dQ += dS K, with K read through `ldmatrix.trans`. Causal tiles
//     past the q tile are not visited and the heaviest q tiles go first, as
//     in the forward. No atomics: each block writes its q rows once.
//   - dK/dV: four warps; a block owns 64 keys, a warp 16 (at D 256, 32
//     keys: two warps share key rows and split dK/dV's columns, so the fp32
//     accumulators stay in registers). K and V stay in shared memory; Q, dO,
//     lse and delta tiles of 32 rows (64 at D 64) stream in. The warp
//     computes S^T = K Q^T and dP^T = V dO^T, so P^T and dS^T are already A
//     fragments of dV += P^T dO and dK += dS^T Q: neither goes through
//     shared memory. No atomics: each block writes its keys once, and the
//     result is deterministic.
//   - Rounding: P and dS enter their products as two bf16 terms each, hi =
//     bf16(x) and lo = bf16(x - hi), two `mma`s (x to 2^-16). One rounding
//     of P and dS (2^-9) would put o, dQ, dK and dV past the bf16 bound
//     that holds the port to its plain versions (2^-7 of the value plus
//     2^-7 of the RMS; tests/test_torch_flash.py
//     test_p_and_ds_need_two_bf16_terms): rows that see few keys carry large
//     terms that nearly cancel. m, l, O, dQ, dK and dV stay fp32; the scale
//     multiplies the fp32 scores, dQ and dK, never bf16 Q.
//   - Registers: ptxas -v's counts are in chip_smoke.py's build phase. At D
//     <= 128 no template spills (the segmented dK/dV walks head_dim four
//     mma steps at a time, which keeps its segment state from spilling); at
//     D 256 the forward and the segmented dK/dV spill a few words; no main
//     path runs D 256.
//
// * CUDA cores (`flash_fwd_kernel`, `flash_dq_kernel`, `flash_dkv_kernel`):
//   fp32, whose products stay fp32 (TF32 keeps 10 bits, and the fp32
//   training parity holds losses to 1e-4), fp16, and bf16 at other
//   head_dims or alignments. 256 threads form a 16 x 16 grid; thread (ty,
//   tx) owns rows ty + 16 i and columns tx + 16 j of every tile product,
//   over fp32 tiles in shared memory padded by one word. Tiles are 64 rows
//   for head_dim <= 128 and 32 rows for head_dim <= 256 (four fp32 tiles of
//   [rows, head_dim]); head_dim is padded with zeros to 64, 128 or 256. The
//   products are scalar FMA loops, far from the tensor cores' rate. fp16
//   loads and stores through the intrinsics; its products are fp32, as
//   bf16's.
//
// Segments are the same templates with kSeg set (kSeg is every template's
// last argument): each thread takes the segment ids of its rows and
// columns, and ANDs seg_q == seg_k into the live mask. A k tile (a q tile in
// dK/dV) in which no pair is live is skipped: the threads test the pairs and
// __syncthreads_or decides for the block (the tensor-core templates first
// compare each streamed id with the min and max of the block's own ids, so
// sorted packed ids skip a dead tile in one test). Under the online softmax
// a tile with no live pair leaves m, l and the accumulators exactly as they
// were (alpha = 1, P = 0), so skipping gives the same bits as computing it;
// in dQ and dK/dV a skipped tile would add P = dS = 0. Packed documents are
// short beside the row, so most tiles off the diagonal blocks are skipped;
// the TPU kernels skip nothing.
//
// Grids: the row (or key) tile on grid.x, b * h on grid.y and, past 65535,
// on grid.z as well (`bh_grid`, any b * h up to 2^31 - 1). Blocks launch
// with x fastest, so one head's tiles run together and share its K/V in L2.
//
// C interface (loaded with ctypes): each entry point returns
// cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

#include "mma_sm90.cuh"

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
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
__device__ __forceinline__ void store(__half* p, float v) {
  *p = __float2half_rn(v);
}

// The block's (batch, head) index: grid.y, continued on grid.z past 65535
// (see bh_grid); -1 for the spare blocks of the last z slice.
__device__ __forceinline__ int bh_index(int nbh) {
  const int bh = blockIdx.y + blockIdx.z * gridDim.y;
  return bh < nbh ? bh : -1;
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
                     float* __restrict__ lse, int nbh, int h, int sq, int sk,
                     int d, float scale, int causal) {
  constexpr int TM = B / 16, TD = D / 16, LD = D + 1, LB = B + 1;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + B * LD;
  float* Vs = Ks + B * LD;
  float* Ps = Vs + B * LD;
  const int bh = bh_index(nbh);
  if (bh < 0) return;
  const int bi = bh / h, hi = bh % h;
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
                    int nbh, int h, int sq, int sk, int d, float scale,
                    int causal) {
  constexpr int TM = B / 16, TD = D / 16, LD = D + 1, LB = B + 1;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + B * LD;
  float* Ks = dOs + B * LD;
  float* Vs = Ks + B * LD;
  float* dSs = Vs + B * LD;
  const int bh = bh_index(nbh);
  if (bh < 0) return;
  const int bi = bh / h, hi = bh % h;
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
                     T* __restrict__ dv, int nbh, int h, int sq, int sk,
                     int d, float scale, int causal) {
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
  const int bh = bh_index(nbh);
  if (bh < 0) return;
  const int bi = bh / h, hi = bh % h;
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

// ---------------------------------------------------------------------------
// Tensor-core templates: bf16, head_dim % 8 == 0, 16-byte aligned tensors.
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;  // four warps

// Rows [row0, row0 + R) of one head (g at its row 0, rows `stride` apart)
// into a [R][D + 8] shared tile by 16-byte cp.async; zeros past `rows` and
// past d.
template <int R, int D>
__device__ __forceinline__ void load_rows(bf16* sm, const bf16* g, int row0,
                                          int rows, int d, long stride) {
  constexpr int CH = D / 8, LDS = D + 8;
  for (int e = threadIdx.x; e < R * CH; e += kMmaThreads) {
    const int r = e / CH, c = (e % CH) * 8;
    const bool in = row0 + r < rows && c < d;
    cp_async16(sm + r * LDS + c, in ? g + (long)(row0 + r) * stride + c : g,
               in);
  }
}

// Rows of one fp32 [b * h, s] vector (lse, delta) into shared memory.
template <int R>
__device__ __forceinline__ void load_vec(float* sm, const float* g, int row0,
                                         int rows) {
  for (int r = threadIdx.x; r < R; r += kMmaThreads) {
    const bool in = row0 + r < rows;
    cp_async4(sm + r, in ? g + row0 + r : g, in);
  }
}

// Segments: does any pair of the tile at `other0` (R rows of the streamed
// side, ids read from `seg` here and kept in `ids`) meet the block's own
// ROWN rows (own_ids' table: ids, then their min and max; `n_own` of them
// in range, own row j at `own0 + j`)? A pair is live where the ids are
// equal, both rows are in range and, when causal, the key is at or before
// the query (kOwnIsQ: the block's rows are the queries). Every thread takes
// one streamed row; a barrier for the whole block.
template <int R, int ROWN, bool kOwnIsQ>
__device__ __forceinline__ bool seg_tile_live(int* ids,
                                              const int* __restrict__ seg,
                                              int other0, int n_other,
                                              const int* own, int own0,
                                              int n_own, int causal) {
  bool any = false;
  const int r = threadIdx.x;
  if (r < R) {
    const int o = other0 + r;
    const int id = o < n_other ? seg[o] : 0;
    ids[r] = id;
    if (o < n_other && id >= own[ROWN] && id <= own[ROWN + 1]) {
      for (int j = 0; j < n_own && !any; ++j) {
        const int mine = own0 + j;
        const bool order = kOwnIsQ ? o <= mine : mine <= o;
        any = own[j] == id && (!causal || order);
      }
    }
  }
  return __syncthreads_or(any) != 0;
}

// Ids of the block's own R rows into ids[0, R), and their min and max over
// the rows in range into ids[R] and ids[R + 1] (kept in shared memory, not
// registers, which the accumulators need). A barrier for the whole block.
template <int R>
__device__ __forceinline__ void own_ids(int* ids, const int* __restrict__ seg,
                                        int row0, int rows) {
  for (int r = threadIdx.x; r < R; r += kMmaThreads)
    ids[r] = row0 + r < rows ? seg[row0 + r] : 0;
  __syncthreads();
  if (threadIdx.x == 0) {
    int lo = INT_MAX, hi = INT_MIN;
    for (int r = 0; r < min(R, rows - row0); ++r) {
      lo = min(lo, ids[r]);
      hi = max(hi, ids[r]);
    }
    ids[R] = lo;
    ids[R + 1] = hi;
  }
  __syncthreads();
}

template <int D, int BK, int MT>
constexpr size_t fwd_mma_smem() {
  return (size_t)(64 * MT + 4 * BK) * (D + 8) * sizeof(bf16) +
         (64 * MT + 2 + 2 * BK) * sizeof(int);
}

// grid (ceil(sq / (64 MT)), b * h), 128 threads. Warp w owns q rows
// 16 MT w .. 16 MT w + 16 MT - 1 of the block's tile (MT m-tiles of 16, so
// each K/V fragment read from shared memory feeds MT products); K/V tiles
// of BK rows stream through two stages. Q stays in shared memory and is
// re-read by ldmatrix; S, P and the online softmax stay in the
// accumulators.
template <int D, int BK, int MT, bool kSeg>
__global__ void __launch_bounds__(kMmaThreads, 2)
    flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const int* __restrict__ seg_q,
                         const int* __restrict__ seg_k, bf16* __restrict__ o,
                         float* __restrict__ lse, int nbh, int h, int sq,
                         int sk, int d, float scale, int causal) {
  constexpr int WR = 16 * MT, BQ = 4 * WR, LDS = D + 8, NT = BK / 8;
  constexpr int ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + BQ * LDS;       // [2][BK][LDS]
  bf16* Vs = Ks + 2 * BK * LDS;   // [2][BK][LDS]
  int* segq_s = reinterpret_cast<int*>(Vs + 2 * BK * LDS);  // [BQ + 2]
  int* segk_s = segq_s + BQ + 2;                             // [2][BK]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = bh_index(nbh);
  if (bh < 0) return;
  const int bi = bh / h, hi = bh % h;
  // the heaviest causal q tiles first, so the light ones fill the tail
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int w0 = q0 + warp * WR;  // the warp's first row
  const long stride = (long)h * d;
  const bf16* qg = q + ((long)bi * sq * h + hi) * d;
  const bf16* kg = k + ((long)bi * sk * h + hi) * d;
  const bf16* vg = v + ((long)bi * sk * h + hi) * d;
  const int* sk_g = kSeg ? seg_k + (long)bi * sk : nullptr;
  const float sl2 = scale * kLog2e;

  if constexpr (kSeg) own_ids<BQ>(segq_s, seg_q + (long)bi * sq, q0, sq);
  int nk = (sk + BK - 1) / BK;
  if (causal) nk = min(nk, (q0 + BQ - 1) / BK + 1);  // tiles starting <= q end
  // the next tile at or after j with a live pair (every tile when dense)
  auto next = [&](int j, int st) {
    if constexpr (kSeg) {
      for (; j < nk; ++j)
        if (seg_tile_live<BK, BQ, true>(segk_s + st * BK, sk_g, j * BK, sk,
                                        segq_s, q0, min(BQ, sq - q0),
                                        causal))
          break;
    }
    return j;
  };
  auto load_kv = [&](int j, int st) {
    load_rows<BK, D>(Ks + st * BK * LDS, kg, j * BK, sk, d, stride);
    load_rows<BK, D>(Vs + st * BK * LDS, vg, j * BK, sk, d, stride);
  };

  // per m-tile: running max (log2 domain) and this thread's share of the
  // row sum, for rows g and g + 8
  float m[MT][2], l[MT][2], oacc[MT][ND][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m[mt][0] = m[mt][1] = kNegInf;
    l[mt][0] = l[mt][1] = 0.f;
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[mt][n][e] = 0.f;
  }

  int j = next(0, 0), st = 0;
  if (j < nk) {
    load_rows<BQ, D>(Qs, qg, q0, sq, d, stride);
    load_kv(j, 0);
    cp_async_commit();
  }
  while (j < nk) {
    const int jn = next(j + 1, st ^ 1);
    if (jn < nk) {  // the next live tile loads while this one computes
      load_kv(jn, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Kt = Ks + st * BK * LDS;
    const bf16* Vt = Vs + st * BK * LDS;
    const int k0 = j * BK;

    // S = Q K^T
    float s[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldsm_x4<false>(a[mt], Qs + (warp * WR + mt * 16 + (lane & 15)) * LDS +
                                  kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        ldsm_x4<false>(b, Kt + (np * 16 + ((lane >> 4) << 3) + (lane & 7)) *
                                   LDS +
                               kk * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma(s[mt][2 * np], a[mt], b[0], b[1]);
          mma(s[mt][2 * np + 1], a[mt], b[2], b[3]);
        }
      }
    }

    // online softmax on the accumulators, in the log2 domain; this thread
    // holds rows w0 + 16 mt + g (+8), columns n * 8 + 2 t (+1)
    if (kSeg || k0 + BK > sk || (causal && k0 + BK - 1 > w0)) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {  // rows g, g + 8
          const int r = w0 + mt * 16 + g + hf * 8;
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = n * 8 + 2 * t + e, kj = k0 + c;
              bool ok = kj < sk && !(causal && kj > r);
              if constexpr (kSeg)
                ok = ok && segk_s[st * BK + c] ==
                               segq_s[r - q0];
              if (!ok) s[mt][n][2 * hf + e] = kNegInf;
            }
        }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float mx = kNegInf;
#pragma unroll
        for (int n = 0; n < NT; ++n)
          mx = fmaxf(mx, fmaxf(s[mt][n][2 * hf], s[mt][n][2 * hf + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        // the scale is folded into the exponent: max(s) sl2 = max(s sl2)
        const float mn = fmaxf(m[mt][hf], mx == kNegInf ? kNegInf : mx * sl2);
        const float alpha = ex2(m[mt][hf] - mn);
        m[mt][hf] = mn;
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            // a masked score adds exactly 0, even where the row has no
            // live key so far (m is then the mask value itself)
            const float x = s[mt][n][2 * hf + e];
            const float p = x == kNegInf ? 0.f : ex2(fmaf(x, sl2, -mn));
            s[mt][n][2 * hf + e] = p;
            sum += p;
          }
        }
        l[mt][hf] = l[mt][hf] * alpha + sum;  // summed over the row at the end
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          oacc[mt][n][2 * hf] *= alpha;
          oacc[mt][n][2 * hf + 1] *= alpha;
        }
      }
    }

    // O += P V, P as two bf16 terms straight from the accumulators
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t ph[MT][4], pl[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        c_to_a(s[mt][2 * kk], s[mt][2 * kk + 1], ph[mt], pl[mt]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t b[4];
        ldsm_x4<true>(b, Vt + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) *
                                  LDS +
                              dp * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma(oacc[mt][2 * dp], ph[mt], b[0], b[1]);
          mma(oacc[mt][2 * dp + 1], ph[mt], b[2], b[3]);
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma(oacc[mt][2 * dp], pl[mt], b[0], b[1]);
          mma(oacc[mt][2 * dp + 1], pl[mt], b[2], b[3]);
        }
      }
    }
    __syncthreads();  // this stage's readers are done before it refills
    j = jn;
    st ^= 1;
  }

  bf16* og = o + ((long)bi * sq * h + hi) * d;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float lr = l[mt][hf];
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      lr = fmaxf(lr, 1e-30f);
      const int r = w0 + mt * 16 + g + hf * 8;
      if (r >= sq) continue;
      // natural-log lse; a row with no live key keeps the mask value
      const float mr = m[mt][hf];
      if (t == 0)
        lse[(long)bh * sq + r] = (mr == kNegInf ? kNegInf : mr * kLn2) +
                                 logf(lr);
      const float inv = 1.f / lr;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const int c = n * 8 + 2 * t;
        if (c >= d) break;
        *reinterpret_cast<__nv_bfloat162*>(og + (long)r * stride + c) =
            __floats2bfloat162_rn(oacc[mt][n][2 * hf] * inv,
                                  oacc[mt][n][2 * hf + 1] * inv);
      }
    }
  }
}

// dK/dV block: BKV = 64 / NH key rows; warp w owns key rows 16 (w % (4 /
// NH)) .. +15 and dK/dV columns [DW c, DW c + DW), c = w / (4 / NH), DW =
// D / NH (NH = 2 for D = 256 keeps the fp32 accumulators in registers).
template <int D, int BQ, int NH>
constexpr size_t dkv_mma_smem() {
  return (size_t)(2 * (64 / NH) + 4 * BQ) * (D + 8) * sizeof(bf16) +
         (size_t)(6 * BQ + 64 / NH + 2) * sizeof(float);
}

// grid (ceil(sk / BKV), b * h), 128 threads. K and V stay in shared memory;
// Q, dO, lse and delta tiles of BQ rows stream through two stages. The warp
// computes S^T = K Q^T and dP^T = V dO^T for its key rows, so P^T and dS^T
// are A fragments of dV += P^T dO and dK += dS^T Q as they stand.
template <int D, int BQ, int NH, bool kSeg>
__global__ void __launch_bounds__(kMmaThreads)
    flash_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const int* __restrict__ seg_q,
                         const int* __restrict__ seg_k,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv,
                         int nbh, int h, int sq, int sk, int d, float scale,
                         int causal) {
  constexpr int BKV = 64 / NH, LDS = D + 8, NT = BQ / 8, DW = D / NH;
  constexpr int ND = DW / 8, WR = 4 / NH;  // warps along the key rows
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + BKV * LDS;
  bf16* Qs = Vs + BKV * LDS;      // [2][BQ][LDS]
  bf16* dOs = Qs + 2 * BQ * LDS;  // [2][BQ][LDS]
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * BQ * LDS);  // [2][BQ]
  float* dl_s = lse_s + 2 * BQ;                                 // [2][BQ]
  int* segq_s = reinterpret_cast<int*>(dl_s + 2 * BQ);          // [2][BQ]
  int* segk_s = segq_s + 2 * BQ;                                // [BKV + 2]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kr = (warp % WR) * 16, c0 = (warp / WR) * DW;
  const int bh = bh_index(nbh);
  if (bh < 0) return;
  const int bi = bh / h, hi = bh % h;
  const int k0 = blockIdx.x * BKV;  // the heaviest causal k tiles first
  const long stride = (long)h * d;
  const bf16* qg = q + ((long)bi * sq * h + hi) * d;
  const bf16* dog = dout + ((long)bi * sq * h + hi) * d;
  const bf16* kg = k + ((long)bi * sk * h + hi) * d;
  const bf16* vg = v + ((long)bi * sk * h + hi) * d;
  const float* lse_g = lse + (long)bh * sq;
  const float* dl_g = delta + (long)bh * sq;
  const int* sq_g = kSeg ? seg_q + (long)bi * sq : nullptr;
  const float sl2 = scale * kLog2e;
  const int kj0 = k0 + kr + g, kj1 = kj0 + 8;  // this thread's key rows

  if constexpr (kSeg) own_ids<BKV>(segk_s, seg_k + (long)bi * sk, k0, sk);
  const int nq = (sq + BQ - 1) / BQ;
  auto next = [&](int j, int st) {
    if constexpr (kSeg) {
      for (; j < nq; ++j)
        if (seg_tile_live<BQ, BKV, false>(segq_s + st * BQ, sq_g, j * BQ,
                                          sq, segk_s, k0, min(BKV, sk - k0),
                                          causal))
          break;
    }
    return j;
  };
  auto load_q = [&](int j, int st) {
    load_rows<BQ, D>(Qs + st * BQ * LDS, qg, j * BQ, sq, d, stride);
    load_rows<BQ, D>(dOs + st * BQ * LDS, dog, j * BQ, sq, d, stride);
    load_vec<BQ>(lse_s + st * BQ, lse_g, j * BQ, sq);
    load_vec<BQ>(dl_s + st * BQ, dl_g, j * BQ, sq);
  };

  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  // q tiles ending before k0 see none of these keys when causal
  int j = next(causal ? k0 / BQ : 0, 0), st = 0;
  if (j < nq) {
    load_rows<BKV, D>(Ks, kg, k0, sk, d, stride);
    load_rows<BKV, D>(Vs, vg, k0, sk, d, stride);
    load_q(j, 0);
    cp_async_commit();
  }
  while (j < nq) {
    const int jn = next(j + 1, st ^ 1);
    if (jn < nq) {
      load_q(jn, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Qt = Qs + st * BQ * LDS;
    const bf16* dOt = dOs + st * BQ * LDS;
    const int q0 = j * BQ;

    // S^T = K Q^T and dP^T = V dO^T over the whole head_dim
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    // segments: head_dim in chunks of 4 mma steps, so their ids' registers
    // fit beside the accumulators without spilling (ptxas)
    constexpr int KC = kSeg ? (D / 16 < 4 ? D / 16 : 4) : D / 16;
#pragma unroll 1
    for (int k4 = 0; k4 < D / 16; k4 += KC) {
#pragma unroll
      for (int kq = 0; kq < KC; ++kq) {
        const int kk = k4 + kq;
        uint32_t ka[4], va[4];
        const int a_off = (kr + (lane & 15)) * LDS + kk * 16 + (lane >> 4) * 8;
        ldsm_x4<false>(ka, Ks + a_off);
        ldsm_x4<false>(va, Vs + a_off);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          const int b_off = (np * 16 + ((lane >> 4) << 3) + (lane & 7)) * LDS +
                            kk * 16 + ((lane >> 3) & 1) * 8;
          uint32_t b[4];
          ldsm_x4<false>(b, Qt + b_off);
          mma(s[2 * np], ka, b[0], b[1]);
          mma(s[2 * np + 1], ka, b[2], b[3]);
          ldsm_x4<false>(b, dOt + b_off);
          mma(dp[2 * np], va, b[0], b[1]);
          mma(dp[2 * np + 1], va, b[2], b[3]);
        }
      }
    }

    // P^T = exp(S^T - lse), dS^T = P^T (dP^T - delta); this thread holds
    // key rows kj0, kj1 and query columns q0 + n * 8 + 2 t (+1)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float l2 = lse_s[st * BQ + n * 8 + 2 * t + e] * kLog2e;
        s[n][e] = ex2(fmaf(s[n][e], sl2, -l2));
        s[n][2 + e] = ex2(fmaf(s[n][2 + e], sl2, -l2));
      }
    if (kSeg || q0 + BQ > sq || k0 + BKV > sk ||
        (causal && q0 < k0 + kr + 15)) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = n * 8 + 2 * t + e, qi = q0 + c;
          bool ok0 = qi < sq && kj0 < sk && !(causal && kj0 > qi);
          bool ok1 = qi < sq && kj1 < sk && !(causal && kj1 > qi);
          if constexpr (kSeg) {
            const int id = segq_s[st * BQ + c];
            ok0 = ok0 && id == segk_s[kr + g];
            ok1 = ok1 && id == segk_s[kr + g + 8];
          }
          if (!ok0) s[n][e] = 0.f;
          if (!ok1) s[n][2 + e] = 0.f;
        }
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float dl = dl_s[st * BQ + n * 8 + 2 * t + e];
        dp[n][e] = s[n][e] * (dp[n][e] - dl);
        dp[n][2 + e] = s[n][2 + e] * (dp[n][2 + e] - dl);
      }

    // dV += P^T dO, dK += dS^T Q; P^T and dS^T as two bf16 terms each
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t ph[4], pl[4], sh[4], sl[4];
      c_to_a(s[2 * kk], s[2 * kk + 1], ph, pl);
      c_to_a(dp[2 * kk], dp[2 * kk + 1], sh, sl);
#pragma unroll
      for (int np = 0; np < DW / 16; ++np) {
        const int col = c0 + np * 16;
        const int b_off = (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) *
                              LDS + col + (lane >> 4) * 8;
        uint32_t b[4];
        ldsm_x4<true>(b, dOt + b_off);
        mma(dva[2 * np], ph, b[0], b[1]);
        mma(dva[2 * np + 1], ph, b[2], b[3]);
        mma(dva[2 * np], pl, b[0], b[1]);
        mma(dva[2 * np + 1], pl, b[2], b[3]);
        ldsm_x4<true>(b, Qt + b_off);
        mma(dka[2 * np], sh, b[0], b[1]);
        mma(dka[2 * np + 1], sh, b[2], b[3]);
        mma(dka[2 * np], sl, b[0], b[1]);
        mma(dka[2 * np + 1], sl, b[2], b[3]);
      }
    }
    __syncthreads();
    j = jn;
    st ^= 1;
  }

  bf16* dkg = dk + ((long)bi * sk * h + hi) * d;
  bf16* dvg = dv + ((long)bi * sk * h + hi) * d;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int c = c0 + n * 8 + 2 * t;
    if (c >= d) break;
    if (kj0 < sk) {
      *reinterpret_cast<__nv_bfloat162*>(dkg + (long)kj0 * stride + c) =
          __floats2bfloat162_rn(dka[n][0] * scale, dka[n][1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dvg + (long)kj0 * stride + c) =
          __floats2bfloat162_rn(dva[n][0], dva[n][1]);
    }
    if (kj1 < sk) {
      *reinterpret_cast<__nv_bfloat162*>(dkg + (long)kj1 * stride + c) =
          __floats2bfloat162_rn(dka[n][2] * scale, dka[n][3] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dvg + (long)kj1 * stride + c) =
          __floats2bfloat162_rn(dva[n][2], dva[n][3]);
    }
  }
}

// dQ block: BQ = 64 / NH q rows; warp w owns q rows 16 (w % (4 / NH)) ..
// +15 and dQ columns [DW c, DW c + DW), c = w / (4 / NH), DW = D / NH
// (NH = 2 for D = 256 keeps the fp32 accumulators in registers).
template <int D, int BK, int NH>
constexpr size_t dq_mma_smem() {
  return (size_t)(2 * (64 / NH) + 4 * BK) * (D + 8) * sizeof(bf16) +
         (size_t)(64 / NH + 2 + 2 * BK) * sizeof(int);
}

// grid (ceil(sq / BQ), b * h), 128 threads. Q and dO stay in shared memory;
// K and V tiles of BK rows stream through two stages. The warp computes S =
// Q K^T and dP = dO V^T for its q rows; P and dS stay in the accumulators,
// and dS, as two bf16 terms, is the A fragment of dQ += dS K.
template <int D, int BK, int NH, bool kSeg>
__global__ void __launch_bounds__(kMmaThreads)
    flash_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const int* __restrict__ seg_q,
                        const int* __restrict__ seg_k,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        bf16* __restrict__ dq, int nbh, int h, int sq, int sk,
                        int d, float scale, int causal) {
  constexpr int BQ = 64 / NH, LDS = D + 8, NT = BK / 8, DW = D / NH;
  constexpr int ND = DW / 8, WR = 4 / NH;  // warps along the q rows
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = Qs + BQ * LDS;
  bf16* Ks = dOs + BQ * LDS;      // [2][BK][LDS]
  bf16* Vs = Ks + 2 * BK * LDS;   // [2][BK][LDS]
  int* segq_s = reinterpret_cast<int*>(Vs + 2 * BK * LDS);  // [BQ + 2]
  int* segk_s = segq_s + BQ + 2;                             // [2][BK]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qr = (warp % WR) * 16, c0 = (warp / WR) * DW;
  const int bh = bh_index(nbh);
  if (bh < 0) return;
  const int bi = bh / h, hi = bh % h;
  // the heaviest causal q tiles first, so the light ones fill the tail
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int w0 = q0 + qr;                      // the warp's first row
  const int r0 = w0 + g, r1 = r0 + 8;          // this thread's rows
  const long stride = (long)h * d;
  const bf16* qg = q + ((long)bi * sq * h + hi) * d;
  const bf16* dog = dout + ((long)bi * sq * h + hi) * d;
  const bf16* kg = k + ((long)bi * sk * h + hi) * d;
  const bf16* vg = v + ((long)bi * sk * h + hi) * d;
  const int* sk_g = kSeg ? seg_k + (long)bi * sk : nullptr;
  const float sl2 = scale * kLog2e;
  // lse in the log2 domain and delta for rows r0 and r1 (0 past sq, where
  // Q and dO are 0 and so is dS)
  const float* lse_g = lse + (long)bh * sq;
  const float* dl_g = delta + (long)bh * sq;
  const float l2_0 = r0 < sq ? lse_g[r0] * kLog2e : 0.f;
  const float l2_1 = r1 < sq ? lse_g[r1] * kLog2e : 0.f;
  const float dl_0 = r0 < sq ? dl_g[r0] : 0.f;
  const float dl_1 = r1 < sq ? dl_g[r1] : 0.f;

  if constexpr (kSeg) own_ids<BQ>(segq_s, seg_q + (long)bi * sq, q0, sq);
  int nk = (sk + BK - 1) / BK;
  if (causal) nk = min(nk, (q0 + BQ - 1) / BK + 1);  // tiles starting <= q end
  // the next tile at or after j with a live pair (every tile when dense)
  auto next = [&](int j, int st) {
    if constexpr (kSeg) {
      for (; j < nk; ++j)
        if (seg_tile_live<BK, BQ, true>(segk_s + st * BK, sk_g, j * BK, sk,
                                        segq_s, q0, min(BQ, sq - q0),
                                        causal))
          break;
    }
    return j;
  };
  auto load_kv = [&](int j, int st) {
    load_rows<BK, D>(Ks + st * BK * LDS, kg, j * BK, sk, d, stride);
    load_rows<BK, D>(Vs + st * BK * LDS, vg, j * BK, sk, d, stride);
  };

  float dqa[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[n][e] = 0.f;

  int j = next(0, 0), st = 0;
  if (j < nk) {
    load_rows<BQ, D>(Qs, qg, q0, sq, d, stride);
    load_rows<BQ, D>(dOs, dog, q0, sq, d, stride);
    load_kv(j, 0);
    cp_async_commit();
  }
  while (j < nk) {
    const int jn = next(j + 1, st ^ 1);
    if (jn < nk) {  // the next live tile loads while this one computes
      load_kv(jn, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Kt = Ks + st * BK * LDS;
    const bf16* Vt = Vs + st * BK * LDS;
    const int k0 = j * BK;

    // S = Q K^T and dP = dO V^T over the whole head_dim
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4], da[4];
      const int a_off = (qr + (lane & 15)) * LDS + kk * 16 + (lane >> 4) * 8;
      ldsm_x4<false>(qa, Qs + a_off);
      ldsm_x4<false>(da, dOs + a_off);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        const int b_off = (np * 16 + ((lane >> 4) << 3) + (lane & 7)) * LDS +
                          kk * 16 + ((lane >> 3) & 1) * 8;
        uint32_t b[4];
        ldsm_x4<false>(b, Kt + b_off);
        mma(s[2 * np], qa, b[0], b[1]);
        mma(s[2 * np + 1], qa, b[2], b[3]);
        ldsm_x4<false>(b, Vt + b_off);
        mma(dp[2 * np], da, b[0], b[1]);
        mma(dp[2 * np + 1], da, b[2], b[3]);
      }
    }

    // P = exp2(S sl2 - lse log2 e), zero where the pair is not live (set,
    // not multiplied: a dead row's lse makes the exponent +inf); dS = P (dP
    // - delta). This thread holds rows r0, r1 and key columns k0 + n * 8 +
    // 2 t (+1).
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[n][e] = ex2(fmaf(s[n][e], sl2, -l2_0));
        s[n][2 + e] = ex2(fmaf(s[n][2 + e], sl2, -l2_1));
      }
    if (kSeg || k0 + BK > sk || (causal && k0 + BK - 1 > w0)) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = n * 8 + 2 * t + e, kj = k0 + c;
          bool ok0 = kj < sk && !(causal && kj > r0);
          bool ok1 = kj < sk && !(causal && kj > r1);
          if constexpr (kSeg) {
            const int id = segk_s[st * BK + c];
            ok0 = ok0 && id == segq_s[qr + g];
            ok1 = ok1 && id == segq_s[qr + g + 8];
          }
          if (!ok0) s[n][e] = 0.f;
          if (!ok1) s[n][2 + e] = 0.f;
        }
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        dp[n][e] = s[n][e] * (dp[n][e] - dl_0);
        dp[n][2 + e] = s[n][2 + e] * (dp[n][2 + e] - dl_1);
      }

    // dQ += dS K, dS as two bf16 terms; K is the k-major operand
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t sh[4], sl[4];
      c_to_a(dp[2 * kk], dp[2 * kk + 1], sh, sl);
#pragma unroll
      for (int np = 0; np < DW / 16; ++np) {
        const int b_off = (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) *
                              LDS + c0 + np * 16 + (lane >> 4) * 8;
        uint32_t b[4];
        ldsm_x4<true>(b, Kt + b_off);
        mma(dqa[2 * np], sh, b[0], b[1]);
        mma(dqa[2 * np + 1], sh, b[2], b[3]);
        mma(dqa[2 * np], sl, b[0], b[1]);
        mma(dqa[2 * np + 1], sl, b[2], b[3]);
      }
    }
    __syncthreads();  // this stage's readers are done before it refills
    j = jn;
    st ^= 1;
  }

  // every row in range is written: a row with no live key gets 0
  bf16* dqg = dq + ((long)bi * sq * h + hi) * d;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int c = c0 + n * 8 + 2 * t;
    if (c >= d) break;
    if (r0 < sq)
      *reinterpret_cast<__nv_bfloat162*>(dqg + (long)r0 * stride + c) =
          __floats2bfloat162_rn(dqa[n][0] * scale, dqa[n][1] * scale);
    if (r1 < sq)
      *reinterpret_cast<__nv_bfloat162*>(dqg + (long)r1 * stride + c) =
          __floats2bfloat162_rn(dqa[n][2] * scale, dqa[n][3] * scale);
  }
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

// (tiles, b * h) blocks: b * h on grid.y, continued on grid.z when it
// passes grid.y's 65535 (the kernels read it back with bh_index).
dim3 bh_grid(int tiles, long bh) {
  const long z = (bh + 65534) / 65535;
  return dim3(tiles, (unsigned)((bh + z - 1) / z), (unsigned)z);
}

template <typename F>
cudaError_t set_smem(F fn, size_t smem) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <typename T, int D, int B, bool kSeg>
cudaError_t launch(Kind kind, const Args& a) {
  const int nbh = a.b * a.h;
  const dim3 qgrid = bh_grid((a.sq + B - 1) / B, nbh);
  const dim3 kgrid = bh_grid((a.sk + B - 1) / B, nbh);
  cudaError_t err;
  if (kind == kFwd) {
    auto fn = flash_fwd_kernel<T, D, B, kSeg>;
    constexpr size_t smem = fwd_smem<D, B>();
    if ((err = set_smem(fn, smem)) != cudaSuccess) return err;
    fn<<<qgrid, kThreads, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), a.seg_q, a.seg_k, static_cast<T*>(a.o),
        a.lse_out, nbh, a.h, a.sq, a.sk, a.d, a.scale, a.causal);
  } else if (kind == kDq) {
    auto fn = flash_dq_kernel<T, D, B, kSeg>;
    constexpr size_t smem = dq_smem<D, B>();
    if ((err = set_smem(fn, smem)) != cudaSuccess) return err;
    fn<<<qgrid, kThreads, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), a.seg_q, a.seg_k,
        static_cast<const T*>(a.dout), a.lse_in, a.delta,
        static_cast<T*>(a.dq), nbh, a.h, a.sq, a.sk, a.d, a.scale,
        a.causal);
  } else {
    auto fn = flash_dkv_kernel<T, D, B, kSeg>;
    constexpr size_t smem = dkv_smem<D, B>();
    if ((err = set_smem(fn, smem)) != cudaSuccess) return err;
    fn<<<kgrid, kThreads, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), a.seg_q, a.seg_k,
        static_cast<const T*>(a.dout), a.lse_in, a.delta,
        static_cast<T*>(a.dk), static_cast<T*>(a.dv), nbh, a.h, a.sq,
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

// dtype: 0 = float32, 1 = bfloat16, 2 = float16
template <bool kSeg>
cudaError_t dispatch(Kind kind, const Args& a, int dtype) {
  if (dtype == 0) return dispatch_d<float, kSeg>(kind, a);
  if (dtype == 1) return dispatch_d<__nv_bfloat16, kSeg>(kind, a);
  return dispatch_d<__half, kSeg>(kind, a);
}

// The tensor-core templates at head_dim's D: forward K/V tile BK and
// m-tiles a warp MT; dQ K/V tile QK and column halves QH; dK/dV q tile BQ
// and column halves NH.
template <int D, int BK, int MT, int QK, int QH, int BQ, int NH, bool kSeg>
cudaError_t launch_mma(Kind kind, const Args& a) {
  cudaError_t err;
  const int nbh = a.b * a.h;
  if (kind == kFwd) {
    auto fn = flash_fwd_mma_kernel<D, BK, MT, kSeg>;
    constexpr size_t smem = fwd_mma_smem<D, BK, MT>();
    if ((err = set_smem(fn, smem)) != cudaSuccess) return err;
    fn<<<bh_grid((a.sq + 64 * MT - 1) / (64 * MT), nbh), kMmaThreads, smem,
         a.stream>>>(static_cast<const bf16*>(a.q),
                     static_cast<const bf16*>(a.k),
                     static_cast<const bf16*>(a.v), a.seg_q, a.seg_k,
                     static_cast<bf16*>(a.o), a.lse_out, nbh, a.h, a.sq,
                     a.sk, a.d, a.scale, a.causal);
  } else if (kind == kDq) {
    constexpr int BQD = 64 / QH;
    auto fn = flash_dq_mma_kernel<D, QK, QH, kSeg>;
    constexpr size_t smem = dq_mma_smem<D, QK, QH>();
    if ((err = set_smem(fn, smem)) != cudaSuccess) return err;
    fn<<<bh_grid((a.sq + BQD - 1) / BQD, nbh), kMmaThreads, smem,
         a.stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), a.seg_q, a.seg_k,
        static_cast<const bf16*>(a.dout), a.lse_in, a.delta,
        static_cast<bf16*>(a.dq), nbh, a.h, a.sq, a.sk, a.d, a.scale,
        a.causal);
  } else {
    constexpr int BKV = 64 / NH;
    auto fn = flash_dkv_mma_kernel<D, BQ, NH, kSeg>;
    constexpr size_t smem = dkv_mma_smem<D, BQ, NH>();
    if ((err = set_smem(fn, smem)) != cudaSuccess) return err;
    fn<<<bh_grid((a.sk + BKV - 1) / BKV, nbh), kMmaThreads, smem,
         a.stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), a.seg_q, a.seg_k,
        static_cast<const bf16*>(a.dout), a.lse_in, a.delta,
        static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), nbh, a.h, a.sq,
        a.sk, a.d, a.scale, a.causal);
  }
  return cudaGetLastError();
}

template <bool kSeg>
cudaError_t dispatch_mma(Kind kind, const Args& a) {
  if (a.d <= 64) return launch_mma<64, 64, 2, 64, 1, 64, 1, kSeg>(kind, a);
  if (a.d <= 128) return launch_mma<128, 64, 1, 64, 1, 32, 1, kSeg>(kind, a);
  return launch_mma<256, 32, 1, 32, 2, 32, 2, kSeg>(kind, a);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Which of two hand-written kernels runs: the tensor-core templates take
// bf16 where head_dim % 8 == 0 and every q, k, v and output pointer (dout
// too in the backward) is 16-byte aligned, as their 16-byte cp.async rows
// need; everything else takes the CUDA-core templates: fp32, whose
// products stay in fp32 (TF32 keeps 10 bits), fp16, and bf16 at other
// head_dims or alignments. No fallback: the choice is made here, before
// either launches.
bool use_mma(Kind kind, const Args& a, int dtype) {
  if (dtype != 1 || a.d % 8 != 0) return false;
  if (!aligned16(a.q) || !aligned16(a.k) || !aligned16(a.v)) return false;
  if (kind == kFwd) return aligned16(a.o);
  if (!aligned16(a.dout)) return false;
  return kind == kDq ? aligned16(a.dq) : aligned16(a.dk) && aligned16(a.dv);
}

int run(Kind kind, const Args& a, int dtype) {
  if (a.b < 1 || a.h < 1 || a.sq < 1 || a.sk < 1 || a.d < 1 || a.d > 256 ||
      (long)a.b * a.h > INT_MAX || dtype < 0 || dtype > 2 ||
      (a.seg_q == nullptr) != (a.seg_k == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool seg = a.seg_q != nullptr;
  cudaError_t err;
  if (use_mma(kind, a, dtype))
    err = seg ? dispatch_mma<true>(kind, a) : dispatch_mma<false>(kind, a);
  else
    err = seg ? dispatch<true>(kind, a, dtype)
              : dispatch<false>(kind, a, dtype);
  return static_cast<int>(err);
}

}  // namespace

// q [b, sq, h, d]; k, v [b, sk, h, d]; o [b, sq, h, d]; lse [b * h, sq]
// fp32. seg_q [b, sq], seg_k [b, sk] int32 segment ids (padding -1), or both
// null for dense attention. dtype: 0 = float32, 1 = bfloat16, 2 =
// float16. All contiguous, on one device.
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
