// Fused multi-head attention for training, forward and backward, for
// Hopper (sm_90a).
//
// Replaces the training-attention Pallas TPU kernels of
// paddle_tpu/kernels/attention.py, of all its tiers. The forward
// (attn_fwd) replaces _fwd_kernel (:294), _fwd_kernel_long (:362),
// _flash_fwd_kernel (:602), _packed_fwd_kernel (:917) and
// _res_fwd_kernel (:1170); the backward pair the others:
//   * _fwd_kernel  (via _pallas_attention):      o = softmax(q.k^T*scale +
//                  bias) . v per (batch block, head), dropout on the
//                  normalised weights with a 1/(1-p) upscale;
//   * _bwd_kernel  (via _pallas_attention_bwd):  dq, dk, dv in q's type and
//                  dbias in fp32, reduced to the bias's broadcast shape;
//   * _fwd_kernel_long, _bwd_kernel_long (1024 < S <= 4096), and
//     _flash_fwd_kernel, _flash_dq_kernel, _flash_dkdv_kernel (longer):
//                  the same functions; the flash forward also returns the
//                  row logsumexp, which attn_fwd writes at every S;
//   * _packed_fwd_kernel, _packed_bwd_kernel (S <= 256), and
//     _res_fwd_kernel, _res_dq_kernel, _res_dkdv_kernel (S <= 1024, heads
//     in pairs): the same functions on operands in the packed [B, S, H*d]
//     layout the q/k/v projections write. The TPU kernels split heads in
//     VMEM; here every operand is read and written through element
//     strides (batch, head, row), so the packed layout is the strided
//     view (S*H*d, d, H*d) of the same kernels and costs no transpose.
//
// The TPU kernels hold a whole [S, S] score tile of a batch block in VMEM
// (its long tier a [Qb, S] tile, its flash tier [Tb, Tb] tiles). At S = 512
// one head's fp32 tile is 1 MB, four times the 227 KB of shared memory a
// Hopper block can have, so these kernels tile both the queries and the
// keys at every S (the flash-attention-2 scheme, as the TPU's flash tier):
//   * attn_fwd, one block per (q-tile, head, batch): K/V tiles stream
//     through shared memory; an online softmax keeps the row max m, the
//     row sum l and the output accumulator in registers; it writes o in
//     q's type and the row logsumexp lse = m + log(l) [B, H, S] in fp32.
//   * attn_bwd_dq, one block per (q-tile, head, batch): first
//     delta = rowsum(dO * O) for its rows (written out for the next
//     kernel), then a loop over k-tiles that regenerates p = exp(s - lse)
//     and accumulates dq.
//   * attn_bwd_dkdv, one block per (k-tile, head, batch): a loop over
//     q-tiles that regenerates p and accumulates dk and dv, and dbias.
// dbias: a bias with a row per query is written per element; a
// row-broadcast bias ([.., 1, S]) is summed over the query rows inside the
// dk/dv block; a head-broadcast bias ([B, 1, ..]) is summed over heads
// with fp32 atomicAdd into a zeroed buffer, so its last bits depend on the
// order the heads' blocks finish in.
//
// Bias: fp32, read through element strides (b, h, row) with the key
// column contiguous; a stride of 0 broadcasts that dimension, so all four
// shapes [B, 1|H, 1|S, S] take one code path.
//
// Layout: q, k, v, o, dout, dq, dk and dv are each addressed through
// their own element strides (batch, head, row), the d elements of a row
// contiguous: [B, H, S, d] contiguous is (H*S*d, S*d, d), the packed
// [B, S, H*d] layout (S*H*d, d, H*d). lse and delta are [B, H, S] fp32.
//
// Any S: nothing in shared memory or registers grows with S (a block
// loops over S / 64 tiles), and every offset into a tensor is computed in
// 64 bits (long long strides, size_t dbias offsets), because a per-row bias
// or its gradient passes 2^31 elements at B = 3, H = 12, S = 8192; the
// Philox counter holds row / 4 and b * H + h, far below 2^32.
//
// Dropout: Philox4x32-10 keyed on the op's 64-bit seed (read from device
// memory, so drawing it costs the host no sync). Element (b, h, row, col)
// takes output (row & 3) of the call with counter
// (col, row >> 2, b * H + h, 0): the mask depends on the element, not on
// the tiling, so the forward and both backward kernels regenerate the
// same mask (a thread's four query rows are 4r..4r+3 and share one call).
// The uniform is (bits >> 8) * 2^-24, kept where u >= p and scaled by
// 1/(1-p), as in _attn_block_fwd. The softmax denominator uses the
// undropped weights; only the accumulation is masked.
//
// Head widths: d 16, 32, 64, 128 and 256 are built, and past 256 every
// multiple of 64 (attn_*_wide, which split the outputs' columns across
// blocks); the wrappers zero-pad any other d up to the next of these
// (zero columns leave q.k^T unchanged and come out of P.V as zero
// columns) and slice the outputs back. Types: float32, bfloat16 and
// float16. At d 256 the SIMT forward holds its 64-row tiles at one block
// an SM in every type, the fp32 backward tiles 32 rows (kBwdRows), and
// the tensor-core backward splits dq, dk and dv into two 128-column
// halves, one per block (kHalves): each block computes S and dP over the
// whole d.
//
// Bound on the card, per (b, h) pair: 4 * S^2 * d operations (q.k^T and
// p.v) on 4 * S * d * sizeof(T) bytes of q, k, v and o, S / sizeof(T)
// operations a byte at any d. In fp32 (three TF32 products on the tensor
// cores, 165 TFLOP/s of fp32-accurate products, against 3.35 TB/s, 49 a
// byte) the operations bound it from S = 200. In
// bf16 and fp16 (989 TFLOP/s on the tensor cores, 295 a byte) they bound
// it from S = 590: the long and flash shapes (S 2048 to 8192) are bound by
// the tensor cores' rate, BERT's S = 128 (config 3, the packed layout) by
// the bytes of q, k, v and o. The backward does 10 units of S^2 * d.
//
// fp32 runs on the tensor cores as 3xTF32, the forward up to d 128 and the
// backward up to d 64 (attn_fwd_tf32x3, attn_bwd_dq_tf32x3,
// attn_bwd_dkdv_tf32x3; their note is beside them). The forward at d 256
// in every type and the fp32 backward at d 128 and 256 compute
// everything in fp32 on the SIMT cores (16-bit tiles are converted to
// fp32 as they land in shared memory), as do the kernels past d 256.
// 256 threads; each holds a 4 x 4 micro-tile of the 64 x 64 score tile (query rows
// 4ty..4ty+3, key columns tx + 16j; 2 x 2 of a 32 x 32 tile in the d 256
// backward) and a 4 x d/16 slice of its accumulators. Shared tiles keep
// an odd row stride (d + 1, 65), so every read of a row or of a column
// across the lanes of a warp is free of bank conflicts. Loads are
// synchronous; two or three resident blocks per SM overlap them. The
// 16-bit forward up to d 128 runs on the tensor cores (attn_fwd_mma,
// below).
//
// The 16-bit backward (attn_bwd_dq_mma, attn_bwd_dkdv_mma, templates on
// bf16 and fp16: only the mma.sync type suffix and the fp32 -> 16-bit
// rounding differ) runs its products on the tensor cores (the forward,
// attn_fwd_mma, shares its instruction, tiles and mask; its own note is
// beside it):
//   * instruction: mma.sync m16n8k16, 16-bit operands, fp32 accumulators,
//     fed by ldmatrix.x4 from 16-bit shared tiles (.trans where the
//     operand is needed transposed: K in dq += dS . K, dO and Q in dk/dv);
//   * tiling: 128 threads a block, one block per (64-row tile, head,
//     batch), each warp owning 16 rows: dq's warps 16 queries against
//     every 64-key tile (S = Q.K^T, dP = dO.V^T, then dq += dS.K); dk/dv's
//     warps 16 keys against every 64-query tile, computing S^T = K.Q^T
//     and dP^T = V.dO^T, so that P^T and dS^T land in the accumulator
//     layout, which is the A layout of dV += P^T.dO and dK += dS^T.Q (the
//     flash-attention-2 backward's arrangement): no score tile goes
//     through shared memory, P and dS are rounded to the 16-bit type in
//     registers;
//   * shared layout: 16-bit tiles with rows padded by 16 bytes (row
//     stride d + 8 elements), so the eight row addresses of an ldmatrix
//     phase fall on eight different 16-byte bank groups (d / 8 + 1 is odd
//     for every d), chosen over an XOR swizzle because the padded address
//     is one multiply-add and the cp.async writes stay 16-byte aligned. At
//     d 64 a block holds six 64 x 72 tiles (Q and dO, K and V twice, or
//     K and V, Q and dO twice), 55 KB, three blocks to an SM; at d 128,
//     102 KB, two; at d 256, 204 KB, one;
//   * pipeline: the streamed tiles (K, V in dq; Q, dO, lse and delta in
//     dk/dv) are double-buffered: after the barrier that publishes tile j,
//     each thread issues 16-byte cp.async copies of tile j + 1 (rows past
//     S zero-filled by a source size of 0), which run under tile j's
//     math; one barrier a tile. Each row must start on a 16-byte boundary
//     (the wrappers copy an operand that does not);
//   * dropout mask: the same element-keyed Philox mask, but an m16n8
//     fragment holds rows lane/4 and lane/4 + 8 and columns 2(lane%4) +
//     {0, 1}, not a call's four rows; so the block draws each 64 x 64 tile
//     together before its barrier (keep_bits: 1024 calls, eight a thread,
//     packed by ballots into a 512-byte bitmask, double-buffered) and
//     each thread reads its bits from shared memory. Both kernels draw
//     it, as the SIMT kernels did: at p > 0 the draws cost about a third
//     to a half of a kernel's time;
//   * dbias comes from the fp32 dS before it is rounded: per element for
//     a bias row per query; for a row-broadcast bias each thread sums its
//     query columns, and the four lanes that share a key add theirs by
//     shuffles in a fixed order (a warp owns its 16 keys whole, so no
//     shared-memory pass is needed); over heads by fp32 atomics;
//   * registers: dq holds its 16 x d accumulator, the 16 x 64 S and dP
//     tiles (d/2 + 64 fp32 a thread); dk/dv its dk and dv accumulators (d
//     fp32 a thread) and S^T and dP^T over 32 query columns at a time
//     (64 at d 16), one such chunk live at a time. __launch_bounds__ pins
//     the resident blocks the shared memory allows: three at d <= 64 (at
//     most 168 registers), two at d = 128 (255). In trials on the H100,
//     three blocks ran dk/dv clearly faster than two, and at 168
//     registers dk/dv spilled until its bias and dbias addresses were
//     formed per chunk (late()) instead of held across the products.
// What bounds it on the card: the operations, at mma.sync's rate, and
// the SIMT work per score element (exp, bias, mask, dS: about 20
// instructions) that runs beside them; dk/dv also the shared-memory
// reads, since a warp's B fragments each feed two products only.
// Next: wgmma and TMA (a warpgroup's 64-row products, B from shared
// memory without ldmatrix), one q.k^T recompute fewer (a fused pass with
// dq by fp32 atomics).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>
#include <initializer_list>
#include <type_traits>

namespace {

constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kB = 64;         // rows of a q-tile and of a k-tile
constexpr int kLP = kB + 1;    // row stride of a score tile in shared memory

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ void store(float v, float* p) { *p = v; }
__device__ __forceinline__ void store(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ void store(float v, __half* p) {
  *p = __float2half(v);
}

struct BiasView {
  const float* ptr;      // nullptr: no bias
  long long sb, sh, sr;  // element strides of batch, head, row (0 = bcast)
};

// element strides of batch, head and row of a [B, H, S, d] operand whose
// d elements are contiguous
struct Strides {
  long long b, h, r;
};

// the first element of head (b, h) of an operand
template <typename P>
__device__ __forceinline__ P* head_of(P* p, Strides s, int b, int h) {
  return p + b * s.b + h * s.h;
}

// Philox4x32-10 (Salmon et al., SC'11; Random123's constants).
__device__ __forceinline__ uint4 philox(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k.x += 0x9E3779B9u;
      k.y += 0xBB67AE85u;
    }
    const unsigned hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const unsigned hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

__device__ __forceinline__ uint2 seed_key(const long long* seed) {
  const unsigned long long s = static_cast<unsigned long long>(seed[0]);
  return make_uint2(static_cast<unsigned>(s), static_cast<unsigned>(s >> 32));
}

// keep flags of a thread's R rows row0 .. row0 + R - 1 at key column col:
// words (row0 & 3) + i of one Philox call (R 4 with row0 % 4 == 0, or R 2
// with row0 even)
template <int R>
__device__ __forceinline__ void keep_rows(uint2 key, int col, int row0,
                                          int bh, float p_drop,
                                          bool keep[R]) {
  static_assert(R == 2 || R == 4, "a thread keeps 2 or 4 rows");
  const uint4 r = philox(make_uint4(col, row0 >> 2, bh, 0), key);
  const bool up = R == 2 && (row0 & 2);
  const unsigned w[4] = {up ? r.z : r.x, up ? r.w : r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < R; ++i)
    keep[i] = static_cast<float>(w[i] >> 8) * (1.0f / 16777216.0f) >= p_drop;
}

// Rows [0, n) of a global tile of D-element rows, ``rs`` elements apart
// -> fp32 shared [Rows][D + 1]; rows n..Rows-1 are zero. A thread keeps
// one column and walks its rows with one pointer, so the runtime row
// stride costs one 64-bit add a row, not an address register per load.
// At D 256 a pass of the block covers one row.
template <typename T, int D, int Rows = kB>
__device__ __forceinline__ void load_tile(float* s, const T* g, long long rs,
                                          int n) {
  constexpr int kCols = D < kThreads ? D : kThreads;
  constexpr int kStep = kThreads / kCols;  // rows one pass covers
  const long long stride = rs;         // elements from one row to the next
  const int c = threadIdx.x % kCols;
  const T* p = g + (threadIdx.x / kCols) * stride + c;
#pragma unroll 4
  for (int r = threadIdx.x / kCols; r < Rows; r += kStep,
       p += kStep * stride) {
#pragma unroll
    for (int e = 0; e < D; e += kCols)
      s[r * (D + 1) + c + e] = r < n ? to_f32(p[e]) : 0.f;
  }
}

// Resident blocks per SM each kernel is compiled for (its register cap,
// 65536 / (256 * blocks)): what its shared memory allows at d <= 64, as
// the contiguous-only kernels reached with 80 and 126 registers; one at
// d >= 128, whose tiles fill the shared memory.
template <int D> constexpr int kFwdBlocks = D <= 64 ? 3 : 1;
template <int D> constexpr int kBwdBlocks = D <= 64 ? 2 : 1;
// Rows of a q-tile and of a k-tile of the fp32 backward: 64, and 32 at
// d 256, where four 64-row fp32 tiles (263 KB) would pass the 227 KB of
// shared memory a block can have; a thread then holds a 2 x 2 micro-tile.
template <int D> constexpr int kBwdRows = D > 128 ? 32 : 64;

// s[i][j] = sum_k A[R ty + i][k] * Bt[tx + 16j][k] over two [.][D + 1]
// tiles: the thread's R x R micro-tile of a 16R x 16R score tile
template <int D, int R = 4>
__device__ __forceinline__ void tile_dot(const float* A, const float* Bt,
                                         int ty, int tx, float s[R][R]) {
  constexpr int LD = D + 1;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int kk = 0; kk < D; ++kk) {
    float a[R], b[R];
#pragma unroll
    for (int i = 0; i < R; ++i) a[i] = A[(R * ty + i) * LD + kk];
#pragma unroll
    for (int j = 0; j < R; ++j) b[j] = Bt[(tx + 16 * j) * LD + kk];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
  }
}

// max / sum over the 16 lanes (tx) that hold one query row
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// scaled score plus bias at (row, col); -inf past the last key column
__device__ __forceinline__ float biased(float s, float scale,
                                        const float* brow, int col, int S) {
  if (col >= S) return -INFINITY;
  return s * scale + (brow ? brow[col] : 0.f);
}

__device__ __forceinline__ const float* bias_row(const BiasView& bv, int b,
                                                 int h, int row) {
  return bv.ptr ? bv.ptr + b * bv.sb + h * bv.sh + row * bv.sr : nullptr;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, kFwdBlocks<D>)
    attn_fwd(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, BiasView bv,
             const long long* __restrict__ seed, T* __restrict__ o,
             float* __restrict__ lse, Strides sq, Strides sk, Strides sv,
             Strides so, int H, int S, float scale, float p_drop,
             float keep_scale) {
  constexpr int LD = D + 1, E = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kB * LD;
  float* Vs = Ks + kB * LD;
  float* Ps = Vs + kB * LD;  // [kB][kLP]

  const int q0 = blockIdx.x * kB, h = blockIdx.y, b = blockIdx.z;
  const int bh = b * H + h, ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const T* qh = head_of(q, sq, b, h);
  const T* kh = head_of(k, sk, b, h);
  const T* vh = head_of(v, sv, b, h);
  load_tile<T, D>(Qs, qh + q0 * sq.r, sq.r, min(kB, S - q0));
  const bool drop = p_drop > 0.f;
  const uint2 key = drop ? seed_key(seed) : make_uint2(0, 0);

  const float* brow[4];
  float m[4], l[4], acc[4][E];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    brow[i] = bias_row(bv, b, h, min(q0 + 4 * ty + i, S - 1));
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[i][e] = 0.f;
  }

  for (int k0 = 0; k0 < S; k0 += kB) {
    const int nk = min(kB, S - k0);
    __syncthreads();  // the previous tile's Ks, Vs and Ps are consumed
    load_tile<T, D>(Ks, kh + k0 * sk.r, sk.r, nk);
    load_tile<T, D>(Vs, vh + k0 * sv.r, sv.r, nk);
    __syncthreads();
    float s[4][4];
    tile_dot<D>(Qs, Ks, ty, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = biased(s[i][j], scale, brow[i], k0 + tx + 16 * j, S);
        mx = fmaxf(mx, s[i][j]);
      }
      // every tile holds a live column, so m_new is finite
      const float m_new = fmaxf(m[i], row_max(mx));
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
      l[i] = l[i] * corr + row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[i][e] *= corr;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bool keep[4] = {true, true, true, true};
      if (drop)
        keep_rows<4>(key, k0 + tx + 16 * j, q0 + 4 * ty, bh, p_drop, keep);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        Ps[(4 * ty + i) * kLP + tx + 16 * j] =
            drop ? (keep[i] ? s[i][j] * keep_scale : 0.f) : s[i][j];
    }
    __syncthreads();
    for (int c = 0; c < nk; ++c) {
      float vv[E];
#pragma unroll
      for (int e = 0; e < E; ++e) vv[e] = Vs[c * LD + tx + 16 * e];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = Ps[(4 * ty + i) * kLP + c];
#pragma unroll
        for (int e = 0; e < E; ++e) acc[i][e] = fmaf(p, vv[e], acc[i][e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= S) continue;
    const float inv = 1.f / l[i];
    T* orow = head_of(o, so, b, h) + row * so.r;
#pragma unroll
    for (int e = 0; e < E; ++e) store(acc[i][e] * inv, orow + tx + 16 * e);
    if (tx == 0) lse[static_cast<size_t>(bh) * S + row] = m[i] + logf(l[i]);
  }
}

// Per q-tile of TB rows: delta = rowsum(dO * O) (also written out), then
// dq over all k-tiles of TB keys.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, kBwdBlocks<D>)
    attn_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, BiasView bv,
                const long long* __restrict__ seed, const T* __restrict__ o,
                const T* __restrict__ dout, const float* __restrict__ lse,
                float* __restrict__ delta, T* __restrict__ dq, Strides sq,
                Strides sk, Strides sv, Strides so, Strides sdo,
                Strides sdq, int H, int S, float scale, float p_drop,
                float keep_scale) {
  constexpr int TB = kBwdRows<D>, R = TB / 16, LP = TB + 1;
  constexpr int LD = D + 1, E = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + TB * LD;
  float* Ks = dOs + TB * LD;
  float* Vs = Ks + TB * LD;
  float* dSs = Vs + TB * LD;     // [TB][LP]
  float* Lr = dSs + TB * LP;     // [TB] lse of the tile's rows
  float* Dr = Lr + TB;           // [TB] delta of the tile's rows

  const int q0 = blockIdx.x * TB, h = blockIdx.y, b = blockIdx.z;
  const int bh = b * H + h, tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const T* kh = head_of(k, sk, b, h);
  const T* vh = head_of(v, sv, b, h);
  const int nq = min(TB, S - q0);
  load_tile<T, D, TB>(Qs, head_of(q, sq, b, h) + q0 * sq.r, sq.r, nq);
  load_tile<T, D, TB>(dOs, head_of(dout, sdo, b, h) + q0 * sdo.r, sdo.r,
                      nq);
  __syncthreads();
  {  // kThreads / TB threads per row, neighbouring lanes of one warp
    constexpr int kParts = kThreads / TB;
    const int r = tid / kParts, part = tid % kParts;
    float acc = 0.f;
    if (r < nq) {
      const T* orow = head_of(o, so, b, h) + (q0 + r) * so.r;
      for (int e = part; e < D; e += kParts)
        acc = fmaf(dOs[r * LD + e], to_f32(orow[e]), acc);
    }
#pragma unroll
    for (int x = 1; x < kParts; x <<= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, x);
    if (part == 0) {
      Dr[r] = acc;
      Lr[r] = r < nq ? lse[static_cast<size_t>(bh) * S + q0 + r] : 0.f;
      if (r < nq) delta[static_cast<size_t>(bh) * S + q0 + r] = acc;
    }
  }
  const bool drop = p_drop > 0.f;
  const uint2 key = drop ? seed_key(seed) : make_uint2(0, 0);
  const float* brow[R];
  float acc[R][E];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    brow[i] = bias_row(bv, b, h, min(q0 + R * ty + i, S - 1));
#pragma unroll
    for (int e = 0; e < E; ++e) acc[i][e] = 0.f;
  }

  for (int k0 = 0; k0 < S; k0 += TB) {
    const int nk = min(TB, S - k0);
    __syncthreads();
    load_tile<T, D, TB>(Ks, kh + k0 * sk.r, sk.r, nk);
    load_tile<T, D, TB>(Vs, vh + k0 * sv.r, sv.r, nk);
    __syncthreads();
    float s[R][R], dp[R][R];
    tile_dot<D, R>(Qs, Ks, ty, tx, s);
    tile_dot<D, R>(dOs, Vs, ty, tx, dp);
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int col = k0 + tx + 16 * j;
      bool keep[R];
#pragma unroll
      for (int i = 0; i < R; ++i) keep[i] = true;
      if (drop) keep_rows<R>(key, col, q0 + R * ty, bh, p_drop, keep);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int r = R * ty + i;
        const float p = q0 + r < S
            ? expf(biased(s[i][j], scale, brow[i], col, S) - Lr[r]) : 0.f;
        const float d = drop ? (keep[i] ? dp[i][j] * keep_scale : 0.f)
                             : dp[i][j];
        dSs[r * LP + tx + 16 * j] = p * (d - Dr[r]);
      }
    }
    __syncthreads();
    for (int c = 0; c < nk; ++c) {
      float kv[E];
#pragma unroll
      for (int e = 0; e < E; ++e) kv[e] = Ks[c * LD + tx + 16 * e];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float ds = dSs[(R * ty + i) * LP + c];
#pragma unroll
        for (int e = 0; e < E; ++e) acc[i][e] = fmaf(ds, kv[e], acc[i][e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + R * ty + i;
    if (row >= S) continue;
    T* drow = head_of(dq, sdq, b, h) + row * sdq.r;
#pragma unroll
    for (int e = 0; e < E; ++e) store(acc[i][e] * scale, drow + tx + 16 * e);
  }
}

// dbias layout [B, Hb, Rb, S] fp32 (Hb in {1, H}, Rb in {1, S});
// ptr == nullptr: no bias gradient wanted.
struct DBias {
  float* ptr;
  int heads, rows;
};

// Per k-tile of TB keys: dk, dv (and dbias) over all q-tiles of TB rows.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, kBwdBlocks<D>)
    attn_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, BiasView bv,
                  const long long* __restrict__ seed,
                  const T* __restrict__ dout, const float* __restrict__ lse,
                  const float* __restrict__ delta, T* __restrict__ dk,
                  T* __restrict__ dv, DBias db, Strides sq, Strides sk,
                  Strides sv, Strides sdo, Strides sdk, Strides sdv, int H,
                  int S, float scale, float p_drop, float keep_scale) {
  constexpr int TB = kBwdRows<D>, R = TB / 16, LP = TB + 1;
  constexpr int LD = D + 1, E = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + TB * LD;
  float* Qs = Vs + TB * LD;
  float* dOs = Qs + TB * LD;
  float* Ps = dOs + TB * LD;     // [TB][LP] dropped weights
  float* dSs = Ps + TB * LP;     // [TB][LP]
  float* Lr = dSs + TB * LP;
  float* Dr = Lr + TB;

  const int k0 = blockIdx.x * TB, h = blockIdx.y, b = blockIdx.z;
  const int bh = b * H + h, tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const T* qh = head_of(q, sq, b, h);
  const T* doh = head_of(dout, sdo, b, h);
  const int nk = min(TB, S - k0);
  load_tile<T, D, TB>(Ks, head_of(k, sk, b, h) + k0 * sk.r, sk.r, nk);
  load_tile<T, D, TB>(Vs, head_of(v, sv, b, h) + k0 * sv.r, sv.r, nk);
  const bool drop = p_drop > 0.f;
  const uint2 key = drop ? seed_key(seed) : make_uint2(0, 0);
  const bool acc_heads = db.ptr && db.heads == 1 && H > 1;
  const bool reduce_rows = db.ptr && db.rows == 1;
  float* db_base = db.ptr ? db.ptr + (static_cast<size_t>(b) * db.heads +
                                      (db.heads == 1 ? 0 : h)) *
                                         db.rows * S
                          : nullptr;

  float adk[R][E], adv[R][E], colsum[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    colsum[i] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) adk[i][e] = adv[i][e] = 0.f;
  }

  for (int q0 = 0; q0 < S; q0 += TB) {
    const int nq = min(TB, S - q0);
    __syncthreads();
    load_tile<T, D, TB>(Qs, qh + q0 * sq.r, sq.r, nq);
    load_tile<T, D, TB>(dOs, doh + q0 * sdo.r, sdo.r, nq);
    if (tid < TB) {
      const bool live = tid < nq;
      Lr[tid] = live ? lse[static_cast<size_t>(bh) * S + q0 + tid] : 0.f;
      Dr[tid] = live ? delta[static_cast<size_t>(bh) * S + q0 + tid] : 0.f;
    }
    __syncthreads();
    float s[R][R], dp[R][R];
    tile_dot<D, R>(Qs, Ks, ty, tx, s);
    tile_dot<D, R>(dOs, Vs, ty, tx, dp);
    const float* brow[R];
#pragma unroll
    for (int i = 0; i < R; ++i)
      brow[i] = bias_row(bv, b, h, min(q0 + R * ty + i, S - 1));
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int col = k0 + tx + 16 * j;
      bool keep[R];
#pragma unroll
      for (int i = 0; i < R; ++i) keep[i] = true;
      if (drop) keep_rows<R>(key, col, q0 + R * ty, bh, p_drop, keep);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int r = R * ty + i, row = q0 + r;
        const float p = row < S
            ? expf(biased(s[i][j], scale, brow[i], col, S) - Lr[r]) : 0.f;
        float pd = p, d = dp[i][j];
        if (drop) {
          pd = keep[i] ? p * keep_scale : 0.f;
          d = keep[i] ? d * keep_scale : 0.f;
        }
        const float ds = p * (d - Dr[r]);
        Ps[r * LP + tx + 16 * j] = pd;
        dSs[r * LP + tx + 16 * j] = ds;
        if (db.ptr && row < S && col < S) {
          if (reduce_rows) {
            colsum[j] += ds;
          } else if (acc_heads) {
            atomicAdd(db_base + static_cast<size_t>(row) * S + col, ds);
          } else {
            db_base[static_cast<size_t>(row) * S + col] = ds;
          }
        }
      }
    }
    __syncthreads();
    for (int r = 0; r < nq; ++r) {
      float dov[E], qv[E];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        dov[e] = dOs[r * LD + tx + 16 * e];
        qv[e] = Qs[r * LD + tx + 16 * e];
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float pd = Ps[r * LP + R * ty + i];
        const float ds = dSs[r * LP + R * ty + i];
#pragma unroll
        for (int e = 0; e < E; ++e) {
          adv[i][e] = fmaf(pd, dov[e], adv[i][e]);
          adk[i][e] = fmaf(ds, qv[e], adk[i][e]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = k0 + R * ty + i;
    if (row >= S) continue;
    T* dkrow = head_of(dk, sdk, b, h) + row * sdk.r;
    T* dvrow = head_of(dv, sdv, b, h) + row * sdv.r;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      store(adk[i][e] * scale, dkrow + tx + 16 * e);
      store(adv[i][e], dvrow + tx + 16 * e);
    }
  }
  if (reduce_rows) {  // column sums over the 16 row groups, in a fixed order
    float* red = Ps;    // [16][TB], Ps is free once the loop has ended
    __syncthreads();
#pragma unroll
    for (int j = 0; j < R; ++j) red[ty * TB + tx + 16 * j] = colsum[j];
    __syncthreads();
    if (tid < nk) {
      float sum = 0.f;
      for (int t = 0; t < 16; ++t) sum += red[t * TB + tid];
      if (acc_heads)
        atomicAdd(db_base + k0 + tid, sum);
      else
        db_base[k0 + tid] = sum;
    }
  }
}

// ---- head widths past 256: the outputs' columns split across blocks -------
// attn_fwd_wide, attn_bwd_dq_wide and attn_bwd_dkdv_wide take any d that
// is a multiple of kDC past 256 (the wrappers zero-pad another d up to
// one), in every type. Each 64-row tile's outputs (o; dq; dk and dv) are
// split into d / kDC column chunks, one block each (the grid's x is the
// tiles times the chunks). A block computes S = Q.K^T and dP = dO.V^T
// over the whole d by looping over d in kDC-column chunks of the operands
// through shared memory (fp32 [64][kDC + 1] tiles, 66 to 100 KB a block
// at any d), then its own chunk of P.V, dS.K, P^T.dO and dS^T.Q; delta
// = rowsum(dO.O) is read from device memory over the whole row. The
// first chunk's block alone writes lse, delta and dbias. The math is the
// SIMT kernels' (fp32 on the SIMT cores, the same micro-tiles, mask and
// dbias reduction). No preset has such a width: these kernels are right
// first, and each block recomputes the scores the other chunks' blocks
// compute, d / kDC times the SIMT kernels' products (bound: the SIMT
// rate, 67 TFLOP/s, on those operations).
constexpr int kDC = 64;         // columns of a chunk
constexpr int kLC = kDC + 1;    // row stride of a chunk tile in shared memory

// s[i][j] += the thread's micro-tile of A . Bt over one chunk
__device__ __forceinline__ void chunk_dot(const float* A, const float* Bt,
                                          int ty, int tx, float s[4][4]) {
  float part[4][4];
  tile_dot<kDC>(A, Bt, ty, tx, part);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] += part[i][j];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    attn_fwd_wide(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, BiasView bv,
                  const long long* __restrict__ seed, T* __restrict__ o,
                  float* __restrict__ lse, Strides sq, Strides sk, Strides sv,
                  Strides so, int H, int S, int D, float scale, float p_drop,
                  float keep_scale) {
  constexpr int E = kDC / 16;
  extern __shared__ float smem[];
  float* Qc = smem;            // [kB][kLC] a chunk of the q-tile
  float* Kc = Qc + kB * kLC;   // a chunk of the k-tile
  float* Vc = Kc + kB * kLC;   // the block's chunk of the v-tile
  float* Ps = Vc + kB * kLC;   // [kB][kLP]

  const int chunks = D / kDC;
  const int q0 = blockIdx.x / chunks * kB, c_out = blockIdx.x % chunks * kDC;
  const int h = blockIdx.y, b = blockIdx.z;
  const int bh = b * H + h, ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const T* qh = head_of(q, sq, b, h) + q0 * sq.r;
  const T* kh = head_of(k, sk, b, h);
  const T* vh = head_of(v, sv, b, h);
  const int nq = min(kB, S - q0);
  const bool drop = p_drop > 0.f;
  const uint2 key = drop ? seed_key(seed) : make_uint2(0, 0);

  const float* brow[4];
  float m[4], l[4], acc[4][E];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    brow[i] = bias_row(bv, b, h, min(q0 + 4 * ty + i, S - 1));
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[i][e] = 0.f;
  }

  for (int k0 = 0; k0 < S; k0 += kB) {
    const int nk = min(kB, S - k0);
    float s[4][4] = {};
    for (int c = 0; c < D; c += kDC) {
      __syncthreads();  // the previous chunk's (or tile's) tiles are consumed
      load_tile<T, kDC>(Qc, qh + c, sq.r, nq);
      load_tile<T, kDC>(Kc, kh + k0 * sk.r + c, sk.r, nk);
      __syncthreads();
      chunk_dot(Qc, Kc, ty, tx, s);
    }
    load_tile<T, kDC>(Vc, vh + k0 * sv.r + c_out, sv.r, nk);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = biased(s[i][j], scale, brow[i], k0 + tx + 16 * j, S);
        mx = fmaxf(mx, s[i][j]);
      }
      // every tile holds a live column, so m_new is finite
      const float m_new = fmaxf(m[i], row_max(mx));
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
      l[i] = l[i] * corr + row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[i][e] *= corr;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bool keep[4] = {true, true, true, true};
      if (drop)
        keep_rows<4>(key, k0 + tx + 16 * j, q0 + 4 * ty, bh, p_drop, keep);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        Ps[(4 * ty + i) * kLP + tx + 16 * j] =
            drop ? (keep[i] ? s[i][j] * keep_scale : 0.f) : s[i][j];
    }
    __syncthreads();  // Ps and Vc
    for (int c = 0; c < nk; ++c) {
      float vv[E];
#pragma unroll
      for (int e = 0; e < E; ++e) vv[e] = Vc[c * kLC + tx + 16 * e];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = Ps[(4 * ty + i) * kLP + c];
#pragma unroll
        for (int e = 0; e < E; ++e) acc[i][e] = fmaf(p, vv[e], acc[i][e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= S) continue;
    const float inv = 1.f / l[i];
    T* orow = head_of(o, so, b, h) + row * so.r + c_out;
#pragma unroll
    for (int e = 0; e < E; ++e) store(acc[i][e] * inv, orow + tx + 16 * e);
    if (tx == 0 && c_out == 0)
      lse[static_cast<size_t>(bh) * S + row] = m[i] + logf(l[i]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    attn_bwd_dq_wide(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, BiasView bv,
                     const long long* __restrict__ seed,
                     const T* __restrict__ o, const T* __restrict__ dout,
                     const float* __restrict__ lse, float* __restrict__ delta,
                     T* __restrict__ dq, Strides sq, Strides sk, Strides sv,
                     Strides so, Strides sdo, Strides sdq, int H, int S,
                     int D, float scale, float p_drop, float keep_scale) {
  constexpr int E = kDC / 16;
  extern __shared__ float smem[];
  float* Qc = smem;              // [kB][kLC] chunks of the q-tile's rows
  float* dOc = Qc + kB * kLC;
  float* Kc = dOc + kB * kLC;    // chunks of the k-tile's rows
  float* Vc = Kc + kB * kLC;
  float* dSs = Vc + kB * kLC;    // [kB][kLP]
  float* Lr = dSs + kB * kLP;    // [kB] lse of the tile's rows
  float* Dr = Lr + kB;           // [kB] delta of the tile's rows

  const int chunks = D / kDC;
  const int q0 = blockIdx.x / chunks * kB, c_out = blockIdx.x % chunks * kDC;
  const int h = blockIdx.y, b = blockIdx.z;
  const int bh = b * H + h, tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const T* qh = head_of(q, sq, b, h) + q0 * sq.r;
  const T* doh = head_of(dout, sdo, b, h) + q0 * sdo.r;
  const T* kh = head_of(k, sk, b, h);
  const T* vh = head_of(v, sv, b, h);
  const int nq = min(kB, S - q0);
  {  // delta over the whole row: four threads a row, neighbouring lanes
    constexpr int kParts = kThreads / kB;
    const int r = tid / kParts, part = tid % kParts;
    float acc = 0.f;
    if (r < nq) {
      const T* orow = head_of(o, so, b, h) + (q0 + r) * so.r;
      const T* dorow = doh + r * sdo.r;
      for (int e = part; e < D; e += kParts)
        acc = fmaf(to_f32(dorow[e]), to_f32(orow[e]), acc);
    }
#pragma unroll
    for (int x = 1; x < kParts; x <<= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, x);
    if (part == 0) {
      Dr[r] = acc;
      Lr[r] = r < nq ? lse[static_cast<size_t>(bh) * S + q0 + r] : 0.f;
      if (r < nq && c_out == 0)
        delta[static_cast<size_t>(bh) * S + q0 + r] = acc;
    }
  }
  const bool drop = p_drop > 0.f;
  const uint2 key = drop ? seed_key(seed) : make_uint2(0, 0);
  const float* brow[4];
  float acc[4][E];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    brow[i] = bias_row(bv, b, h, min(q0 + 4 * ty + i, S - 1));
#pragma unroll
    for (int e = 0; e < E; ++e) acc[i][e] = 0.f;
  }

  for (int k0 = 0; k0 < S; k0 += kB) {
    const int nk = min(kB, S - k0);
    float s[4][4] = {}, dp[4][4] = {};
    for (int c = 0; c < D; c += kDC) {
      __syncthreads();  // the previous chunk's (or tile's) tiles are consumed
      load_tile<T, kDC>(Qc, qh + c, sq.r, nq);
      load_tile<T, kDC>(dOc, doh + c, sdo.r, nq);
      load_tile<T, kDC>(Kc, kh + k0 * sk.r + c, sk.r, nk);
      load_tile<T, kDC>(Vc, vh + k0 * sv.r + c, sv.r, nk);
      __syncthreads();
      chunk_dot(Qc, Kc, ty, tx, s);
      chunk_dot(dOc, Vc, ty, tx, dp);
    }
    __syncthreads();  // Kc is consumed
    load_tile<T, kDC>(Kc, kh + k0 * sk.r + c_out, sk.r, nk);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = k0 + tx + 16 * j;
      bool keep[4] = {true, true, true, true};
      if (drop) keep_rows<4>(key, col, q0 + 4 * ty, bh, p_drop, keep);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 4 * ty + i;
        const float p = q0 + r < S
            ? expf(biased(s[i][j], scale, brow[i], col, S) - Lr[r]) : 0.f;
        const float d = drop ? (keep[i] ? dp[i][j] * keep_scale : 0.f)
                             : dp[i][j];
        dSs[r * kLP + tx + 16 * j] = p * (d - Dr[r]);
      }
    }
    __syncthreads();  // dSs and Kc
    for (int c = 0; c < nk; ++c) {
      float kv[E];
#pragma unroll
      for (int e = 0; e < E; ++e) kv[e] = Kc[c * kLC + tx + 16 * e];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ds = dSs[(4 * ty + i) * kLP + c];
#pragma unroll
        for (int e = 0; e < E; ++e) acc[i][e] = fmaf(ds, kv[e], acc[i][e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= S) continue;
    T* drow = head_of(dq, sdq, b, h) + row * sdq.r + c_out;
#pragma unroll
    for (int e = 0; e < E; ++e) store(acc[i][e] * scale, drow + tx + 16 * e);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    attn_bwd_dkdv_wide(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, BiasView bv,
                       const long long* __restrict__ seed,
                       const T* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, T* __restrict__ dk,
                       T* __restrict__ dv, DBias db, Strides sq, Strides sk,
                       Strides sv, Strides sdo, Strides sdk, Strides sdv,
                       int H, int S, int D, float scale, float p_drop,
                       float keep_scale) {
  constexpr int E = kDC / 16;
  extern __shared__ float smem[];
  float* Kc = smem;              // [kB][kLC] chunks of the k-tile's rows
  float* Vc = Kc + kB * kLC;
  float* Qc = Vc + kB * kLC;     // chunks of the q-tile's rows
  float* dOc = Qc + kB * kLC;
  float* Ps = dOc + kB * kLC;    // [kB][kLP] dropped weights
  float* dSs = Ps + kB * kLP;    // [kB][kLP]
  float* Lr = dSs + kB * kLP;
  float* Dr = Lr + kB;

  const int chunks = D / kDC;
  const int k0 = blockIdx.x / chunks * kB, c_out = blockIdx.x % chunks * kDC;
  const int h = blockIdx.y, b = blockIdx.z;
  if (c_out != 0) db.ptr = nullptr;  // the first chunk's block writes dbias
  const int bh = b * H + h, tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const T* qh = head_of(q, sq, b, h);
  const T* doh = head_of(dout, sdo, b, h);
  const T* kh = head_of(k, sk, b, h) + k0 * sk.r;
  const T* vh = head_of(v, sv, b, h) + k0 * sv.r;
  const int nk = min(kB, S - k0);
  const bool drop = p_drop > 0.f;
  const uint2 key = drop ? seed_key(seed) : make_uint2(0, 0);
  const bool acc_heads = db.ptr && db.heads == 1 && H > 1;
  const bool reduce_rows = db.ptr && db.rows == 1;
  float* db_base = db.ptr ? db.ptr + (static_cast<size_t>(b) * db.heads +
                                      (db.heads == 1 ? 0 : h)) *
                                         db.rows * S
                          : nullptr;

  float adk[4][E], adv[4][E], colsum[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    colsum[i] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) adk[i][e] = adv[i][e] = 0.f;
  }

  for (int q0 = 0; q0 < S; q0 += kB) {
    const int nq = min(kB, S - q0);
    float s[4][4] = {}, dp[4][4] = {};
    for (int c = 0; c < D; c += kDC) {
      __syncthreads();  // the previous chunk's (or tile's) tiles are consumed
      load_tile<T, kDC>(Qc, qh + q0 * sq.r + c, sq.r, nq);
      load_tile<T, kDC>(dOc, doh + q0 * sdo.r + c, sdo.r, nq);
      load_tile<T, kDC>(Kc, kh + c, sk.r, nk);
      load_tile<T, kDC>(Vc, vh + c, sv.r, nk);
      __syncthreads();
      chunk_dot(Qc, Kc, ty, tx, s);
      chunk_dot(dOc, Vc, ty, tx, dp);
    }
    __syncthreads();  // Qc and dOc are consumed
    load_tile<T, kDC>(Qc, qh + q0 * sq.r + c_out, sq.r, nq);
    load_tile<T, kDC>(dOc, doh + q0 * sdo.r + c_out, sdo.r, nq);
    if (tid < kB) {
      const bool live = tid < nq;
      Lr[tid] = live ? lse[static_cast<size_t>(bh) * S + q0 + tid] : 0.f;
      Dr[tid] = live ? delta[static_cast<size_t>(bh) * S + q0 + tid] : 0.f;
    }
    __syncthreads();  // Lr and Dr
    const float* brow[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      brow[i] = bias_row(bv, b, h, min(q0 + 4 * ty + i, S - 1));
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = k0 + tx + 16 * j;
      bool keep[4] = {true, true, true, true};
      if (drop) keep_rows<4>(key, col, q0 + 4 * ty, bh, p_drop, keep);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 4 * ty + i, row = q0 + r;
        const float p = row < S
            ? expf(biased(s[i][j], scale, brow[i], col, S) - Lr[r]) : 0.f;
        float pd = p, d = dp[i][j];
        if (drop) {
          pd = keep[i] ? p * keep_scale : 0.f;
          d = keep[i] ? d * keep_scale : 0.f;
        }
        const float ds = p * (d - Dr[r]);
        Ps[r * kLP + tx + 16 * j] = pd;
        dSs[r * kLP + tx + 16 * j] = ds;
        if (db.ptr && row < S && col < S) {
          if (reduce_rows) {
            colsum[j] += ds;
          } else if (acc_heads) {
            atomicAdd(db_base + static_cast<size_t>(row) * S + col, ds);
          } else {
            db_base[static_cast<size_t>(row) * S + col] = ds;
          }
        }
      }
    }
    __syncthreads();  // Ps, dSs
    for (int r = 0; r < nq; ++r) {
      float dov[E], qv[E];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        dov[e] = dOc[r * kLC + tx + 16 * e];
        qv[e] = Qc[r * kLC + tx + 16 * e];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pd = Ps[r * kLP + 4 * ty + i];
        const float ds = dSs[r * kLP + 4 * ty + i];
#pragma unroll
        for (int e = 0; e < E; ++e) {
          adv[i][e] = fmaf(pd, dov[e], adv[i][e]);
          adk[i][e] = fmaf(ds, qv[e], adk[i][e]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + 4 * ty + i;
    if (row >= S) continue;
    T* dkrow = head_of(dk, sdk, b, h) + row * sdk.r + c_out;
    T* dvrow = head_of(dv, sdv, b, h) + row * sdv.r + c_out;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      store(adk[i][e] * scale, dkrow + tx + 16 * e);
      store(adv[i][e], dvrow + tx + 16 * e);
    }
  }
  if (reduce_rows) {  // column sums over the 16 row groups, in a fixed order
    float* red = Ps;    // [16][kB], Ps is free once the loop has ended
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 4; ++j) red[ty * kB + tx + 16 * j] = colsum[j];
    __syncthreads();
    if (tid < nk) {
      float sum = 0.f;
      for (int t = 0; t < 16; ++t) sum += red[t * kB + tid];
      if (acc_heads)
        atomicAdd(db_base + k0 + tid, sum);
      else
        db_base[k0 + tid] = sum;
    }
  }
}

// ---- bf16 and fp16 backward on the tensor cores ----------------------------
using bf16 = __nv_bfloat16;
using f16 = __half;

template <typename T>
constexpr bool kHalf16 =
    std::is_same<T, bf16>::value || std::is_same<T, f16>::value;

constexpr int kMmaThreads = 128;  // four warps, 16 rows of a 64-row tile each
constexpr int kPad = 8;           // 16-bit elements (16 bytes) after each row
template <int D> constexpr int kLDS = D + kPad;  // row stride of a tile
// Resident blocks per SM of the tensor-core kernels (their register cap,
// 65536 / (128 * blocks)): the double-buffered tiles allow three at
// d <= 64, two at d = 128, one at d = 256.
template <int D> constexpr int kMmaBlocks = D <= 64 ? 3 : D <= 128 ? 2 : 1;
// Blocks that share a tile of the backward, each writing d / kHalves
// columns of dq (or of dk and dv): two at d 256, whose 256 fp32
// accumulators a thread (dk and dv) would pass the 255 registers a thread
// can have. Each block still computes S and dP over the whole d.
template <int D> constexpr int kHalves = D > 128 ? 2 : 1;
// query columns of S^T and dP^T the dk/dv kernel holds in registers at once
template <int D> constexpr int kDkdvCols = D >= 32 ? 32 : 64;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared without passing through registers;
// live == false fills the destination with zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* s, const void* g, bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(s)),
               "l"(g), "r"(live ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* s, const void* g, bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(s)),
               "l"(g), "r"(live ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// four 8 x 8 16-bit matrices from shared memory; lane i names the row
// address of matrix i / 8, row i % 8; .trans hands each lane a column pair
__device__ __forceinline__ void ldsm(unsigned r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_t(unsigned r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c[16 x 8] += a[16 x 16] . b[16 x 8], operands of the 16-bit type T,
// fp32 accumulators
template <typename T>
__device__ __forceinline__ void mma(float c[4], const unsigned a[4],
                                    unsigned b0, unsigned b1);
template <>
__device__ __forceinline__ void mma<bf16>(float c[4], const unsigned a[4],
                                          unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <>
__device__ __forceinline__ void mma<f16>(float c[4], const unsigned a[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two fp32 values rounded to T in one register (lo at the lower address),
// and two T values of one register back to fp32
template <typename T>
__device__ __forceinline__ unsigned pack2(float lo, float hi);
template <>
__device__ __forceinline__ unsigned pack2<bf16>(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}
template <>
__device__ __forceinline__ unsigned pack2<f16>(float lo, float hi) {
  const __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}
template <typename T>
__device__ __forceinline__ float2 unpack2(unsigned v);
template <>
__device__ __forceinline__ float2 unpack2<bf16>(unsigned v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}
template <>
__device__ __forceinline__ float2 unpack2<f16>(unsigned v) {
  return __half22float2(*reinterpret_cast<const __half2*>(&v));
}

// The A operand of the next product from two accumulator tiles of 8
// columns (c[j], c[j + 1]), rounded to T: the m16n8 accumulator layout is
// the m16n8k16 A layout of those 16 columns, so P and dS never leave the
// registers.
template <typename T>
__device__ __forceinline__ void a_from_acc(unsigned a[4], const float c0[4],
                                           const float c1[4]) {
  a[0] = pack2<T>(c0[0], c0[1]);
  a[1] = pack2<T>(c0[2], c0[3]);
  a[2] = pack2<T>(c1[0], c1[1]);
  a[3] = pack2<T>(c1[2], c1[3]);
}

// Rows [0, n) of a global tile of D-element rows of T, ``rs`` elements
// apart -> shared [kB][D + 16 / sizeof(T)] (rows padded by 16 bytes:
// kLDS<D> in the 16-bit types, kTf32LDS<D> in fp32) by 16-byte cp.async
// (each row must start on a 16-byte boundary: the wrappers copy an
// operand that does not); rows n..kB-1 are zero-filled.
template <int D, typename T>
__device__ __forceinline__ void load_tile_async(T* s, const T* g,
                                                long long rs, int n) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  constexpr int kChunks = D / kVec, LDS = D + kVec;  // 16-byte pieces a row
  const long long stride = rs;    // elements from one row to the next
#pragma unroll
  for (int j = 0; j < kB * kChunks / kMmaThreads; ++j) {
    const int i = threadIdx.x + j * kMmaThreads;
    const int r = i / kChunks, c = kVec * (i % kChunks);
    const bool live = r < n;
    cp_async16(s + r * LDS + c, g + (live ? r : 0) * stride + c, live);
  }
}

// Keep flags of the 64 x 64 tile at (row0, col0) as bits: bit c & 31 of
// keep[2 * r + (c >> 5)] for tile row r, column c. The mask is the
// SIMT kernels' (one Philox call per key column and four query rows), but
// a fragment no longer holds a call's four rows, so the block draws the
// tile together: each warp takes 32 columns of four rows per call, one
// column a lane, and ballots pack the flags; 1024 calls a tile, eight a
// thread.
__device__ __forceinline__ void keep_bits(uint2 key, int row0, int col0,
                                          int bh, float p_drop,
                                          unsigned* keep) {
  const int lane = threadIdx.x & 31;
  for (int t = threadIdx.x >> 5; t < 32; t += kMmaThreads / 32) {
    const int r4 = t >> 1, half = t & 1;
    const uint4 r = philox(
        make_uint4(col0 + 32 * half + lane, (row0 >> 2) + r4, bh, 0), key);
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const unsigned m = __ballot_sync(
          0xffffffffu,
          static_cast<float>(w[i] >> 8) * (1.0f / 16777216.0f) >= p_drop);
      if (lane == i) keep[2 * (4 * r4 + i) + half] = m;
    }
  }
}

// v, as a value the compiler must take to depend on ``dep``: what is
// derived from it is recomputed in the loop over dep where it is used,
// not held in registers across the loop's other work
__device__ __forceinline__ int late(int v, int dep) {
  asm("mov.b32 %0, %1;\n" : "=r"(v) : "r"(v), "r"(dep));
  return v;
}

// the additive bias at key column col of one bias row (nullptr: none);
// -inf past the last key column
__device__ __forceinline__ float bias_term(const float* brow, int col,
                                           int S) {
  if (col >= S) return -INFINITY;
  return brow ? brow[col] : 0.f;
}

// Lane offsets (elements) into a [kB][LDS] tile for ldmatrix.x4: A (and
// a transposed B) of a 16 x 16 block, rows r0 + lane % 16, columns
// c0 + 8 * (lane / 16); B of two 8-row n-tiles of 16 columns, rows
// n0 + lane % 8 + 8 * (lane / 16), columns c0 + 8 * (lane / 8 % 2).
template <int LDS>
__device__ __forceinline__ int a_offset(int lane) {
  return (lane & 15) * LDS + (lane >> 4) * 8;
}
template <int LDS>
__device__ __forceinline__ int b_offset(int lane) {
  return ((lane & 7) + ((lane >> 4) << 3)) * LDS + ((lane >> 3) & 1) * 8;
}

// Per 64-row q-tile: delta = rowsum(dO * O) (also written out), then dq
// over all k-tiles; warp w owns query rows 16w..16w+15 of the tile. At
// d 256 two blocks share the tile, each writing half of dq's columns.
template <typename T, int D>
__global__ void __launch_bounds__(kMmaThreads, kMmaBlocks<D>)
    attn_bwd_dq_mma(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, BiasView bv,
                    const long long* __restrict__ seed,
                    const T* __restrict__ o, const T* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ delta,
                    T* __restrict__ dq, Strides sq, Strides sk, Strides sv,
                    Strides so, Strides sdo, Strides sdq, int H, int S,
                    float scale, float p_drop, float keep_scale) {
  constexpr int LDS = kLDS<D>, TS = kB * LDS;
  extern __shared__ __align__(16) unsigned char smem16[];
  T* Qs = reinterpret_cast<T*>(smem16);
  T* dOs = Qs + TS;
  T* Ks = dOs + TS;                                 // [2][kB][LDS]
  T* Vs = Ks + 2 * TS;                              // [2][kB][LDS]
  float* Ct = reinterpret_cast<float*>(Vs + 2 * TS);  // [2][kB] bias by column
  float* Dr = Ct + 2 * kB;                         // [kB] delta of the rows
  unsigned* Keep = reinterpret_cast<unsigned*>(Dr + kB);  // [2][kB][2]

  constexpr int DH = D / kHalves<D>;  // the columns of dq this block writes
  const int q0 = blockIdx.x / kHalves<D> * kB, h = blockIdx.y, b = blockIdx.z;
  const int n0 = blockIdx.x % kHalves<D> * DH;
  const int bh = b * H + h, tid = threadIdx.x, lane = tid & 31;
  const int w = tid >> 5, g = lane >> 2, t4 = lane & 3;
  const T* kh = head_of(k, sk, b, h);
  const T* vh = head_of(v, sv, b, h);
  const int nq = min(kB, S - q0);
  load_tile_async<D>(Qs, head_of(q, sq, b, h) + q0 * sq.r, sq.r, nq);
  load_tile_async<D>(dOs, head_of(dout, sdo, b, h) + q0 * sdo.r, sdo.r, nq);
  load_tile_async<D>(Ks, kh, sk.r, min(kB, S));
  load_tile_async<D>(Vs, vh, sv.r, min(kB, S));
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  {  // two threads per row, lanes 2r and 2r + 1 of one warp
    const int r = tid >> 1, part = tid & 1;
    float acc = 0.f;
    if (r < nq) {
      const T* orow = head_of(o, so, b, h) + (q0 + r) * so.r;
      for (int e = 2 * part; e < D; e += 4) {
        const float2 of =
            unpack2<T>(*reinterpret_cast<const unsigned*>(orow + e));
        const float2 df =
            unpack2<T>(*reinterpret_cast<const unsigned*>(dOs + r * LDS + e));
        acc = fmaf(df.y, of.y, fmaf(df.x, of.x, acc));
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (part == 0) {
      Dr[r] = acc;
      if (r < nq && n0 == 0)
        delta[static_cast<size_t>(bh) * S + q0 + r] = acc;
    }
  }
  const bool drop = p_drop > 0.f;
  const uint2 key = drop ? seed_key(seed) : make_uint2(0, 0);
  // a bias with a row per query is read per element; a row-broadcast one
  // once per tile into Ct, with -inf past the last key (no bias: 0)
  const bool rowwise = bv.ptr && bv.sr != 0;
  const float* bcast = rowwise ? nullptr : bias_row(bv, b, h, 0);
  __syncthreads();  // Dr
  int rl[2];        // the thread's two tile rows
  float lse_r[2], delta_r[2];
  const float* brow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    rl[i] = 16 * w + g + 8 * i;
    const int row = q0 + rl[i];
    lse_r[i] = row < S ? lse[static_cast<size_t>(bh) * S + row] : 0.f;
    delta_r[i] = Dr[rl[i]];
    brow[i] = rowwise ? bias_row(bv, b, h, min(row, S - 1)) : nullptr;
  }
  const int a_off = 16 * w * LDS + a_offset<LDS>(lane);
  const int b_off = b_offset<LDS>(lane), bt_off = a_offset<LDS>(lane) + n0;
  float acc[DH / 8][4] = {};

  for (int k0 = 0; k0 < S; k0 += kB) {
    const int buf = (k0 / kB) & 1;
    const T* Kt = Ks + buf * TS;
    const T* Vt = Vs + buf * TS;
    float* ct = Ct + buf * kB;
    unsigned* const keep = Keep + buf * 2 * kB;
    if (tid < kB) ct[tid] = bias_term(bcast, k0 + tid, S);
    if (drop) keep_bits(key, q0, k0, bh, p_drop, keep);
    cp_async_wait_all();
    __syncthreads();  // tile k0 has landed; tile k0 - kB is consumed
    if (k0 + kB < S) {  // the next tile's copies overlap this tile's math
      const int nk = min(kB, S - k0 - kB);
      load_tile_async<D>(Ks + (buf ^ 1) * TS, kh + (k0 + kB) * sk.r, sk.r,
                         nk);
      load_tile_async<D>(Vs + (buf ^ 1) * TS, vh + (k0 + kB) * sv.r, sv.r,
                         nk);
      cp_async_commit();
    }
    // S = Q . K^T and dP = dO . V^T, 16 x 64 per warp
    float s[kB / 8][4] = {}, dp[kB / 8][4] = {};
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      unsigned qa[4], da[4];
      ldsm(qa, Qs + a_off + kk);
      ldsm(da, dOs + a_off + kk);
#pragma unroll
      for (int n = 0; n < kB; n += 16) {
        unsigned kb[4], vb[4];
        ldsm(kb, Kt + n * LDS + b_off + kk);
        ldsm(vb, Vt + n * LDS + b_off + kk);
        mma<T>(s[n / 8], qa, kb[0], kb[1]);
        mma<T>(s[n / 8 + 1], qa, kb[2], kb[3]);
        mma<T>(dp[n / 8], da, vb[0], vb[1]);
        mma<T>(dp[n / 8 + 1], da, vb[2], vb[3]);
      }
    }
    // dS = P * (dP * keep * keep_scale - delta), in place of S, fp32
    unsigned kw[2][2] = {};
    if (drop) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int half = 0; half < 2; ++half)
          kw[i][half] = keep[2 * rl[i] + half];
    }
#pragma unroll
    for (int j = 0; j < kB / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, c = 8 * j + 2 * t4 + (e & 1);
        const float bias = rowwise ? bias_term(brow[i], k0 + c, S) : ct[c];
        const float p = q0 + rl[i] < S
            ? expf(s[j][e] * scale + bias - lse_r[i]) : 0.f;
        float d = dp[j][e];
        if (drop) d = (kw[i][j >> 2] >> (c & 31)) & 1 ? d * keep_scale : 0.f;
        s[j][e] = p * (d - delta_r[i]);
      }
    // dq += dS . K over the block's columns, dS rounded to T in
    // registers, K read transposed
#pragma unroll
    for (int c = 0; c < kB; c += 16) {
      unsigned a[4];
      a_from_acc<T>(a, s[c / 8], s[c / 8 + 1]);
#pragma unroll
      for (int n = 0; n < DH; n += 16) {
        unsigned kb[4];
        ldsm_t(kb, Kt + c * LDS + bt_off + n);
        mma<T>(acc[n / 8], a, kb[0], kb[1]);
        mma<T>(acc[n / 8 + 1], a, kb[2], kb[3]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + rl[i];
    if (row >= S) continue;
    T* drow = head_of(dq, sdq, b, h) + row * sdq.r + n0;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      *reinterpret_cast<unsigned*>(drow + 8 * j + 2 * t4) =
          pack2<T>(acc[j][2 * i] * scale, acc[j][2 * i + 1] * scale);
  }
}

// Per 64-key tile: dk, dv (and dbias) over all q-tiles; warp w owns keys
// 16w..16w+15 of the tile and computes S^T = K . Q^T and dP^T = V . dO^T,
// so that P^T and dS^T land in the accumulator layout, which is the A
// layout of dV += P^T . dO and dK += dS^T . Q. At d 256 two blocks share
// the tile, each writing half of dk's and dv's columns (the first also
// dbias).
template <typename T, int D>
__global__ void __launch_bounds__(kMmaThreads, kMmaBlocks<D>)
    attn_bwd_dkdv_mma(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, BiasView bv,
                      const long long* __restrict__ seed,
                      const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, DBias db, Strides sq, Strides sk,
                      Strides sv, Strides sdo, Strides sdk, Strides sdv,
                      int H, int S, float scale, float p_drop,
                      float keep_scale) {
  constexpr int LDS = kLDS<D>, TS = kB * LDS, NC = kDkdvCols<D>;
  extern __shared__ __align__(16) unsigned char smem16[];
  T* Ks = reinterpret_cast<T*>(smem16);
  T* Vs = Ks + TS;
  T* Qs = Vs + TS;                                  // [2][kB][LDS]
  T* dOs = Qs + 2 * TS;                             // [2][kB][LDS]
  float* Lr = reinterpret_cast<float*>(dOs + 2 * TS);  // [2][kB] lse
  float* Dr = Lr + 2 * kB;                         // [2][kB] delta
  unsigned* Keep = reinterpret_cast<unsigned*>(Dr + 2 * kB);  // [2][kB][2]

  constexpr int DH = D / kHalves<D>;  // the columns of dk, dv it writes
  const int k0 = blockIdx.x / kHalves<D> * kB, h = blockIdx.y, b = blockIdx.z;
  const int n0 = blockIdx.x % kHalves<D> * DH;
  if (n0 != 0) db.ptr = nullptr;      // the first half writes dbias
  const int bh = b * H + h, tid = threadIdx.x, lane = tid & 31;
  const int w = tid >> 5, g = lane >> 2, t4 = lane & 3;
  const int nk = min(kB, S - k0);
  // q-tile q0 (its Q, dO, lse and delta rows) into buffer buf
  auto load_q_tile = [&](int q0, int buf) {
    const int nq = min(kB, S - q0), bb = late(b, q0), hh = late(h, q0);
    load_tile_async<D>(Qs + buf * TS, head_of(q, sq, bb, hh) + q0 * sq.r,
                       sq.r, nq);
    load_tile_async<D>(dOs + buf * TS,
                       head_of(dout, sdo, bb, hh) + q0 * sdo.r, sdo.r, nq);
    if (tid < kB) {
      const bool live = tid < nq;
      const size_t at = static_cast<size_t>(bh) * S + q0 + (live ? tid : 0);
      cp_async4(Lr + buf * kB + tid, lse + at, live);
      cp_async4(Dr + buf * kB + tid, delta + at, live);
    }
    cp_async_commit();
  };
  load_tile_async<D>(Ks, head_of(k, sk, b, h) + k0 * sk.r, sk.r, nk);
  load_tile_async<D>(Vs, head_of(v, sv, b, h) + k0 * sv.r, sv.r, nk);
  load_q_tile(0, 0);
  const bool drop = p_drop > 0.f;
  const bool acc_heads = db.ptr && db.heads == 1 && H > 1;
  const bool reduce_rows = db.ptr && db.rows == 1;
  const bool rowwise = bv.ptr && bv.sr != 0;  // a bias row per query
  const int key0 = k0 + 16 * w + g;  // the thread's keys: key0, key0 + 8
  float colsum[2] = {0.f, 0.f};
  const int a_off = 16 * w * LDS + a_offset<LDS>(lane);
  const int b_off = b_offset<LDS>(lane);
  float adk[DH / 8][4] = {}, adv[DH / 8][4] = {};

  for (int q0 = 0; q0 < S; q0 += kB) {
    const int buf = (q0 / kB) & 1;
    const T* Qt = Qs + buf * TS;
    const T* dOt = dOs + buf * TS;
    const float* lt = Lr + buf * kB;
    const float* dt = Dr + buf * kB;
    unsigned* const keep = Keep + buf * 2 * kB;
    if (drop) keep_bits(seed_key(seed), q0, k0, bh, p_drop, keep);
    cp_async_wait_all();
    __syncthreads();  // tile q0 has landed; tile q0 - kB is consumed
    if (q0 + kB < S) load_q_tile(q0 + kB, buf ^ 1);
#pragma unroll 1  // one chunk's fragments live at a time
    for (int c0 = 0; c0 < kB; c0 += NC) {
      // S^T = K . Q^T and dP^T = V . dO^T, 16 keys x NC queries per warp
      float s[NC / 8][4] = {}, dp[NC / 8][4] = {};
#pragma unroll
      for (int kk = 0; kk < D; kk += 16) {
        unsigned ka[4], va[4];
        ldsm(ka, Ks + a_off + kk);
        ldsm(va, Vs + a_off + kk);
#pragma unroll
        for (int n = 0; n < NC; n += 16) {
          unsigned qb[4], ob[4];
          ldsm(qb, Qt + (c0 + n) * LDS + b_off + kk);
          ldsm(ob, dOt + (c0 + n) * LDS + b_off + kk);
          mma<T>(s[n / 8], ka, qb[0], qb[1]);
          mma<T>(s[n / 8 + 1], ka, qb[2], qb[3]);
          mma<T>(dp[n / 8], va, ob[0], ob[1]);
          mma<T>(dp[n / 8 + 1], va, ob[2], ob[3]);
        }
      }
      // P^T (dropped) in place of S^T, dS^T in place of dP^T, fp32; dbias
      // from the fp32 dS. The bias and dbias addresses are formed here
      // from late() copies of b and h, not kept live across the products:
      // that keeps dk/dv within the 168 registers of three blocks an SM.
      const int bb = late(b, c0), hh = late(h, c0);
      const float* brow0 = bias_row(bv, bb, hh, 0);
      // a row-broadcast bias at the thread's two keys, read before any
      // dbias store (which the compiler must assume may alias it)
      const float bkey[2] = {bias_term(brow0, key0, S),
                             bias_term(brow0, key0 + 8, S)};
      float* db_base =
          db.ptr ? db.ptr + (static_cast<size_t>(bb) * db.heads +
                             (db.heads == 1 ? 0 : hh)) * db.rows * S
                 : nullptr;
#pragma unroll
      for (int j = 0; j < NC / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1, c = c0 + 8 * j + 2 * t4 + (e & 1);
          const int row = q0 + c, key = key0 + 8 * i;
          const float bias = rowwise
              ? bias_term(brow0 + min(row, S - 1) * bv.sr, key, S)
              : bkey[i];
          const float p = row < S
              ? expf(s[j][e] * scale + bias - lt[c]) : 0.f;
          float pd = p, d = dp[j][e];
          if (drop) {
            const bool kept = (keep[2 * c + (w >> 1)] >> (key & 31)) & 1;
            pd = kept ? p * keep_scale : 0.f;
            d = kept ? d * keep_scale : 0.f;
          }
          const float ds = p * (d - dt[c]);
          if (db.ptr && row < S && key < S) {
            if (reduce_rows) {
              colsum[i] += ds;
            } else if (acc_heads) {
              atomicAdd(db_base + static_cast<size_t>(row) * S + key, ds);
            } else {
              db_base[static_cast<size_t>(row) * S + key] = ds;
            }
          }
          s[j][e] = pd;
          dp[j][e] = ds;
        }
      // P^T and dS^T as 16-bit A operands, half the registers of the fp32
      unsigned pa[NC / 16][4], sa[NC / 16][4];
#pragma unroll
      for (int c = 0; c < NC; c += 16) {
        a_from_acc<T>(pa[c / 16], s[c / 8], s[c / 8 + 1]);
        a_from_acc<T>(sa[c / 16], dp[c / 8], dp[c / 8 + 1]);
      }
      // dV += P^T . dO and dK += dS^T . Q over the block's columns, dO
      // and Q read transposed
#pragma unroll
      for (int c = 0; c < NC; c += 16) {
#pragma unroll
        for (int n = 0; n < DH; n += 16) {
          unsigned ob[4], qb[4];
          ldsm_t(ob, dOt + (c0 + c) * LDS + a_offset<LDS>(lane) + n0 + n);
          mma<T>(adv[n / 8], pa[c / 16], ob[0], ob[1]);
          mma<T>(adv[n / 8 + 1], pa[c / 16], ob[2], ob[3]);
          ldsm_t(qb, Qt + (c0 + c) * LDS + a_offset<LDS>(lane) + n0 + n);
          mma<T>(adk[n / 8], sa[c / 16], qb[0], qb[1]);
          mma<T>(adk[n / 8 + 1], sa[c / 16], qb[2], qb[3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + 8 * i;
    if (key >= S) continue;
    T* dkrow = head_of(dk, sdk, b, h) + key * sdk.r + n0;
    T* dvrow = head_of(dv, sdv, b, h) + key * sdv.r + n0;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      *reinterpret_cast<unsigned*>(dkrow + 8 * j + 2 * t4) =
          pack2<T>(adk[j][2 * i] * scale, adk[j][2 * i + 1] * scale);
      *reinterpret_cast<unsigned*>(dvrow + 8 * j + 2 * t4) =
          pack2<T>(adv[j][2 * i], adv[j][2 * i + 1]);
    }
  }
  if (reduce_rows) {  // over the four lanes that share a key, fixed order
    float* db_base = db.ptr + (static_cast<size_t>(b) * db.heads +
                               (db.heads == 1 ? 0 : h)) * S;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      colsum[i] += __shfl_xor_sync(0xffffffffu, colsum[i], 1);
      colsum[i] += __shfl_xor_sync(0xffffffffu, colsum[i], 2);
      const int key = key0 + 8 * i;
      if (t4 == 0 && key < S) {
        if (acc_heads)
          atomicAdd(db_base + key, colsum[i]);
        else
          db_base[key] = colsum[i];
      }
    }
  }
}

// ---- bf16 and fp16 forward on the tensor cores ----------------------------
// Replaces, in the 16-bit types, the TPU forward kernels of
// paddle_tpu/kernels/attention.py: _fwd_kernel (:294), _fwd_kernel_long
// (:362), _flash_fwd_kernel (:602), _packed_fwd_kernel (:917) and
// _res_fwd_kernel (:1170). Bound on the card: 4 S^2 d operations per
// (b, h) at the tensor cores' 989 TFLOP/s from S 590 (the long and flash
// shapes), the bytes of q, k, v and o below (BERT's S 128). Design:
//   * one block per (64-row q-tile, head, batch), four warps of 16 query
//     rows; the warp's Q fragments stay in registers (loaded once by
//     ldmatrix); K and V tiles of 64 keys are double-buffered by 16-byte
//     cp.async (rows past S zero-filled), so tile j + 1 lands under tile
//     j's math; one barrier a tile;
//   * S = Q . K^T by mma.sync m16n8k16 (fp32 accumulators); the online
//     softmax runs in the accumulator layout, in log2 units (one fma and
//     one exp2 a score), each row's max and sum over the four lanes of a
//     quad by shuffles; l sums the unrounded, undropped weights;
//   * P . V: P is fed to the tensor cores in kPPieces pieces of T, each
//     the rounded remainder the ones before leave (two: 16 of fp32's 24
//     bits in bf16, 22 in fp16), and each tile's P . V starts from a zero
//     accumulator and joins O in fp32, O = O * corr + P . V. Two pieces
//     are the fewest that pass the smoke run's multi-seed step check: P
//     in one bf16 piece flips the rounding of about 40% of the outputs
//     against the plain version and moves bert_long's first moment of the
//     output bias past its limit; three pieces cost 17% more time at
//     S 8192 (PERF.md); the remainder piece costs products, not
//     bytes;
//   * dropout: the block draws each 64 x 64 tile's mask into a bitmask
//     (keep_bits, the backward's and the plain version's mask, bit for
//     bit) before the tile's barrier; o = O * keep_scale / l;
//   * lse = m + log(l) per row, for the backward.
// What bounds it at the long shapes: mma.sync's rate (products of 1 + 2
// units, Q.K^T and the pieces of P.V, against the 2 units the function
// needs) and the SIMT softmax work beside it; wgmma and TMA are the next
// step.
constexpr int kPPieces = 2;
constexpr float kLog2e = 1.4426950408889634f, kLn2 = 0.6931471805599453f;
// the largest head width the forward runs on the tensor cores; d 256 takes
// the SIMT forward, whose one block an SM holds its 64-row tiles
constexpr int kMmaFwdMaxD = 128;

// P's A fragments of 16 keys (two accumulator tiles of 8 columns) in N
// pieces of T: piece i is what pieces 0 .. i - 1 leave, rounded to T
template <typename T, int N>
__device__ __forceinline__ void a_pieces(unsigned a[N][4], const float c0[4],
                                         const float c1[4]) {
  const float r[8] = {c0[0], c0[1], c0[2], c0[3],
                      c1[0], c1[1], c1[2], c1[3]};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float lo = r[2 * i], hi = r[2 * i + 1];
#pragma unroll
    for (int n = 0; n < N; ++n) {
      a[n][i] = pack2<T>(lo, hi);
      const float2 f = unpack2<T>(a[n][i]);
      lo -= f.x;
      hi -= f.y;
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kMmaThreads, kMmaBlocks<D>)
    attn_fwd_mma(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, BiasView bv,
                 const long long* __restrict__ seed, T* __restrict__ o,
                 float* __restrict__ lse, Strides sq, Strides sk, Strides sv,
                 Strides so, int H, int S, float scale, float p_drop,
                 float keep_scale) {
  constexpr int LDS = kLDS<D>, TS = kB * LDS, NP = kPPieces;
  extern __shared__ __align__(16) unsigned char smem16[];
  T* Qs = reinterpret_cast<T*>(smem16);
  T* Ks = Qs + TS;                                   // [2][kB][LDS]
  T* Vs = Ks + 2 * TS;                               // [2][kB][LDS]
  float* Ct = reinterpret_cast<float*>(Vs + 2 * TS);  // [2][kB] bias by column
  unsigned* Keep = reinterpret_cast<unsigned*>(Ct + 2 * kB);  // [2][kB][2]

  const int q0 = blockIdx.x * kB, h = blockIdx.y, b = blockIdx.z;
  const int bh = b * H + h, tid = threadIdx.x, lane = tid & 31;
  const int w = tid >> 5, g = lane >> 2, t4 = lane & 3;
  const T* kh = head_of(k, sk, b, h);
  const T* vh = head_of(v, sv, b, h);
  load_tile_async<D>(Qs, head_of(q, sq, b, h) + q0 * sq.r, sq.r,
                     min(kB, S - q0));
  load_tile_async<D>(Ks, kh, sk.r, min(kB, S));
  load_tile_async<D>(Vs, vh, sv.r, min(kB, S));
  cp_async_commit();
  const bool drop = p_drop > 0.f;
  const uint2 key = drop ? seed_key(seed) : make_uint2(0, 0);
  // a bias with a row per query is read per element; a row-broadcast one
  // once per tile into Ct, with -inf past the last key (no bias: 0)
  const bool rowwise = bv.ptr && bv.sr != 0;
  const float* bcast = rowwise ? nullptr : bias_row(bv, b, h, 0);
  int rl[2];  // the thread's two tile rows
  const float* brow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    rl[i] = 16 * w + g + 8 * i;
    brow[i] = rowwise ? bias_row(bv, b, h, min(q0 + rl[i], S - 1)) : nullptr;
  }
  const int a_off = 16 * w * LDS + a_offset<LDS>(lane);
  const int b_off = b_offset<LDS>(lane), bt_off = a_offset<LDS>(lane);
  const float scale2 = scale * kLog2e;
  unsigned qa[D / 16][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // log2 units
  float acc[D / 8][4] = {};

  for (int k0 = 0; k0 < S; k0 += kB) {
    const int buf = (k0 / kB) & 1;
    const T* Kt = Ks + buf * TS;
    const T* Vt = Vs + buf * TS;
    float* ct = Ct + buf * kB;
    unsigned* const keep = Keep + buf * 2 * kB;
    if (tid < kB) ct[tid] = bias_term(bcast, k0 + tid, S);
    if (drop) keep_bits(key, q0, k0, bh, p_drop, keep);
    cp_async_wait_all();
    __syncthreads();  // tile k0 has landed; tile k0 - kB is consumed
    if (k0 == 0) {
#pragma unroll
      for (int kk = 0; kk < D; kk += 16) ldsm(qa[kk / 16], Qs + a_off + kk);
    }
    if (k0 + kB < S) {  // the next tile's copies overlap this tile's math
      const int nk = min(kB, S - k0 - kB);
      load_tile_async<D>(Ks + (buf ^ 1) * TS, kh + (k0 + kB) * sk.r, sk.r,
                         nk);
      load_tile_async<D>(Vs + (buf ^ 1) * TS, vh + (k0 + kB) * sv.r, sv.r,
                         nk);
      cp_async_commit();
    }
    // S = Q . K^T, 16 x 64 per warp
    float s[kB / 8][4] = {};
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
#pragma unroll
      for (int n = 0; n < kB; n += 16) {
        unsigned kb[4];
        ldsm(kb, Kt + n * LDS + b_off + kk);
        mma<T>(s[n / 8], qa[kk / 16], kb[0], kb[1]);
        mma<T>(s[n / 8 + 1], qa[kk / 16], kb[2], kb[3]);
      }
    }
    // (s * scale + bias) * log2(e); -inf past the last key
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kB / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, c = 8 * j + 2 * t4 + (e & 1);
        const float bias = rowwise ? bias_term(brow[i], k0 + c, S) : ct[c];
        s[j][e] = fmaf(s[j][e], scale2, bias * kLog2e);
        mx[i] = fmaxf(mx[i], s[j][e]);
      }
    // every tile holds a live column, so each new max is finite
    float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      corr[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < kB / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - m[e >> 1]);
        rs[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
      l[i] = l[i] * corr[i] + rs[i];
    }
    if (drop) {  // dropped weights leave P . V, not l
      unsigned kw[2][2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int half = 0; half < 2; ++half)
          kw[i][half] = keep[2 * rl[i] + half];
#pragma unroll
      for (int j = 0; j < kB / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + 2 * t4 + (e & 1);
          if (!((kw[e >> 1][j >> 2] >> (c & 31)) & 1)) s[j][e] = 0.f;
        }
    }
    // O = O * corr + P . V, the tile's P . V from a zero accumulator, P in
    // NP pieces of T (the smallest first), V read transposed
    float pv[D / 8][4] = {};
#pragma unroll
    for (int c = 0; c < kB; c += 16) {
      unsigned pa[NP][4];
      a_pieces<T, NP>(pa, s[c / 8], s[c / 8 + 1]);
#pragma unroll
      for (int n = 0; n < D; n += 16) {
        unsigned vb[4];
        ldsm_t(vb, Vt + c * LDS + bt_off + n);
#pragma unroll
        for (int piece = NP - 1; piece >= 0; --piece) {
          mma<T>(pv[n / 8], pa[piece], vb[0], vb[1]);
          mma<T>(pv[n / 8 + 1], pa[piece], vb[2], vb[3]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[j][e] = fmaf(acc[j][e], corr[e >> 1], pv[j][e]);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + rl[i];
    if (row >= S) continue;
    const float inv = keep_scale / l[i];
    T* orow = head_of(o, so, b, h) + row * so.r;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<unsigned*>(orow + 8 * j + 2 * t4) =
          pack2<T>(acc[j][2 * i] * inv, acc[j][2 * i + 1] * inv);
    if (t4 == 0)
      lse[static_cast<size_t>(bh) * S + row] = m[i] * kLn2 + logf(l[i]);
  }
}

// ---- fp32 on the tensor cores: 3xTF32 --------------------------------------
// Replaces, in fp32, _fwd_kernel (:294) at d 16 to 128 and _bwd_kernel
// (:307) at d 16 to 64 of paddle_tpu/kernels/attention.py, and in that
// type the long, flash, packed and resident tiers' kernels, as the SIMT
// kernels did before: attn_fwd_tf32x3, attn_bwd_dq_tf32x3 (which also
// writes delta) and attn_bwd_dkdv_tf32x3 (which also writes dbias, from
// the fp32 dS) compute what attn_fwd, attn_bwd_dq and attn_bwd_dkdv
// compute, with the 16-bit kernels' tiling, pipeline, Philox bitmask and
// bias handling.
// Bound on the card: the operations (4 S^2 d a (b, h) pair forward, 6 and
// 8 in dq and dk/dv), three TF32 products each at 494.7 TFLOP/s, so about
// 165 TFLOP/s of fp32-accurate products against the SIMT cores' 67.
// Design:
//   * instruction: mma.sync m16n8k8 with TF32 operands and fp32
//     accumulators. Each fp32 operand x is split into hi = x rounded to
//     TF32 (cvt.rna) and lo = x - hi, whose fp32 bits the tensor cores
//     read truncated to TF32 (as CUTLASS's 3xTF32 passes its small part:
//     the same accuracy on the H100 as lo rounded by cvt, and 10-14% less
//     time), and each product is lo.hi + hi.lo, then hi.hi, into one
//     accumulator (mma3: CUTLASS's order, the small terms first), which
//     keeps about fp32's accuracy where hi.hi alone keeps TF32's 11 bits;
//   * fragments without ldmatrix (which moves 16-bit elements): 32-bit
//     shared loads from fp32 tiles whose rows are padded by 16 bytes
//     (stride d + 4), so that the A fragment (rows g and g + 8, columns t
//     and t + 4, with g = lane / 4, t = lane % 4) and the B fragment of
//     K^T (key g, columns t and t + 4) land the 32 lanes on 32 banks;
//   * accumulator to A operand: an m16n8 accumulator gives a thread the
//     columns 2t and 2t + 1, the m16n8k8 A operand wants t and t + 4. The
//     contraction index is relabelled (A slot t stands for key 2t, slot
//     t + 4 for key 2t + 1) and the B fragment's rows are read as keys 2t
//     and 2t + 1 (V in P.V, K in dS.K, dO and Q in dk/dv; banks 8t + g,
//     also free of conflicts): P and dS stay in registers;
//   * splits in registers as fragments are read: the forward splits Q's
//     once a block up to d 64 (at d 128, to save registers, each tile),
//     the backward its resident operands' each tile, every kernel the
//     streamed tiles' as it reads them;
//   * short mma chains: the tensor cores' fp32 sums truncate, so a chain
//     of products into one accumulator leans toward zero by up to an ulp
//     a step; chains over every key of S 4096 and 8192 missed the fp32
//     card tests' limits on the H100, so every product over keys or queries
//     (P.V, dS.K, P^T.dO, dS^T.Q) runs one 64-row tile (24 steps) from a
//     zero accumulator, joined to the fp32 sum on the SIMT cores (O = O *
//     corr + P.V; dq, dk, dv += the tile's) as the 16-bit forward does;
//   * shared memory: five (forward) or six (backward) fp32 64 x (d + 4)
//     tiles, 87 KB and 104 KB at d 64 (two blocks an SM), the forward's
//     169 KB at d 128 (one), 16-byte cp.async double buffers with rows
//     past S zero-filled, as in the 16-bit kernels;
//   * d 128: the backward's six tiles (203 KB) leave one block of four
//     warps an SM, and its accumulators and the tiles' partial sums pass
//     the 255 registers a thread can have; split into two column halves
//     a block it ran 2.50 ms on the H100 at B 8, H 8, S 512 against the
//     SIMT kernels' 1.77 (tools/attention_fault_check.py), so fp32 at
//     d 128 runs the 3xTF32 forward and the SIMT backward, and at d 256
//     the SIMT kernels.
// the widest heads fp32 runs at on them: the forward, the backward
constexpr int kTf32MaxD = 128, kTf32BwdMaxD = 64;
template <int D> constexpr int kTf32LDS = D + 4;  // row stride of a tile
template <int D> constexpr int kTf32Blocks = D <= 32 ? 3 : D <= 64 ? 2 : 1;
template <int D> constexpr bool kHoldQ = D <= 64;  // Q's split fragments
// query columns of S^T and dP^T the dk/dv kernel holds in registers at once
template <int D> constexpr int kTf32DkdvCols = D >= 32 ? 32 : 64;

__device__ __forceinline__ unsigned to_tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo to about fp32's accuracy: hi rounded to TF32, lo the
// remainder in fp32 bits, which the tensor cores read truncated to TF32
__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  hi = to_tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c[16 x 8] += a[16 x 8] . b[8 x 8], TF32 operands, fp32 accumulators
__device__ __forceinline__ void mma_tf32(float c[4], const unsigned a[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a . b from the TF32 pairs of both: lo.hi + hi.lo, then hi.hi
__device__ __forceinline__ void mma3(float c[4], const unsigned ah[4],
                                     const unsigned al[4],
                                     const unsigned bh[2],
                                     const unsigned bl[2]) {
  mma_tf32(c, al, bh[0], bh[1]);
  mma_tf32(c, ah, bl[0], bl[1]);
  mma_tf32(c, ah, bh[0], bh[1]);
}

// the split A fragment of the 16 x 8 block of a tile at s: rows g and
// g + 8, columns t and t + 4
template <int LDS>
__device__ __forceinline__ void a_frag(unsigned hi[4], unsigned lo[4],
                                       const float* s, int g, int t) {
  split_tf32(s[g * LDS + t], hi[0], lo[0]);
  split_tf32(s[(g + 8) * LDS + t], hi[1], lo[1]);
  split_tf32(s[g * LDS + t + 4], hi[2], lo[2]);
  split_tf32(s[(g + 8) * LDS + t + 4], hi[3], lo[3]);
}

// the split B fragment of X^T for the 8 rows of X at s: X[g][t] and
// X[g][t + 4] (K in Q.K^T, V in dO.V^T, Q and dO in dk/dv)
template <int LDS>
__device__ __forceinline__ void bt_frag(unsigned hi[2], unsigned lo[2],
                                        const float* s, int g, int t) {
  split_tf32(s[g * LDS + t], hi[0], lo[0]);
  split_tf32(s[g * LDS + t + 4], hi[1], lo[1]);
}

// the split B fragment of the 8 rows of X at s, the contraction
// relabelled as a_from_acc_tf32's: X[2t][g] and X[2t + 1][g]
template <int LDS>
__device__ __forceinline__ void b_frag_pairs(unsigned hi[2], unsigned lo[2],
                                             const float* s, int g, int t) {
  split_tf32(s[2 * t * LDS + g], hi[0], lo[0]);
  split_tf32(s[(2 * t + 1) * LDS + g], hi[1], lo[1]);
}

// the split A operand of the next product from an m16n8 accumulator tile
// c (rows g, g + 8; columns 2t, 2t + 1): slot t takes column 2t, slot
// t + 4 column 2t + 1
__device__ __forceinline__ void a_from_acc_tf32(unsigned hi[4],
                                                unsigned lo[4],
                                                const float c[4]) {
  split_tf32(c[0], hi[0], lo[0]);
  split_tf32(c[2], hi[1], lo[1]);
  split_tf32(c[1], hi[2], lo[2]);
  split_tf32(c[3], hi[3], lo[3]);
}

template <typename T, int D>
__global__ void __launch_bounds__(kMmaThreads, kTf32Blocks<D>)
    attn_fwd_tf32x3(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, BiasView bv,
                    const long long* __restrict__ seed, T* __restrict__ o,
                    float* __restrict__ lse, Strides sq, Strides sk,
                    Strides sv, Strides so, int H, int S, float scale,
                    float p_drop, float keep_scale) {
  static_assert(std::is_same<T, float>::value, "3xTF32 takes fp32");
  constexpr int LDS = kTf32LDS<D>, TS = kB * LDS;
  constexpr int KQ = kHoldQ<D> ? D / 8 : 1;
  extern __shared__ __align__(16) unsigned char smem16[];
  float* Qs = reinterpret_cast<float*>(smem16);
  float* Ks = Qs + TS;                                 // [2][kB][LDS]
  float* Vs = Ks + 2 * TS;                             // [2][kB][LDS]
  float* Ct = Vs + 2 * TS;                             // [2][kB] bias by column
  unsigned* Keep = reinterpret_cast<unsigned*>(Ct + 2 * kB);  // [2][kB][2]

  const int q0 = blockIdx.x * kB, h = blockIdx.y, b = blockIdx.z;
  const int bh = b * H + h, tid = threadIdx.x, lane = tid & 31;
  const int w = tid >> 5, g = lane >> 2, t4 = lane & 3;
  const float* kh = head_of(k, sk, b, h);
  const float* vh = head_of(v, sv, b, h);
  load_tile_async<D>(Qs, head_of(q, sq, b, h) + q0 * sq.r, sq.r,
                     min(kB, S - q0));
  load_tile_async<D>(Ks, kh, sk.r, min(kB, S));
  load_tile_async<D>(Vs, vh, sv.r, min(kB, S));
  cp_async_commit();
  const bool drop = p_drop > 0.f;
  const uint2 key = drop ? seed_key(seed) : make_uint2(0, 0);
  // a bias with a row per query is read per element; a row-broadcast one
  // once per tile into Ct, with -inf past the last key (no bias: 0)
  const bool rowwise = bv.ptr && bv.sr != 0;
  const float* bcast = rowwise ? nullptr : bias_row(bv, b, h, 0);
  int rl[2];  // the thread's two tile rows
  const float* brow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    rl[i] = 16 * w + g + 8 * i;
    brow[i] = rowwise ? bias_row(bv, b, h, min(q0 + rl[i], S - 1)) : nullptr;
  }
  const float* Qw = Qs + 16 * w * LDS;  // the warp's 16 query rows
  const float scale2 = scale * kLog2e;
  unsigned qh[KQ][4], ql[KQ][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // log2 units
  float acc[D / 8][4] = {};

  for (int k0 = 0; k0 < S; k0 += kB) {
    const int buf = (k0 / kB) & 1;
    const float* Kt = Ks + buf * TS;
    const float* Vt = Vs + buf * TS;
    float* ct = Ct + buf * kB;
    unsigned* const keep = Keep + buf * 2 * kB;
    if (tid < kB) ct[tid] = bias_term(bcast, k0 + tid, S);
    if (drop) keep_bits(key, q0, k0, bh, p_drop, keep);
    cp_async_wait_all();
    __syncthreads();  // tile k0 has landed; tile k0 - kB is consumed
    if constexpr (kHoldQ<D>) {
      if (k0 == 0) {
#pragma unroll
        for (int kk = 0; kk < D; kk += 8)
          a_frag<LDS>(qh[kk / 8], ql[kk / 8], Qw + kk, g, t4);
      }
    }
    if (k0 + kB < S) {  // the next tile's copies overlap this tile's math
      const int nk = min(kB, S - k0 - kB);
      load_tile_async<D>(Ks + (buf ^ 1) * TS, kh + (k0 + kB) * sk.r, sk.r,
                         nk);
      load_tile_async<D>(Vs + (buf ^ 1) * TS, vh + (k0 + kB) * sv.r, sv.r,
                         nk);
      cp_async_commit();
    }
    // S = Q . K^T, 16 x 64 per warp
    float s[kB / 8][4] = {};
#pragma unroll
    for (int kk = 0; kk < D; kk += 8) {
      unsigned ah[4], al[4];
      if constexpr (kHoldQ<D>) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ah[i] = qh[kk / 8][i];
          al[i] = ql[kk / 8][i];
        }
      } else {
        a_frag<LDS>(ah, al, Qw + kk, g, t4);
      }
#pragma unroll
      for (int n = 0; n < kB; n += 8) {
        unsigned kb_hi[2], kb_lo[2];
        bt_frag<LDS>(kb_hi, kb_lo, Kt + n * LDS + kk, g, t4);
        mma3(s[n / 8], ah, al, kb_hi, kb_lo);
      }
    }
    // (s * scale + bias) * log2(e); -inf past the last key
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kB / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, c = 8 * j + 2 * t4 + (e & 1);
        const float bias = rowwise ? bias_term(brow[i], k0 + c, S) : ct[c];
        s[j][e] = fmaf(s[j][e], scale2, bias * kLog2e);
        mx[i] = fmaxf(mx[i], s[j][e]);
      }
    // every tile holds a live column, so each new max is finite
    float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      corr[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < kB / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - m[e >> 1]);
        rs[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
      l[i] = l[i] * corr[i] + rs[i];
    }
    if (drop) {  // dropped weights leave P . V, not l
      unsigned kw[2][2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int half = 0; half < 2; ++half)
          kw[i][half] = keep[2 * rl[i] + half];
#pragma unroll
      for (int j = 0; j < kB / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + 2 * t4 + (e & 1);
          if (!((kw[e >> 1][j >> 2] >> (c & 31)) & 1)) s[j][e] = 0.f;
        }
    }
    // O = O * corr + P . V, the tile's P . V from a zero accumulator, 8
    // keys a product
    float tile_pv[D / 8][4] = {};
#pragma unroll
    for (int c = 0; c < kB; c += 8) {
      unsigned ph[4], pl[4];
      a_from_acc_tf32(ph, pl, s[c / 8]);
#pragma unroll
      for (int n = 0; n < D; n += 8) {
        unsigned vb_hi[2], vb_lo[2];
        b_frag_pairs<LDS>(vb_hi, vb_lo, Vt + c * LDS + n, g, t4);
        mma3(tile_pv[n / 8], ph, pl, vb_hi, vb_lo);
      }
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[j][e] = fmaf(acc[j][e], corr[e >> 1], tile_pv[j][e]);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + rl[i];
    if (row >= S) continue;
    const float inv = keep_scale / l[i];
    float* orow = head_of(o, so, b, h) + row * so.r;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      orow[8 * j + 2 * t4] = acc[j][2 * i] * inv;
      orow[8 * j + 2 * t4 + 1] = acc[j][2 * i + 1] * inv;
    }
    if (t4 == 0)
      lse[static_cast<size_t>(bh) * S + row] = m[i] * kLn2 + logf(l[i]);
  }
}

// Per 64-row q-tile: delta = rowsum(dO * O) (also written out), then dq
// over all k-tiles; warp w owns query rows 16w..16w+15 of the tile.
template <typename T, int D>
__global__ void __launch_bounds__(kMmaThreads, kTf32Blocks<D>)
    attn_bwd_dq_tf32x3(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, BiasView bv,
                       const long long* __restrict__ seed,
                       const T* __restrict__ o, const T* __restrict__ dout,
                       const float* __restrict__ lse,
                       float* __restrict__ delta, T* __restrict__ dq,
                       Strides sq, Strides sk, Strides sv, Strides so,
                       Strides sdo, Strides sdq, int H, int S, float scale,
                       float p_drop, float keep_scale) {
  static_assert(std::is_same<T, float>::value, "3xTF32 takes fp32");
  constexpr int LDS = kTf32LDS<D>, TS = kB * LDS;
  extern __shared__ __align__(16) unsigned char smem16[];
  float* Qs = reinterpret_cast<float*>(smem16);
  float* dOs = Qs + TS;
  float* Ks = dOs + TS;                                // [2][kB][LDS]
  float* Vs = Ks + 2 * TS;                             // [2][kB][LDS]
  float* Ct = Vs + 2 * TS;                             // [2][kB] bias by column
  float* Dr = Ct + 2 * kB;                             // [kB] delta of the rows
  unsigned* Keep = reinterpret_cast<unsigned*>(Dr + kB);  // [2][kB][2]

  const int q0 = blockIdx.x * kB, h = blockIdx.y, b = blockIdx.z;
  const int bh = b * H + h, tid = threadIdx.x, lane = tid & 31;
  const int w = tid >> 5, g = lane >> 2, t4 = lane & 3;
  const float* kh = head_of(k, sk, b, h);
  const float* vh = head_of(v, sv, b, h);
  const int nq = min(kB, S - q0);
  load_tile_async<D>(Qs, head_of(q, sq, b, h) + q0 * sq.r, sq.r, nq);
  load_tile_async<D>(dOs, head_of(dout, sdo, b, h) + q0 * sdo.r, sdo.r, nq);
  load_tile_async<D>(Ks, kh, sk.r, min(kB, S));
  load_tile_async<D>(Vs, vh, sv.r, min(kB, S));
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  {  // two threads per row, lanes 2r and 2r + 1 of one warp
    const int r = tid >> 1, part = tid & 1;
    float acc = 0.f;
    if (r < nq) {
      const float* orow = head_of(o, so, b, h) + (q0 + r) * so.r;
      for (int e = part; e < D; e += 2)
        acc = fmaf(dOs[r * LDS + e], orow[e], acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (part == 0) {
      Dr[r] = acc;
      if (r < nq) delta[static_cast<size_t>(bh) * S + q0 + r] = acc;
    }
  }
  const bool drop = p_drop > 0.f;
  const uint2 key = drop ? seed_key(seed) : make_uint2(0, 0);
  const bool rowwise = bv.ptr && bv.sr != 0;
  const float* bcast = rowwise ? nullptr : bias_row(bv, b, h, 0);
  __syncthreads();  // Dr
  int rl[2];        // the thread's two tile rows
  float lse_r[2], delta_r[2];
  const float* brow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    rl[i] = 16 * w + g + 8 * i;
    const int row = q0 + rl[i];
    lse_r[i] = row < S ? lse[static_cast<size_t>(bh) * S + row] : 0.f;
    delta_r[i] = Dr[rl[i]];
    brow[i] = rowwise ? bias_row(bv, b, h, min(row, S - 1)) : nullptr;
  }
  const float* Qw = Qs + 16 * w * LDS;  // the warp's 16 query rows
  const float* dOw = dOs + 16 * w * LDS;
  float acc[D / 8][4] = {};

  for (int k0 = 0; k0 < S; k0 += kB) {
    const int buf = (k0 / kB) & 1;
    const float* Kt = Ks + buf * TS;
    const float* Vt = Vs + buf * TS;
    float* ct = Ct + buf * kB;
    unsigned* const keep = Keep + buf * 2 * kB;
    if (tid < kB) ct[tid] = bias_term(bcast, k0 + tid, S);
    if (drop) keep_bits(key, q0, k0, bh, p_drop, keep);
    cp_async_wait_all();
    __syncthreads();  // tile k0 has landed; tile k0 - kB is consumed
    if (k0 + kB < S) {  // the next tile's copies overlap this tile's math
      const int nk = min(kB, S - k0 - kB);
      load_tile_async<D>(Ks + (buf ^ 1) * TS, kh + (k0 + kB) * sk.r, sk.r,
                         nk);
      load_tile_async<D>(Vs + (buf ^ 1) * TS, vh + (k0 + kB) * sv.r, sv.r,
                         nk);
      cp_async_commit();
    }
    // S = Q . K^T and dP = dO . V^T, 16 x 64 per warp
    float s[kB / 8][4] = {}, dp[kB / 8][4] = {};
#pragma unroll
    for (int kk = 0; kk < D; kk += 8) {
      unsigned qa_hi[4], qa_lo[4], da_hi[4], da_lo[4];
      a_frag<LDS>(qa_hi, qa_lo, Qw + kk, g, t4);
      a_frag<LDS>(da_hi, da_lo, dOw + kk, g, t4);
#pragma unroll
      for (int n = 0; n < kB; n += 8) {
        unsigned b_hi[2], b_lo[2];
        bt_frag<LDS>(b_hi, b_lo, Kt + n * LDS + kk, g, t4);
        mma3(s[n / 8], qa_hi, qa_lo, b_hi, b_lo);
        bt_frag<LDS>(b_hi, b_lo, Vt + n * LDS + kk, g, t4);
        mma3(dp[n / 8], da_hi, da_lo, b_hi, b_lo);
      }
    }
    // dS = P * (dP * keep * keep_scale - delta), in place of S, fp32
    unsigned kw[2][2] = {};
    if (drop) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int half = 0; half < 2; ++half)
          kw[i][half] = keep[2 * rl[i] + half];
    }
#pragma unroll
    for (int j = 0; j < kB / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, c = 8 * j + 2 * t4 + (e & 1);
        const float bias = rowwise ? bias_term(brow[i], k0 + c, S) : ct[c];
        const float p = q0 + rl[i] < S
            ? expf(s[j][e] * scale + bias - lse_r[i]) : 0.f;
        float d = dp[j][e];
        if (drop) d = (kw[i][j >> 2] >> (c & 31)) & 1 ? d * keep_scale : 0.f;
        s[j][e] = p * (d - delta_r[i]);
      }
    // dq += dS . K, the tile's from a zero accumulator, 8 keys a product
    float part[D / 8][4] = {};
#pragma unroll
    for (int c = 0; c < kB; c += 8) {
      unsigned a_hi[4], a_lo[4];
      a_from_acc_tf32(a_hi, a_lo, s[c / 8]);
#pragma unroll
      for (int n = 0; n < D; n += 8) {
        unsigned b_hi[2], b_lo[2];
        b_frag_pairs<LDS>(b_hi, b_lo, Kt + c * LDS + n, g, t4);
        mma3(part[n / 8], a_hi, a_lo, b_hi, b_lo);
      }
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += part[j][e];
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + rl[i];
    if (row >= S) continue;
    float* drow = head_of(dq, sdq, b, h) + row * sdq.r;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      drow[8 * j + 2 * t4] = acc[j][2 * i] * scale;
      drow[8 * j + 2 * t4 + 1] = acc[j][2 * i + 1] * scale;
    }
  }
}

// Per 64-key tile: dk, dv (and dbias) over all q-tiles; warp w owns keys
// 16w..16w+15 of the tile and computes S^T = K . Q^T and dP^T = V . dO^T
// over NC query columns at a time, so that P^T and dS^T land in the
// accumulator layout, the A operand of dV += P^T . dO and
// dK += dS^T . Q.
template <typename T, int D>
__global__ void __launch_bounds__(kMmaThreads, kTf32Blocks<D>)
    attn_bwd_dkdv_tf32x3(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, BiasView bv,
                         const long long* __restrict__ seed,
                         const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, DBias db, Strides sq,
                         Strides sk, Strides sv, Strides sdo, Strides sdk,
                         Strides sdv, int H, int S, float scale,
                         float p_drop, float keep_scale) {
  static_assert(std::is_same<T, float>::value, "3xTF32 takes fp32");
  constexpr int LDS = kTf32LDS<D>, TS = kB * LDS, NC = kTf32DkdvCols<D>;
  extern __shared__ __align__(16) unsigned char smem16[];
  float* Ks = reinterpret_cast<float*>(smem16);
  float* Vs = Ks + TS;
  float* Qs = Vs + TS;                                 // [2][kB][LDS]
  float* dOs = Qs + 2 * TS;                            // [2][kB][LDS]
  float* Lr = dOs + 2 * TS;                            // [2][kB] lse
  float* Dr = Lr + 2 * kB;                             // [2][kB] delta
  unsigned* Keep = reinterpret_cast<unsigned*>(Dr + 2 * kB);  // [2][kB][2]

  const int k0 = blockIdx.x * kB, h = blockIdx.y, b = blockIdx.z;
  const int bh = b * H + h, tid = threadIdx.x, lane = tid & 31;
  const int w = tid >> 5, g = lane >> 2, t4 = lane & 3;
  const int nk = min(kB, S - k0);
  // q-tile q0 (its Q, dO, lse and delta rows) into buffer buf
  auto load_q_tile = [&](int q0, int buf) {
    const int nq = min(kB, S - q0), bb = late(b, q0), hh = late(h, q0);
    load_tile_async<D>(Qs + buf * TS, head_of(q, sq, bb, hh) + q0 * sq.r,
                       sq.r, nq);
    load_tile_async<D>(dOs + buf * TS,
                       head_of(dout, sdo, bb, hh) + q0 * sdo.r, sdo.r, nq);
    if (tid < kB) {
      const bool live = tid < nq;
      const size_t at = static_cast<size_t>(bh) * S + q0 + (live ? tid : 0);
      cp_async4(Lr + buf * kB + tid, lse + at, live);
      cp_async4(Dr + buf * kB + tid, delta + at, live);
    }
    cp_async_commit();
  };
  load_tile_async<D>(Ks, head_of(k, sk, b, h) + k0 * sk.r, sk.r, nk);
  load_tile_async<D>(Vs, head_of(v, sv, b, h) + k0 * sv.r, sv.r, nk);
  load_q_tile(0, 0);
  const bool drop = p_drop > 0.f;
  const bool acc_heads = db.ptr && db.heads == 1 && H > 1;
  const bool reduce_rows = db.ptr && db.rows == 1;
  const bool rowwise = bv.ptr && bv.sr != 0;  // a bias row per query
  const int key0 = k0 + 16 * w + g;  // the thread's keys: key0, key0 + 8
  float colsum[2] = {0.f, 0.f};
  const float* Kw = Ks + 16 * w * LDS;  // the warp's 16 keys
  const float* Vw = Vs + 16 * w * LDS;
  float adk[D / 8][4] = {}, adv[D / 8][4] = {};

  for (int q0 = 0; q0 < S; q0 += kB) {
    const int buf = (q0 / kB) & 1;
    const float* Qt = Qs + buf * TS;
    const float* dOt = dOs + buf * TS;
    const float* lt = Lr + buf * kB;
    const float* dt = Dr + buf * kB;
    unsigned* const keep = Keep + buf * 2 * kB;
    if (drop) keep_bits(seed_key(seed), q0, k0, bh, p_drop, keep);
    cp_async_wait_all();
    __syncthreads();  // tile q0 has landed; tile q0 - kB is consumed
    if (q0 + kB < S) load_q_tile(q0 + kB, buf ^ 1);
    // the tile's dk and dv, from zero accumulators
    float pdk[D / 8][4] = {}, pdv[D / 8][4] = {};
#pragma unroll 1  // one chunk's fragments live at a time
    for (int c0 = 0; c0 < kB; c0 += NC) {
      // S^T = K . Q^T and dP^T = V . dO^T, 16 keys x NC queries per warp
      float s[NC / 8][4] = {}, dp[NC / 8][4] = {};
#pragma unroll
      for (int kk = 0; kk < D; kk += 8) {
        unsigned ka_hi[4], ka_lo[4], va_hi[4], va_lo[4];
        a_frag<LDS>(ka_hi, ka_lo, Kw + kk, g, t4);
        a_frag<LDS>(va_hi, va_lo, Vw + kk, g, t4);
#pragma unroll
        for (int n = 0; n < NC; n += 8) {
          unsigned b_hi[2], b_lo[2];
          bt_frag<LDS>(b_hi, b_lo, Qt + (c0 + n) * LDS + kk, g, t4);
          mma3(s[n / 8], ka_hi, ka_lo, b_hi, b_lo);
          bt_frag<LDS>(b_hi, b_lo, dOt + (c0 + n) * LDS + kk, g, t4);
          mma3(dp[n / 8], va_hi, va_lo, b_hi, b_lo);
        }
      }
      // P^T (dropped) in place of S^T, dS^T in place of dP^T, fp32; dbias
      // from the fp32 dS, its addresses formed here from late() copies
      const int bb = late(b, c0), hh = late(h, c0);
      const float* brow0 = bias_row(bv, bb, hh, 0);
      // a row-broadcast bias at the thread's two keys, read before any
      // dbias store (which the compiler must assume may alias it)
      const float bkey[2] = {bias_term(brow0, key0, S),
                             bias_term(brow0, key0 + 8, S)};
      float* db_base =
          db.ptr ? db.ptr + (static_cast<size_t>(bb) * db.heads +
                             (db.heads == 1 ? 0 : hh)) * db.rows * S
                 : nullptr;
#pragma unroll
      for (int j = 0; j < NC / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1, c = c0 + 8 * j + 2 * t4 + (e & 1);
          const int row = q0 + c, key = key0 + 8 * i;
          const float bias = rowwise
              ? bias_term(brow0 + min(row, S - 1) * bv.sr, key, S)
              : bkey[i];
          const float p = row < S
              ? expf(s[j][e] * scale + bias - lt[c]) : 0.f;
          float pd = p, d = dp[j][e];
          if (drop) {
            const bool kept = (keep[2 * c + (w >> 1)] >> (key & 31)) & 1;
            pd = kept ? p * keep_scale : 0.f;
            d = kept ? d * keep_scale : 0.f;
          }
          const float ds = p * (d - dt[c]);
          if (db.ptr && row < S && key < S) {
            if (reduce_rows) {
              colsum[i] += ds;
            } else if (acc_heads) {
              atomicAdd(db_base + static_cast<size_t>(row) * S + key, ds);
            } else {
              db_base[static_cast<size_t>(row) * S + key] = ds;
            }
          }
          s[j][e] = pd;
          dp[j][e] = ds;
        }
      // dV += P^T . dO and dK += dS^T . Q, 8 queries a product
#pragma unroll
      for (int c = 0; c < NC; c += 8) {
        unsigned pa_hi[4], pa_lo[4], sa_hi[4], sa_lo[4];
        a_from_acc_tf32(pa_hi, pa_lo, s[c / 8]);
        a_from_acc_tf32(sa_hi, sa_lo, dp[c / 8]);
#pragma unroll
        for (int n = 0; n < D; n += 8) {
          unsigned b_hi[2], b_lo[2];
          b_frag_pairs<LDS>(b_hi, b_lo, dOt + (c0 + c) * LDS + n, g, t4);
          mma3(pdv[n / 8], pa_hi, pa_lo, b_hi, b_lo);
          b_frag_pairs<LDS>(b_hi, b_lo, Qt + (c0 + c) * LDS + n, g, t4);
          mma3(pdk[n / 8], sa_hi, sa_lo, b_hi, b_lo);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        adk[j][e] += pdk[j][e];
        adv[j][e] += pdv[j][e];
      }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + 8 * i;
    if (key >= S) continue;
    float* dkrow = head_of(dk, sdk, b, h) + key * sdk.r;
    float* dvrow = head_of(dv, sdv, b, h) + key * sdv.r;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      dkrow[8 * j + 2 * t4] = adk[j][2 * i] * scale;
      dkrow[8 * j + 2 * t4 + 1] = adk[j][2 * i + 1] * scale;
      dvrow[8 * j + 2 * t4] = adv[j][2 * i];
      dvrow[8 * j + 2 * t4 + 1] = adv[j][2 * i + 1];
    }
  }
  if (reduce_rows) {  // over the four lanes that share a key, fixed order
    float* db_base = db.ptr + (static_cast<size_t>(b) * db.heads +
                               (db.heads == 1 ? 0 : h)) * S;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      colsum[i] += __shfl_xor_sync(0xffffffffu, colsum[i], 1);
      colsum[i] += __shfl_xor_sync(0xffffffffu, colsum[i], 2);
      const int key = key0 + 8 * i;
      if (t4 == 0 && key < S) {
        if (acc_heads)
          atomicAdd(db_base + key, colsum[i]);
        else
          db_base[key] = colsum[i];
      }
    }
  }
}

template <int D>
constexpr size_t smem_fwd() { return sizeof(float) * (3 * kB * (D + 1) + kB * kLP); }
template <int D>
constexpr size_t smem_dq() {
  constexpr int TB = kBwdRows<D>;
  return sizeof(float) * (4 * TB * (D + 1) + TB * (TB + 1) + 2 * TB);
}
template <int D>
constexpr size_t smem_dkdv() {
  constexpr int TB = kBwdRows<D>;
  return sizeof(float) * (4 * TB * (D + 1) + 2 * TB * (TB + 1) + 2 * TB);
}

// the tensor-core kernels' (the same for bf16 and fp16: two bytes an
// element)
template <int D>
constexpr size_t smem_dq_mma() {
  return sizeof(bf16) * 6 * kB * kLDS<D> + sizeof(float) * 3 * kB +
         sizeof(unsigned) * 4 * kB;
}
template <int D>
constexpr size_t smem_dkdv_mma() {
  return sizeof(bf16) * 6 * kB * kLDS<D> + sizeof(float) * 4 * kB +
         sizeof(unsigned) * 4 * kB;
}
template <int D>
constexpr size_t smem_fwd_mma() {
  return sizeof(bf16) * 5 * kB * kLDS<D> + sizeof(float) * 2 * kB +
         sizeof(unsigned) * 4 * kB;
}

// the 3xTF32 kernels' (fp32 tiles)
template <int D>
constexpr size_t smem_fwd_tf32() {
  return sizeof(float) * (5 * kB * kTf32LDS<D> + 2 * kB) +
         sizeof(unsigned) * 4 * kB;
}
template <int D>
constexpr size_t smem_dq_tf32() {
  return sizeof(float) * (6 * kB * kTf32LDS<D> + 3 * kB) +
         sizeof(unsigned) * 4 * kB;
}
template <int D>
constexpr size_t smem_dkdv_tf32() {
  return sizeof(float) * (6 * kB * kTf32LDS<D> + 4 * kB) +
         sizeof(unsigned) * 4 * kB;
}

// the kernels past d 256 (the same at every d)
constexpr size_t smem_wide(int which) {
  return sizeof(float) * (which == 0 ? 3 * kB * kLC + kB * kLP
                          : which == 1 ? 4 * kB * kLC + kB * kLP + 2 * kB
                                       : 4 * kB * kLC + 2 * kB * kLP + 2 * kB);
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

struct Args {
  const void *q, *k, *v, *bias, *seed, *o, *dout, *lse;
  long long sb, sh, sr;
  Strides sq, sk, sv, so, sdo, sdq, sdk, sdv;
  void *out, *lse_out, *delta, *dq, *dk, *dv, *dbias;
  int dbias_heads, dbias_rows, B, H, S, d;
  float scale, p_drop, keep_scale;
  cudaStream_t stream;
};

template <typename T, int D>
int run_dq_mma(const Args& a) {
  auto kernel = attn_bwd_dq_mma<T, D>;
  if (int e = set_smem(kernel, smem_dq_mma<D>())) return e;
  const dim3 grid((a.S + kB - 1) / kB * kHalves<D>, a.H, a.B);
  kernel<<<grid, kMmaThreads, smem_dq_mma<D>(), a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v),
      BiasView{static_cast<const float*>(a.bias), a.sb, a.sh, a.sr},
      static_cast<const long long*>(a.seed), static_cast<const T*>(a.o),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<float*>(a.delta), static_cast<T*>(a.dq), a.sq, a.sk,
      a.sv, a.so, a.sdo, a.sdq, a.H, a.S, a.scale, a.p_drop, a.keep_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int run_dkdv_mma(const Args& a) {
  auto kernel = attn_bwd_dkdv_mma<T, D>;
  if (int e = set_smem(kernel, smem_dkdv_mma<D>())) return e;
  const dim3 grid((a.S + kB - 1) / kB * kHalves<D>, a.H, a.B);
  kernel<<<grid, kMmaThreads, smem_dkdv_mma<D>(), a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v),
      BiasView{static_cast<const float*>(a.bias), a.sb, a.sh, a.sr},
      static_cast<const long long*>(a.seed), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.dk), static_cast<T*>(a.dv),
      DBias{static_cast<float*>(a.dbias), a.dbias_heads, a.dbias_rows},
      a.sq, a.sk, a.sv, a.sdo, a.sdk, a.sdv, a.H, a.S, a.scale, a.p_drop,
      a.keep_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int run_fwd_mma(const Args& a) {
  auto kernel = attn_fwd_mma<T, D>;
  if (int e = set_smem(kernel, smem_fwd_mma<D>())) return e;
  const dim3 grid((a.S + kB - 1) / kB, a.H, a.B);
  kernel<<<grid, kMmaThreads, smem_fwd_mma<D>(), a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v),
      BiasView{static_cast<const float*>(a.bias), a.sb, a.sh, a.sr},
      static_cast<const long long*>(a.seed), static_cast<T*>(a.out),
      static_cast<float*>(a.lse_out), a.sq, a.sk, a.sv, a.so, a.H, a.S,
      a.scale, a.p_drop, a.keep_scale);
  return static_cast<int>(cudaGetLastError());
}

// the forward on the SIMT cores: fp32, and the 16-bit types at d 256
template <typename T, int D>
int run_fwd_simt(const Args& a) {
  auto kernel = attn_fwd<T, D>;
  if (int e = set_smem(kernel, smem_fwd<D>())) return e;
  const dim3 grid((a.S + kB - 1) / kB, a.H, a.B);
  kernel<<<grid, kThreads, smem_fwd<D>(), a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v),
      BiasView{static_cast<const float*>(a.bias), a.sb, a.sh, a.sr},
      static_cast<const long long*>(a.seed), static_cast<T*>(a.out),
      static_cast<float*>(a.lse_out), a.sq, a.sk, a.sv, a.so, a.H, a.S,
      a.scale, a.p_drop, a.keep_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int run_fwd_tf32(const Args& a) {
  auto kernel = attn_fwd_tf32x3<T, D>;
  if (int e = set_smem(kernel, smem_fwd_tf32<D>())) return e;
  const dim3 grid((a.S + kB - 1) / kB, a.H, a.B);
  kernel<<<grid, kMmaThreads, smem_fwd_tf32<D>(), a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v),
      BiasView{static_cast<const float*>(a.bias), a.sb, a.sh, a.sr},
      static_cast<const long long*>(a.seed), static_cast<T*>(a.out),
      static_cast<float*>(a.lse_out), a.sq, a.sk, a.sv, a.so, a.H, a.S,
      a.scale, a.p_drop, a.keep_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int run_dq_tf32(const Args& a) {
  auto kernel = attn_bwd_dq_tf32x3<T, D>;
  if (int e = set_smem(kernel, smem_dq_tf32<D>())) return e;
  const dim3 grid((a.S + kB - 1) / kB, a.H, a.B);
  kernel<<<grid, kMmaThreads, smem_dq_tf32<D>(), a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v),
      BiasView{static_cast<const float*>(a.bias), a.sb, a.sh, a.sr},
      static_cast<const long long*>(a.seed), static_cast<const T*>(a.o),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<float*>(a.delta), static_cast<T*>(a.dq), a.sq, a.sk,
      a.sv, a.so, a.sdo, a.sdq, a.H, a.S, a.scale, a.p_drop, a.keep_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int run_dkdv_tf32(const Args& a) {
  auto kernel = attn_bwd_dkdv_tf32x3<T, D>;
  if (int e = set_smem(kernel, smem_dkdv_tf32<D>())) return e;
  const dim3 grid((a.S + kB - 1) / kB, a.H, a.B);
  kernel<<<grid, kMmaThreads, smem_dkdv_tf32<D>(), a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v),
      BiasView{static_cast<const float*>(a.bias), a.sb, a.sh, a.sr},
      static_cast<const long long*>(a.seed), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.dk), static_cast<T*>(a.dv),
      DBias{static_cast<float*>(a.dbias), a.dbias_heads, a.dbias_rows},
      a.sq, a.sk, a.sv, a.sdo, a.sdk, a.sdv, a.H, a.S, a.scale, a.p_drop,
      a.keep_scale);
  return static_cast<int>(cudaGetLastError());
}

// past d 256: kernel ``which`` on d / kDC column chunks a tile
template <typename T>
int run_wide(int which, const Args& a) {
  const dim3 grid((a.S + kB - 1) / kB * (a.d / kDC), a.H, a.B);
  const size_t smem = smem_wide(which);
  const BiasView bv{static_cast<const float*>(a.bias), a.sb, a.sh, a.sr};
  const T *q = static_cast<const T*>(a.q), *k = static_cast<const T*>(a.k),
          *v = static_cast<const T*>(a.v);
  const long long* seed = static_cast<const long long*>(a.seed);
  if (which == 0) {
    auto kernel = attn_fwd_wide<T>;
    if (int e = set_smem(kernel, smem)) return e;
    kernel<<<grid, kThreads, smem, a.stream>>>(
        q, k, v, bv, seed, static_cast<T*>(a.out),
        static_cast<float*>(a.lse_out), a.sq, a.sk, a.sv, a.so, a.H, a.S,
        a.d, a.scale, a.p_drop, a.keep_scale);
  } else if (which == 1) {
    auto kernel = attn_bwd_dq_wide<T>;
    if (int e = set_smem(kernel, smem)) return e;
    kernel<<<grid, kThreads, smem, a.stream>>>(
        q, k, v, bv, seed, static_cast<const T*>(a.o),
        static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
        static_cast<float*>(a.delta), static_cast<T*>(a.dq), a.sq, a.sk,
        a.sv, a.so, a.sdo, a.sdq, a.H, a.S, a.d, a.scale, a.p_drop,
        a.keep_scale);
  } else {
    auto kernel = attn_bwd_dkdv_wide<T>;
    if (int e = set_smem(kernel, smem)) return e;
    kernel<<<grid, kThreads, smem, a.stream>>>(
        q, k, v, bv, seed, static_cast<const T*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<T*>(a.dk), static_cast<T*>(a.dv),
        DBias{static_cast<float*>(a.dbias), a.dbias_heads, a.dbias_rows},
        a.sq, a.sk, a.sv, a.sdo, a.sdk, a.sdv, a.H, a.S, a.d, a.scale,
        a.p_drop, a.keep_scale);
  }
  return static_cast<int>(cudaGetLastError());
}

// whether fp32 operands at head width D take the 3xTF32 forward, and the
// 3xTF32 backward
template <typename T, int D>
constexpr bool kOnTf32 = std::is_same<T, float>::value && D <= kTf32MaxD;
template <typename T, int D>
constexpr bool kOnTf32Bwd = kOnTf32<T, D> && D <= kTf32BwdMaxD;

// whether kernel ``which`` (0 forward, 1 dq, 2 dk/dv) runs on the tensor
// cores for operands of T at head width D
template <typename T, int D>
constexpr bool kOnTensorCores(int which) {
  return which == 0 ? kOnTf32<T, D> || (kHalf16<T> && D <= kMmaFwdMaxD)
                    : kOnTf32Bwd<T, D> || kHalf16<T>;
}

// the forward: fp32 up to d 128 as 3xTF32, bf16 and fp16 on the tensor
// cores up to d 128, else SIMT
template <typename T, int D>
int run_fwd(const Args& a) {
  if constexpr (kOnTf32<T, D>) {
    return run_fwd_tf32<T, D>(a);
  } else if constexpr (kOnTensorCores<T, D>(0)) {
    return run_fwd_mma<T, D>(a);
  } else {
    return run_fwd_simt<T, D>(a);
  }
}

template <int D>
int run_dq_simt(const Args& a) {
  using T = float;
  auto kernel = attn_bwd_dq<T, D>;
  if (int e = set_smem(kernel, smem_dq<D>())) return e;
  const dim3 grid((a.S + kBwdRows<D> - 1) / kBwdRows<D>, a.H, a.B);
  kernel<<<grid, kThreads, smem_dq<D>(), a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v),
      BiasView{static_cast<const float*>(a.bias), a.sb, a.sh, a.sr},
      static_cast<const long long*>(a.seed), static_cast<const T*>(a.o),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<float*>(a.delta), static_cast<T*>(a.dq), a.sq, a.sk, a.sv,
      a.so, a.sdo, a.sdq, a.H, a.S, a.scale, a.p_drop, a.keep_scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int run_dkdv_simt(const Args& a) {
  using T = float;
  auto kernel = attn_bwd_dkdv<T, D>;
  if (int e = set_smem(kernel, smem_dkdv<D>())) return e;
  const dim3 grid((a.S + kBwdRows<D> - 1) / kBwdRows<D>, a.H, a.B);
  kernel<<<grid, kThreads, smem_dkdv<D>(), a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v),
      BiasView{static_cast<const float*>(a.bias), a.sb, a.sh, a.sr},
      static_cast<const long long*>(a.seed), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.dk), static_cast<T*>(a.dv),
      DBias{static_cast<float*>(a.dbias), a.dbias_heads, a.dbias_rows},
      a.sq, a.sk, a.sv, a.sdo, a.sdk, a.sdv, a.H, a.S, a.scale, a.p_drop,
      a.keep_scale);
  return static_cast<int>(cudaGetLastError());
}

// the backward: bf16 and fp16 on the tensor cores, fp32 as 3xTF32 up to
// d 64 and on the SIMT kernels at d 128 and 256
template <typename T, int D>
int run_dq(const Args& a) {
  if constexpr (kHalf16<T>) {
    return run_dq_mma<T, D>(a);
  } else if constexpr (kOnTf32Bwd<T, D>) {
    return run_dq_tf32<T, D>(a);
  } else {
    return run_dq_simt<D>(a);
  }
}

template <typename T, int D>
int run_dkdv(const Args& a) {
  if constexpr (kHalf16<T>) {
    return run_dkdv_mma<T, D>(a);
  } else if constexpr (kOnTf32Bwd<T, D>) {
    return run_dkdv_tf32<T, D>(a);
  } else {
    return run_dkdv_simt<D>(a);
  }
}

// whether d is taken by the kernels past 256
inline bool wide(int d) { return d > 256 && d % kDC == 0; }

// which: 0 forward, 1 dq (+ delta), 2 dk/dv (+ dbias); head width d in
// {16, 32, 64, 128, 256} or a multiple of kDC past 256
template <typename T>
int dispatch(int which, const Args& a) {
  if (a.B < 1 || a.H < 1 || a.S < 1) return static_cast<int>(cudaErrorInvalidValue);
#define PT_RUN(D)                                   \
  return which == 0 ? run_fwd<T, D>(a)              \
       : which == 1 ? run_dq<T, D>(a) : run_dkdv<T, D>(a)
  switch (a.d) {
    case 16: PT_RUN(16);
    case 32: PT_RUN(32);
    case 64: PT_RUN(64);
    case 128: PT_RUN(128);
    case 256: PT_RUN(256);
    default:
      return wide(a.d) ? run_wide<T>(which, a)
                       : static_cast<int>(cudaErrorInvalidValue);
  }
#undef PT_RUN
}

// dynamic shared memory a block of kernel ``which`` takes at head width D
template <typename T, int D>
size_t smem_at(int which) {
  if (!kOnTensorCores<T, D>(which))
    return which == 0 ? smem_fwd<D>()
         : which == 1 ? smem_dq<D>() : smem_dkdv<D>();
  if (std::is_same<T, float>::value)
    return which == 0 ? smem_fwd_tf32<D>()
         : which == 1 ? smem_dq_tf32<D>() : smem_dkdv_tf32<D>();
  return which == 0 ? smem_fwd_mma<D>()
       : which == 1 ? smem_dq_mma<D>() : smem_dkdv_mma<D>();
}

template <typename T>
size_t smem_of(int which, int d) {
  switch (d) {
    case 16: return smem_at<T, 16>(which);
    case 32: return smem_at<T, 32>(which);
    case 64: return smem_at<T, 64>(which);
    case 128: return smem_at<T, 128>(which);
    case 256: return smem_at<T, 256>(which);
    default: return wide(d) ? smem_wide(which) : 0;
  }
}

// whether kernel ``which`` runs on the tensor cores for the type code
// ``type`` at head width d (false for a width not built, and past 256)
template <typename T>
bool tensor_cores_of(int which, int d) {
  switch (d) {
    case 16: return kOnTensorCores<T, 16>(which);
    case 32: return kOnTensorCores<T, 32>(which);
    case 64: return kOnTensorCores<T, 64>(which);
    case 128: return kOnTensorCores<T, 128>(which);
    case 256: return kOnTensorCores<T, 256>(which);
    default: return false;
  }
}

// type: 0 float32, 1 bfloat16, 2 float16
int run(int which, int type, const Args& a) {
  switch (type) {
    case 0: return dispatch<float>(which, a);
    case 1: return dispatch<bf16>(which, a);
    case 2: return dispatch<f16>(which, a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry points for ctypes. Each returns cudaGetLastError() after
// the launch (0 on success); the kernel runs on `stream` and does not
// synchronise. Pointers are device pointers: q, k, v, o, dout, dq, dk, dv
// [B, H, S, d] operands of one type (type 0 float32, 1 bfloat16, 2
// float16), element (b, h, row, c) of each at b*sb + h*sh + row*sr + c
// for its own (sb, sh, sr), read from the host array `strides`, three
// int64 per operand in the order of the entry's operands (forward: q, k,
// v, o; dq: q, k, v, o, dout, dq; dk/dv: q, k, v, dout, dk, dv); bias
// fp32 read as bias[b*sb + h*sh + row*sr + col] (nullptr: none); seed one
// int64 (read only when p_drop > 0); lse, delta [B, H, S] fp32 contiguous;
// dbias [B, dbias_heads, dbias_rows, S] fp32 contiguous, zeroed by the
// caller when dbias_heads == 1 < H (atomics), nullptr for none.
namespace {
void set_strides(const long long* st, std::initializer_list<Strides*> to) {
  for (Strides* s : to) {
    *s = Strides{st[0], st[1], st[2]};
    st += 3;
  }
}
}  // namespace

extern "C" {

int pt_fused_attention_fwd(int type, const void* q, const void* k,
                           const void* v, const void* bias, long long sb,
                           long long sh, long long sr, const void* seed,
                           void* out, void* lse, const long long* strides,
                           int B, int H, int S, int d, float scale,
                           float p_drop, float keep_scale, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.bias = bias; a.sb = sb; a.sh = sh; a.sr = sr;
  a.seed = seed; a.out = out; a.lse_out = lse;
  set_strides(strides, {&a.sq, &a.sk, &a.sv, &a.so});
  a.B = B; a.H = H; a.S = S; a.d = d;
  a.scale = scale; a.p_drop = p_drop; a.keep_scale = keep_scale;
  a.stream = static_cast<cudaStream_t>(stream);
  return run(0, type, a);
}

int pt_fused_attention_bwd_dq(int type, const void* q, const void* k,
                              const void* v, const void* bias, long long sb,
                              long long sh, long long sr, const void* seed,
                              const void* o, const void* dout,
                              const void* lse, void* delta, void* dq,
                              const long long* strides, int B, int H, int S,
                              int d, float scale, float p_drop,
                              float keep_scale, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.bias = bias; a.sb = sb; a.sh = sh; a.sr = sr;
  a.seed = seed; a.o = o; a.dout = dout; a.lse = lse; a.delta = delta;
  set_strides(strides, {&a.sq, &a.sk, &a.sv, &a.so, &a.sdo, &a.sdq});
  a.dq = dq; a.B = B; a.H = H; a.S = S; a.d = d;
  a.scale = scale; a.p_drop = p_drop; a.keep_scale = keep_scale;
  a.stream = static_cast<cudaStream_t>(stream);
  return run(1, type, a);
}

int pt_fused_attention_bwd_dkdv(int type, const void* q, const void* k,
                                const void* v, const void* bias, long long sb,
                                long long sh, long long sr, const void* seed,
                                const void* dout, const void* lse,
                                const void* delta, void* dk, void* dv,
                                void* dbias, int dbias_heads, int dbias_rows,
                                const long long* strides, int B, int H, int S,
                                int d, float scale, float p_drop,
                                float keep_scale, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.bias = bias; a.sb = sb; a.sh = sh; a.sr = sr;
  a.seed = seed; a.dout = dout; a.lse = lse;
  set_strides(strides, {&a.sq, &a.sk, &a.sv, &a.sdo, &a.sdk, &a.sdv});
  a.delta = const_cast<void*>(delta);  // read only by this kernel
  a.dk = dk; a.dv = dv; a.dbias = dbias;
  a.dbias_heads = dbias_heads; a.dbias_rows = dbias_rows;
  a.B = B; a.H = H; a.S = S; a.d = d;
  a.scale = scale; a.p_drop = p_drop; a.keep_scale = keep_scale;
  a.stream = static_cast<cudaStream_t>(stream);
  return run(2, type, a);
}

// bytes of dynamic shared memory a block of the forward (which 0), dq (1)
// or dk/dv (2) kernel takes at head width d for the type code ``type``
// (0 for a width not built)
long long pt_fused_attention_smem(int which, int type, int d) {
  return static_cast<long long>(type == 0 ? smem_of<float>(which, d)
                                          : smem_of<bf16>(which, d));
}

// 1 when the forward (which 0), dq (1) or dk/dv (2) kernel runs on the
// tensor cores (attn_*_tf32x3 in fp32, attn_*_mma in bf16 and fp16) for
// the type code ``type`` at head width d, else 0 (the SIMT kernels)
int pt_fused_attention_tensor_cores(int which, int type, int d) {
  return type == 0 ? tensor_cores_of<float>(which, d)
                   : tensor_cores_of<bf16>(which, d);
}

}  // extern "C"
