// Fused multi-head attention for training, forward and backward, for
// Hopper (sm_90a).
//
// Replaces the training-attention Pallas TPU kernels of
// paddle_tpu/kernels/attention.py, of all three of its tiers:
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
// Bound on the card: at S = 512, d = 64 a (b, h) pair does 4 * S^2 * d
// operations on 4 * S * d * sizeof(T) bytes, about 250 operations per
// fp32 byte, so the operations bound it (67 TFLOP/s fp32 without tensor
// cores, 989 TFLOP/s bf16 with them). At BERT's S = 128 in bf16 that is
// 128 operations per byte, below the H100's 295, so there the bytes of
// q, k, v and o bound it (the packed layout's case). This first version computes
// everything in fp32 on the SIMT cores, also for bf16 inputs: tiles are
// converted to fp32 as they land in shared memory. Each thread holds a
// 4 x 4 micro-tile of the 64 x 64 score tile (query rows 4ty..4ty+3, key
// columns tx + 16j) and a 4 x d/16 slice of its accumulators. Shared
// tiles keep an odd row stride (d + 1, 65), so every read of a row or of
// a column across the lanes of a warp is free of bank conflicts. What it
// does not do yet: tensor cores (wgmma), TMA or a cp.async pipeline, so
// the bf16 path runs at the fp32 rate and loads are not overlapped with
// math beyond what two resident blocks per SM give.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>
#include <initializer_list>

namespace {

constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kB = 64;         // rows of a q-tile and of a k-tile
constexpr int kLP = kB + 1;    // row stride of a score tile in shared memory

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float v, float* p) { *p = v; }
__device__ __forceinline__ void store(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16(v);
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

// keep flags of a thread's four rows (4 * row4 + i) at key column col
__device__ __forceinline__ void keep4(uint2 key, int col, int row4, int bh,
                                      float p_drop, bool keep[4]) {
  const uint4 r = philox(make_uint4(col, row4, bh, 0), key);
  const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    keep[i] = static_cast<float>(w[i] >> 8) * (1.0f / 16777216.0f) >= p_drop;
}

// Rows [0, n) of a global tile of D-element rows, ``rs`` elements apart
// -> fp32 shared [kB][D + 1]; rows n..kB-1 are zero. A thread keeps one
// column and walks its rows with one pointer, so the runtime row stride
// costs one 64-bit add a row, not an address register per load.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* s, const T* g, long long rs,
                                          int n) {
  constexpr int kStep = kThreads / D;  // rows one pass of the block covers
  const long long stride = rs;         // elements from one row to the next
  const int c = threadIdx.x % D;
  const T* p = g + (threadIdx.x / D) * stride + c;
#pragma unroll 4
  for (int r = threadIdx.x / D; r < kB; r += kStep, p += kStep * stride)
    s[r * (D + 1) + c] = r < n ? to_f32(*p) : 0.f;
}

// Resident blocks per SM each kernel is compiled for (its register cap,
// 65536 / (256 * blocks)): what its shared memory allows at d <= 64, as
// the contiguous-only kernels reached with 80 and 126 registers; one at
// d = 128, whose tiles fill the shared memory.
template <int D> constexpr int kFwdBlocks = D <= 64 ? 3 : 1;
template <int D> constexpr int kBwdBlocks = D <= 64 ? 2 : 1;

// s[i][j] = sum_k A[4ty + i][k] * Bt[tx + 16j][k] over two [kB][D + 1] tiles
template <int D>
__device__ __forceinline__ void tile_dot(const float* A, const float* Bt,
                                         int ty, int tx, float s[4][4]) {
  constexpr int LD = D + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int kk = 0; kk < D; ++kk) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(4 * ty + i) * LD + kk];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = Bt[(tx + 16 * j) * LD + kk];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
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
      if (drop) keep4(key, k0 + tx + 16 * j, (q0 >> 2) + ty, bh, p_drop, keep);
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

// Per q-tile: delta = rowsum(dO * O) (also written out), then dq over all
// k-tiles.
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
  constexpr int LD = D + 1, E = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + kB * LD;
  float* Ks = dOs + kB * LD;
  float* Vs = Ks + kB * LD;
  float* dSs = Vs + kB * LD;     // [kB][kLP]
  float* Lr = dSs + kB * kLP;    // [kB] lse of the tile's rows
  float* Dr = Lr + kB;           // [kB] delta of the tile's rows

  const int q0 = blockIdx.x * kB, h = blockIdx.y, b = blockIdx.z;
  const int bh = b * H + h, tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const T* kh = head_of(k, sk, b, h);
  const T* vh = head_of(v, sv, b, h);
  const int nq = min(kB, S - q0);
  load_tile<T, D>(Qs, head_of(q, sq, b, h) + q0 * sq.r, sq.r, nq);
  load_tile<T, D>(dOs, head_of(dout, sdo, b, h) + q0 * sdo.r, sdo.r, nq);
  __syncthreads();
  {  // four threads per row, lanes 4r..4r+3 of one warp
    const int r = tid >> 2, part = tid & 3;
    float acc = 0.f;
    if (r < nq) {
      const T* orow = head_of(o, so, b, h) + (q0 + r) * so.r;
      for (int e = part; e < D; e += 4)
        acc = fmaf(dOs[r * LD + e], to_f32(orow[e]), acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (part == 0) {
      Dr[r] = acc;
      Lr[r] = r < nq ? lse[static_cast<size_t>(bh) * S + q0 + r] : 0.f;
      if (r < nq) delta[static_cast<size_t>(bh) * S + q0 + r] = acc;
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
    __syncthreads();
    load_tile<T, D>(Ks, kh + k0 * sk.r, sk.r, nk);
    load_tile<T, D>(Vs, vh + k0 * sv.r, sv.r, nk);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dot<D>(Qs, Ks, ty, tx, s);
    tile_dot<D>(dOs, Vs, ty, tx, dp);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = k0 + tx + 16 * j;
      bool keep[4] = {true, true, true, true};
      if (drop) keep4(key, col, (q0 >> 2) + ty, bh, p_drop, keep);
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
    __syncthreads();
    for (int c = 0; c < nk; ++c) {
      float kv[E];
#pragma unroll
      for (int e = 0; e < E; ++e) kv[e] = Ks[c * LD + tx + 16 * e];
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

// Per k-tile: dk, dv (and dbias) over all q-tiles.
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
  constexpr int LD = D + 1, E = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kB * LD;
  float* Qs = Vs + kB * LD;
  float* dOs = Qs + kB * LD;
  float* Ps = dOs + kB * LD;     // [kB][kLP] dropped weights
  float* dSs = Ps + kB * kLP;    // [kB][kLP]
  float* Lr = dSs + kB * kLP;
  float* Dr = Lr + kB;

  const int k0 = blockIdx.x * kB, h = blockIdx.y, b = blockIdx.z;
  const int bh = b * H + h, tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const T* qh = head_of(q, sq, b, h);
  const T* doh = head_of(dout, sdo, b, h);
  const int nk = min(kB, S - k0);
  load_tile<T, D>(Ks, head_of(k, sk, b, h) + k0 * sk.r, sk.r, nk);
  load_tile<T, D>(Vs, head_of(v, sv, b, h) + k0 * sv.r, sv.r, nk);
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
    __syncthreads();
    load_tile<T, D>(Qs, qh + q0 * sq.r, sq.r, nq);
    load_tile<T, D>(dOs, doh + q0 * sdo.r, sdo.r, nq);
    if (tid < kB) {
      const bool live = tid < nq;
      Lr[tid] = live ? lse[static_cast<size_t>(bh) * S + q0 + tid] : 0.f;
      Dr[tid] = live ? delta[static_cast<size_t>(bh) * S + q0 + tid] : 0.f;
    }
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dot<D>(Qs, Ks, ty, tx, s);
    tile_dot<D>(dOs, Vs, ty, tx, dp);
    const float* brow[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      brow[i] = bias_row(bv, b, h, min(q0 + 4 * ty + i, S - 1));
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = k0 + tx + 16 * j;
      bool keep[4] = {true, true, true, true};
      if (drop) keep4(key, col, (q0 >> 2) + ty, bh, p_drop, keep);
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
    __syncthreads();
    for (int r = 0; r < nq; ++r) {
      float dov[E], qv[E];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        dov[e] = dOs[r * LD + tx + 16 * e];
        qv[e] = Qs[r * LD + tx + 16 * e];
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
    T* dkrow = head_of(dk, sdk, b, h) + row * sdk.r;
    T* dvrow = head_of(dv, sdv, b, h) + row * sdv.r;
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

template <int D>
constexpr size_t smem_fwd() { return sizeof(float) * (3 * kB * (D + 1) + kB * kLP); }
template <int D>
constexpr size_t smem_dq() {
  return sizeof(float) * (4 * kB * (D + 1) + kB * kLP + 2 * kB);
}
template <int D>
constexpr size_t smem_dkdv() {
  return sizeof(float) * (4 * kB * (D + 1) + 2 * kB * kLP + 2 * kB);
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
int run_fwd(const Args& a) {
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
int run_dq(const Args& a) {
  auto kernel = attn_bwd_dq<T, D>;
  if (int e = set_smem(kernel, smem_dq<D>())) return e;
  const dim3 grid((a.S + kB - 1) / kB, a.H, a.B);
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

template <typename T, int D>
int run_dkdv(const Args& a) {
  auto kernel = attn_bwd_dkdv<T, D>;
  if (int e = set_smem(kernel, smem_dkdv<D>())) return e;
  const dim3 grid((a.S + kB - 1) / kB, a.H, a.B);
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

// which: 0 forward, 1 dq (+ delta), 2 dk/dv (+ dbias); head width d in
// {16, 32, 64, 128}
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
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PT_RUN
}

int run(int which, int bf16, const Args& a) {
  return bf16 ? dispatch<__nv_bfloat16>(which, a) : dispatch<float>(which, a);
}

}  // namespace

// Plain C entry points for ctypes. Each returns cudaGetLastError() after
// the launch (0 on success); the kernel runs on `stream` and does not
// synchronise. Pointers are device pointers: q, k, v, o, dout, dq, dk, dv
// [B, H, S, d] operands of one type (bf16 = 1 for bfloat16, else
// float32), element (b, h, row, c) of each at b*sb + h*sh + row*sr + c
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

int pt_fused_attention_fwd(int bf16, const void* q, const void* k,
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
  return run(0, bf16, a);
}

int pt_fused_attention_bwd_dq(int bf16, const void* q, const void* k,
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
  return run(1, bf16, a);
}

int pt_fused_attention_bwd_dkdv(int bf16, const void* q, const void* k,
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
  return run(2, bf16, a);
}

}  // extern "C"
