// Decode-step attention over a KV cache, for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of paddle_tpu/kernels/attention.py:
//   * _decode_fwd_kernel        (dense ring cache [B, H, C, d])
//   * _paged_decode_fwd_kernel  (shared pool [P, H, ptok, d] + page table)
// Both compute, for every (b, h, q-row r),
//   o = softmax(mask(q . K^T * scale)) . V
// where column c is live iff c < limit, limit = min(cache_len[b], C)
// (minus Q-1-r under causal_window). Dead columns score -1e30, not -inf,
// so a row whose window is empty averages V uniformly over the whole
// capacity, as the plain version does, instead of producing NaN.
//
// Bound on the card: bytes. One decode step reads each live key and value
// row once (2 * live_cols * d * sizeof(T) per (b, h)) and does 4 * d flops
// per key, far below the H100's flops-per-byte balance point, so the least
// time is those bytes over the HBM rate (3.35 TB/s on the H100 SXM). The
// design therefore reads only live columns (the loop stops at the window
// limit; a partially live tail tile is cut short, not padded), keeps many
// bytes in flight, and materialises nothing in device memory:
//   * tiles of kTile key columns are copied global -> shared with 16-byte
//     cp.async into a ring of kStages buffers, so the copies of the next
//     kStages - 1 tiles are in flight while the block does the math of the
//     current one (K and V of a tile travel together);
//   * the math reads rows with 16-byte shared loads: a group of L lanes
//     covers one row of Dp elements, d rounded up to a multiple of 16
//     bytes, each lane holding NP 16-byte slices of q in registers
//     (slices piece, piece + L, ...); up to 512 bytes NP is 1 and L the
//     row's 16-byte pieces rounded up to a power of two (1 to 32), past
//     that L is 32 and NP 2 or 4 (rows up to 2048 bytes: fp32 d 512,
//     16-bit d 1024), with tiles of 64 / NP keys so that a stage stays
//     within 32 KB; both are template parameters, and the lanes past the
//     row (at 48, 96, 192 ... bytes) stay idle in loads and add zeros to
//     the shuffles; a group's partial dot products meet by shuffles,
//     those of a thread's rows interleaved;
//   * a row that is not a multiple of 16 bytes (fp32 d 6, bf16 d 12), or
//     a cache that does not start on a 16-byte boundary, cannot travel by
//     16-byte cp.async: its tiles are copied element by element with
//     ordinary loads into the same padded shared rows, zeros up to Dp
//     (zero key columns add nothing to q.k^T); the decode sessions pad
//     their caches' rows to 16 bytes, so this narrow copy serves only a
//     cache a caller passes in unpadded;
//   * the running max is block-wide, so every group rescales its share of
//     the sum and of the accumulator by the same factor, and the groups'
//     shares are added once at the end.
// Rows past 2048 bytes (fp32 d > 512, 16-bit d > 1024) take
// decode_attention_wide: their output's columns are split across blocks,
// one 2048-byte chunk each (32 lanes of four 16-byte pieces), and each
// block computes every key's full-row score by looping over the row's
// chunks (one chunk of a tile's K rows in shared memory at a time), then
// accumulates its own chunk of the V rows. Its copies wait for the block
// before its math (no ring): no preset has such rows, so it is right
// first; the bound is the same bytes, read once by each chunk's block
// for K.
// What it does not do: split a long row over several blocks. With one
// block per (b, h, q-row), a batch of 8 streams of 16 heads gives only 128
// blocks for 132 SMs, and the longest row's tiles run one after the other
// on one SM.
//
// The dense and paged kernels are one template over a key/value source.
// Hopper has no scalar prefetch: the paged source copies its slot's row
// of the page table into shared memory once, and each tile copy reads its
// page indices there. The paged kernel on a pool and the dense kernel on
// the gathered cache see identical tiles and agree bit for bit.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;     // key columns per tile of rows up to 512 bytes
constexpr int kStages = 3;    // shared-memory tile buffers in the ring
constexpr float kMasked = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ void store_f32(float v, float* p) { *p = v; }
__device__ __forceinline__ void store_f32(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ void store_f32(float v, __half* p) {
  *p = __float2half(v);
}

// 16 bytes of shared memory -> kVec fp32 values.
__device__ __forceinline__ void load16(const float* p, float* x) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* x) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load16(const __half* p, float* x) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most N of this thread's committed copy groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Dense ring cache [B, H, C, d]: logical column == ring slot.
struct DenseKV {
  int H, C, d;
  static constexpr bool kHasTable = false;
  __device__ __forceinline__ DenseKV bind(int, int*) const { return *this; }
  __device__ __forceinline__ size_t offset(int b, int h, int col) const {
    return ((static_cast<size_t>(b) * H + h) * C + col) * d;
  }
};

// Paged pool [P, H, ptok, d]: logical column c of slot b lives in pool
// row table[b, c / ptok] at offset c % ptok. bind() copies slot b's row
// of the table into shared memory, so a tile copy reads its page index
// there instead of waiting on a global load before each 16-byte copy.
struct PagedKV {
  const int* table;  // [B, npages]; once bound, slot b's row [npages]
  int H, ptok, npages, d;
  static constexpr bool kHasTable = true;
  __device__ __forceinline__ PagedKV bind(int b, int* s_table) const {
    for (int i = threadIdx.x; i < npages; i += kThreads)
      s_table[i] = table[static_cast<size_t>(b) * npages + i];
    PagedKV bound = *this;
    bound.table = s_table;
    return bound;
  }
  __device__ __forceinline__ size_t offset(int, int h, int col) const {
    const int page = table[col / ptok];
    return ((static_cast<size_t>(page) * H + h) * ptok + col % ptok) * d;
  }
};

// Start the copies of `n` key and value rows of D elements from logical
// column `col0` into the stage buffers sk / sv ([rows][Dp] each, Dp = D
// rounded up to 16 bytes): 16-byte cp.async pieces, one per thread per
// step, or with ``narrow`` element by element through registers, with
// zeros from D to Dp.
template <typename T, typename KV>
__device__ __forceinline__ void issue_tile(const KV& kv, const T* k,
                                           const T* v, int b, int h,
                                           int col0, int n, int D, int Dp,
                                           bool narrow, T* sk, T* sv) {
  constexpr int kVec = 16 / sizeof(T);
  if (!narrow) {
    const int pieces = D / kVec;
    for (int c = threadIdx.x; c < n * pieces; c += kThreads) {
      const int row = c / pieces, off = (c % pieces) * kVec;
      const size_t src = kv.offset(b, h, col0 + row) + off;
      cp_async16(sk + row * D + off, k + src);
      cp_async16(sv + row * D + off, v + src);
    }
    return;
  }
  for (int c = threadIdx.x; c < n * Dp; c += kThreads) {
    const int row = c / Dp, e = c % Dp;
    if (e < D) {
      const size_t src = kv.offset(b, h, col0 + row) + e;
      sk[c] = k[src];
      sv[c] = v[src];
    } else {
      store_f32(0.f, sk + c);
      store_f32(0.f, sv + c);
    }
  }
}

// L lanes cover one key row of Dp elements, NP 16-byte pieces a lane
// (Dp * sizeof(T) / 16 <= L * NP pieces; lanes past them idle); a tile
// holds TR = kTile / NP rows; the block holds G = kThreads / L row
// groups, each taking R rows of a tile (rows g, g + G, ...; at L = 1 the
// groups past the tile's 64 rows take none), so the R dot products of a
// thread are independent and their shuffles interleave.
template <typename T, int L, int NP, typename KV>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const T* __restrict__ q, const T* k, const T* v,
                            T* __restrict__ out, const int* __restrict__ lens,
                            KV kv, int H, int Q, int D, int Dp, int narrow,
                            int capacity, float scale, int causal_window) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int TR = kTile / NP;
  constexpr int G = kThreads / L, R = (TR + G - 1) / G;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_tiles = reinterpret_cast<T*>(smem_raw);  // [kStages][2][TR][Dp]
  float* s_acc = reinterpret_cast<float*>(s_tiles + kStages * 2 * TR * Dp);
  float* s_l = s_acc + G * Dp;                  // s_acc [G][Dp], s_l [G]
  float* s_red = s_l + G;                       // [kWarps]
  int* s_table = reinterpret_cast<int*>(s_red + kWarps);  // paged: [npages]

  const int r = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31;
  const int g = tid / L, piece = tid % L;  // row group, first 16-byte slice
  const int pieces = Dp / kVec;
  bool live[NP];                           // lanes past the row idle
#pragma unroll
  for (int j = 0; j < NP; ++j) live[j] = piece + j * L < pieces;
  const size_t qoff = ((static_cast<size_t>(b) * H + h) * Q + r) * D;

  const int valid = min(lens[b], capacity);
  const int limit = causal_window ? valid - (Q - 1 - r) : valid;
  // every column < limit is live; an empty window walks the whole
  // capacity with every score masked, which makes the softmax uniform
  const int n_cols = limit > 0 ? limit : capacity;
  const int n_tiles = (n_cols + TR - 1) / TR;

  const KV src = kv.bind(b, s_table);
  if (KV::kHasTable) __syncthreads();
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) {
      T* sk = s_tiles + s * 2 * TR * Dp;
      issue_tile<T>(src, k, v, b, h, s * TR, min(TR, n_cols - s * TR), D,
                    Dp, narrow, sk, sk + TR * Dp);
    }
    cp_async_commit();  // empty groups keep the count per tile uniform
  }

  float qv[NP][kVec], acc[NP][kVec];
#pragma unroll
  for (int j = 0; j < NP; ++j)
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      const int at = (piece + j * L) * kVec + e;
      qv[j][e] = live[j] && at < D ? to_f32(q[qoff + at]) : 0.f;
      acc[j][e] = 0.f;
    }
  float m = kMasked, l = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    // tile i has landed for every thread, and every thread is done with
    // tile i - 1, whose buffer the copy below reuses
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nxt = i + kStages - 1;
    if (nxt < n_tiles) {
      T* sk = s_tiles + (nxt % kStages) * 2 * TR * Dp;
      issue_tile<T>(src, k, v, b, h, nxt * TR, min(TR, n_cols - nxt * TR),
                    D, Dp, narrow, sk, sk + TR * Dp);
    }
    cp_async_commit();

    const int col0 = i * TR, n = min(TR, n_cols - col0);
    const T* sk = s_tiles + (i % kStages) * 2 * TR * Dp;
    const T* sv = sk + TR * Dp;
    float sc[R];
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
      const int j = g + rr * G;
      float dot = 0.f;
      if (j < n) {
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          if (!live[p]) continue;
          float kx[kVec];
          load16(sk + j * Dp + (piece + p * L) * kVec, kx);
#pragma unroll
          for (int e = 0; e < kVec; ++e) dot = fmaf(qv[p][e], kx[e], dot);
        }
      }
      sc[rr] = dot;
    }
#pragma unroll
    for (int o = L >> 1; o > 0; o >>= 1) {
#pragma unroll
      for (int rr = 0; rr < R; ++rr)
        sc[rr] += __shfl_xor_sync(0xffffffffu, sc[rr], o);
    }
    float mx = -INFINITY;  // rows past the tile take no part at all
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
      const int j = g + rr * G;
      if (j < n) {
        sc[rr] = col0 + j < limit ? sc[rr] * scale : kMasked;
        mx = fmaxf(mx, sc[rr]);
      }
    }
    mx = warp_max(mx);
    if (lane == 0) s_red[tid >> 5] = mx;
    __syncthreads();
    float m_new = m;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m_new = fmaxf(m_new, s_red[w]);
    const float corr = expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[p][e] *= corr;
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
      const int j = g + rr * G;
      if (j < n) {
        const float pr = expf(sc[rr] - m_new);
        l += pr;
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          if (!live[p]) continue;
          float vx[kVec];
          load16(sv + j * Dp + (piece + p * L) * kVec, vx);
#pragma unroll
          for (int e = 0; e < kVec; ++e)
            acc[p][e] = fmaf(pr, vx[e], acc[p][e]);
        }
      }
    }
    m = m_new;
  }

#pragma unroll
  for (int p = 0; p < NP; ++p) {
    if (!live[p]) continue;
#pragma unroll
    for (int e = 0; e < kVec; ++e)
      s_acc[g * Dp + (piece + p * L) * kVec + e] = acc[p][e];
  }
  if (piece == 0) s_l[g] = l;
  __syncthreads();
  for (int t = tid; t < D; t += kThreads) {
    float o = 0.f, sum = 0.f;
    for (int gg = 0; gg < G; ++gg) {
      o += s_acc[gg * Dp + t];
      sum += s_l[gg];
    }
    store_f32(o / sum, out + qoff + t);
  }
}

// Rows past 2048 bytes: a block per (q-row and 2048-byte chunk of the
// output's columns, head, batch); decode_attention_kernel's math with
// L = 32 lanes of NP = 4 pieces on each chunk of a row in turn.
constexpr int kChunkBytes = 2048;  // the widest row of one lane group
constexpr int kWideKeys = 16;      // keys of a tile of a wide row

// Start the copies of elements [c0, c0 + w) of `n` rows of x from logical
// column `col0` into s [n][kChunkBytes / sizeof(T)]: 16-byte cp.async
// pieces, or with ``narrow`` element by element, with zeros from w to
// wp (w rounded up to 16 bytes).
template <typename T, typename KV>
__device__ __forceinline__ void issue_chunk(const KV& kv, const T* x, int b,
                                            int h, int col0, int n, int c0,
                                            int w, int wp, bool narrow,
                                            T* s) {
  constexpr int kVec = 16 / sizeof(T), CW = kChunkBytes / sizeof(T);
  if (!narrow) {
    const int pieces = w / kVec;
    for (int i = threadIdx.x; i < n * pieces; i += kThreads) {
      const int row = i / pieces, off = (i % pieces) * kVec;
      cp_async16(s + row * CW + off,
                 x + kv.offset(b, h, col0 + row) + c0 + off);
    }
    return;
  }
  for (int i = threadIdx.x; i < n * wp; i += kThreads) {
    const int row = i / wp, e = i % wp;
    if (e < w)
      s[row * CW + e] = x[kv.offset(b, h, col0 + row) + c0 + e];
    else
      store_f32(0.f, s + row * CW + e);
  }
}

template <typename T, typename KV>
__global__ void __launch_bounds__(kThreads)
    decode_attention_wide(const T* __restrict__ q, const T* k, const T* v,
                          T* __restrict__ out, const int* __restrict__ lens,
                          KV kv, int H, int Q, int D, int chunks, int narrow,
                          int capacity, float scale, int causal_window) {
  constexpr int kVec = 16 / sizeof(T), CW = kChunkBytes / sizeof(T);
  constexpr int L = 32, NP = 4, G = kThreads / L, TR = kWideKeys;
  constexpr int R = TR / G;  // rows of a tile a warp takes
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_k = reinterpret_cast<T*>(smem_raw);  // [TR][CW] a chunk of K rows
  T* s_v = s_k + TR * CW;                   // [TR][CW] the block's V chunk
  float* s_acc = reinterpret_cast<float*>(s_v + TR * CW);  // [G][CW]
  float* s_l = s_acc + G * CW;              // [G]
  float* s_red = s_l + G;                   // [kWarps]
  int* s_table = reinterpret_cast<int*>(s_red + kWarps);  // paged: [npages]

  const int r = blockIdx.x / chunks, c_out = blockIdx.x % chunks * CW;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, g = tid / L;
  const size_t qoff = ((static_cast<size_t>(b) * H + h) * Q + r) * D;
  const int w_out = min(CW, D - c_out);
  const int wp_out = (w_out + kVec - 1) / kVec * kVec;

  const int valid = min(lens[b], capacity);
  const int limit = causal_window ? valid - (Q - 1 - r) : valid;
  const int n_cols = limit > 0 ? limit : capacity;
  const int n_tiles = (n_cols + TR - 1) / TR;

  const KV src = kv.bind(b, s_table);
  if (KV::kHasTable) __syncthreads();
  float acc[NP][kVec];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[p][e] = 0.f;
  float m = kMasked, l = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    const int col0 = i * TR, n = min(TR, n_cols - col0);
    float sc[R];
#pragma unroll
    for (int rr = 0; rr < R; ++rr) sc[rr] = 0.f;
    for (int c0 = 0; c0 < D; c0 += CW) {
      const int w = min(CW, D - c0), wp = (w + kVec - 1) / kVec * kVec;
      __syncthreads();  // the previous chunk's (or tile's) rows are consumed
      issue_chunk<T>(src, k, b, h, col0, n, c0, w, wp, narrow, s_k);
      if (c0 == 0)
        issue_chunk<T>(src, v, b, h, col0, n, c_out, w_out, wp_out, narrow,
                       s_v);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const int at = (lane + p * L) * kVec;  // the lane's piece of the chunk
        if (at >= wp) continue;
        float qx[kVec];
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          qx[e] = c0 + at + e < D ? to_f32(q[qoff + c0 + at + e]) : 0.f;
#pragma unroll
        for (int rr = 0; rr < R; ++rr) {
          const int j = g + rr * G;
          if (j >= n) continue;
          float kx[kVec];
          load16(s_k + j * CW + at, kx);
#pragma unroll
          for (int e = 0; e < kVec; ++e) sc[rr] = fmaf(qx[e], kx[e], sc[rr]);
        }
      }
    }
#pragma unroll
    for (int o = L >> 1; o > 0; o >>= 1) {
#pragma unroll
      for (int rr = 0; rr < R; ++rr)
        sc[rr] += __shfl_xor_sync(0xffffffffu, sc[rr], o);
    }
    float mx = -INFINITY;  // rows past the tile take no part at all
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
      const int j = g + rr * G;
      if (j < n) {
        sc[rr] = col0 + j < limit ? sc[rr] * scale : kMasked;
        mx = fmaxf(mx, sc[rr]);
      }
    }
    mx = warp_max(mx);
    if (lane == 0) s_red[tid >> 5] = mx;
    __syncthreads();
    float m_new = m;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m_new = fmaxf(m_new, s_red[w]);
    const float corr = expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[p][e] *= corr;
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
      const int j = g + rr * G;
      if (j < n) {
        const float pr = expf(sc[rr] - m_new);
        l += pr;
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          const int at = (lane + p * L) * kVec;
          if (at >= wp_out) continue;
          float vx[kVec];
          load16(s_v + j * CW + at, vx);
#pragma unroll
          for (int e = 0; e < kVec; ++e)
            acc[p][e] = fmaf(pr, vx[e], acc[p][e]);
        }
      }
    }
    m = m_new;
  }

#pragma unroll
  for (int p = 0; p < NP; ++p) {
    const int at = (lane + p * L) * kVec;
    if (at >= wp_out) continue;
#pragma unroll
    for (int e = 0; e < kVec; ++e) s_acc[g * CW + at + e] = acc[p][e];
  }
  if (lane == 0) s_l[g] = l;
  __syncthreads();
  for (int t = tid; t < w_out; t += kThreads) {
    float o = 0.f, sum = 0.f;
    for (int gg = 0; gg < G; ++gg) {
      o += s_acc[gg * CW + t];
      sum += s_l[gg];
    }
    store_f32(o / sum, out + qoff + c_out + t);
  }
}

template <typename T, typename KV>
int launch_wide(const T* q, const T* k, const T* v, T* out, const int* lens,
                KV kv, int table_ints, int B, int H, int Q, int D,
                int narrow, int capacity, float scale, int causal_window,
                cudaStream_t stream) {
  constexpr int CW = kChunkBytes / sizeof(T), G = kThreads / 32;
  const int chunks = (D + CW - 1) / CW;
  const size_t smem = sizeof(T) * 2 * kWideKeys * CW +
                      sizeof(float) * (G * CW + G + kWarps) +
                      sizeof(int) * table_ints;
  auto kernel = decode_attention_wide<T, KV>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(Q * chunks, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(q, k, v, out, lens, kv, H, Q, D,
                                           chunks, narrow, capacity, scale,
                                           causal_window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int L, int NP, typename KV>
int launch_rows(const T* q, const T* k, const T* v, T* out, const int* lens,
                KV kv, int table_ints, int B, int H, int Q, int D, int Dp,
                int narrow, int capacity, float scale, int causal_window,
                cudaStream_t stream) {
  constexpr int G = kThreads / L, TR = kTile / NP;
  const size_t smem = sizeof(T) * kStages * 2 * TR * Dp +
                      sizeof(float) * (G * Dp + G + kWarps) +
                      sizeof(int) * table_ints;
  auto kernel = decode_attention_kernel<T, L, NP, KV>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(Q, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(q, k, v, out, lens, kv, H, Q, D,
                                           Dp, narrow, capacity, scale,
                                           causal_window);
  return static_cast<int>(cudaGetLastError());
}

// Rows of any d: Dp is d rounded up to 16 bytes; the lanes a row takes
// are its 16-byte pieces rounded up to a power of two, at most 32, with 2
// or 4 pieces a lane past 512 bytes, and past 2048 bytes the wide kernel.
// The copies are narrow (element by element) when a row is not a
// multiple of 16 bytes or a cache does not start on a 16-byte boundary.
template <typename T, typename KV>
int launch(const T* q, const T* k, const T* v, T* out, const int* lens,
           KV kv, int table_ints, int B, int H, int Q, int d, int capacity,
           float scale, int causal_window, cudaStream_t stream) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  const int pieces = (d + kVec - 1) / kVec, Dp = pieces * kVec;
  if (B < 1 || H < 1 || Q < 1 || capacity < 1 || d < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int narrow = d % kVec != 0 ||
                     reinterpret_cast<uintptr_t>(k) % 16 != 0 ||
                     reinterpret_cast<uintptr_t>(v) % 16 != 0;
  if (pieces > 4 * 32)
    return launch_wide<T, KV>(q, k, v, out, lens, kv, table_ints, B, H, Q, d,
                              narrow, capacity, scale, causal_window, stream);
  int lanes = 1;
  while (lanes < pieces && lanes < 32) lanes *= 2;
#define PT_ROWS(L, NP)                                                     \
  launch_rows<T, L, NP, KV>(q, k, v, out, lens, kv, table_ints, B, H, Q,   \
                            d, Dp, narrow, capacity, scale, causal_window, \
                            stream)
  if (pieces > 2 * 32) return PT_ROWS(32, 4);
  if (pieces > 32) return PT_ROWS(32, 2);
  switch (lanes) {
    case 1: return PT_ROWS(1, 1);
    case 2: return PT_ROWS(2, 1);
    case 4: return PT_ROWS(4, 1);
    case 8: return PT_ROWS(8, 1);
    case 16: return PT_ROWS(16, 1);
    default: return PT_ROWS(32, 1);
  }
#undef PT_ROWS
}

template <typename T>
int dense(const void* q, const void* k, const void* v, const void* lens,
          void* out, int B, int H, int Q, int d, int C, float scale,
          int causal_window, void* stream) {
  return launch<T>(static_cast<const T*>(q), static_cast<const T*>(k),
                   static_cast<const T*>(v), static_cast<T*>(out),
                   static_cast<const int*>(lens), DenseKV{H, C, d}, 0, B, H,
                   Q, d, C, scale, causal_window,
                   static_cast<cudaStream_t>(stream));
}

template <typename T>
int paged(const void* q, const void* k_pool, const void* v_pool,
          const void* table, const void* lens, void* out, int B, int H,
          int Q, int d, int ptok, int npages, float scale, void* stream) {
  PagedKV kv{static_cast<const int*>(table), H, ptok, npages, d};
  return launch<T>(static_cast<const T*>(q), static_cast<const T*>(k_pool),
                   static_cast<const T*>(v_pool), static_cast<T*>(out),
                   static_cast<const int*>(lens), kv, npages, B, H, Q, d,
                   ptok * npages, scale, 0,
                   static_cast<cudaStream_t>(stream));
}

}  // namespace

// Plain C entry points for ctypes. Each returns cudaGetLastError() after
// the launch (0 on success); the kernel runs on `stream` and does not
// synchronise. All pointers are device pointers to contiguous tensors:
// q/out [B, H, Q, d], k/v [B, H, C, d] or pools [P, H, ptok, d] (any d;
// 16-byte rows on 16-byte boundaries take the asynchronous copies), lens
// [B] int32, table [B, npages] int32; one
// entry per type (f32, bf16, f16) and source.
extern "C" {

int pt_decode_attention_f32(const void* q, const void* k, const void* v,
                            const void* lens, void* out, int B, int H, int Q,
                            int d, int C, int causal_window, float scale,
                            void* stream) {
  return dense<float>(q, k, v, lens, out, B, H, Q, d, C, scale,
                      causal_window, stream);
}

int pt_decode_attention_bf16(const void* q, const void* k, const void* v,
                             const void* lens, void* out, int B, int H,
                             int Q, int d, int C, int causal_window,
                             float scale, void* stream) {
  return dense<__nv_bfloat16>(q, k, v, lens, out, B, H, Q, d, C, scale,
                              causal_window, stream);
}

int pt_paged_attention_f32(const void* q, const void* k_pool,
                           const void* v_pool, const void* table,
                           const void* lens, void* out, int B, int H, int Q,
                           int d, int ptok, int npages, float scale,
                           void* stream) {
  return paged<float>(q, k_pool, v_pool, table, lens, out, B, H, Q, d, ptok,
                      npages, scale, stream);
}

int pt_paged_attention_bf16(const void* q, const void* k_pool,
                            const void* v_pool, const void* table,
                            const void* lens, void* out, int B, int H, int Q,
                            int d, int ptok, int npages, float scale,
                            void* stream) {
  return paged<__nv_bfloat16>(q, k_pool, v_pool, table, lens, out, B, H, Q,
                              d, ptok, npages, scale, stream);
}

int pt_decode_attention_f16(const void* q, const void* k, const void* v,
                            const void* lens, void* out, int B, int H, int Q,
                            int d, int C, int causal_window, float scale,
                            void* stream) {
  return dense<__half>(q, k, v, lens, out, B, H, Q, d, C, scale,
                       causal_window, stream);
}

int pt_paged_attention_f16(const void* q, const void* k_pool,
                           const void* v_pool, const void* table,
                           const void* lens, void* out, int B, int H, int Q,
                           int d, int ptok, int npages, float scale,
                           void* stream) {
  return paged<__half>(q, k_pool, v_pool, table, lens, out, B, H, Q, d, ptok,
                       npages, scale, stream);
}

}  // extern "C"
