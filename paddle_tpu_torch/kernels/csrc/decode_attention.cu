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
// per key and q-row, far below the H100's flops-per-byte balance point, so
// the least time is those bytes over the HBM rate (3.35 TB/s on the H100
// SXM). The design reads only live columns, reads each of them once
// whatever Q is, keeps enough blocks on the card to keep bytes in flight,
// and keeps the softmax carry on chip:
//   * the key axis of each (b, h) is cut into `splits` pieces of `piece`
//     columns, the last running on to the capacity (the host picks them,
//     decode_pieces in kernels/attention.py, from shapes and from the
//     longest live length where the caller holds it on the host, never
//     from a length on the card: one piece where B * H fills the card
//     several times over or every row ends within 128 columns, else
//     enough that the blocks fill it, at most 8; pieces are multiples of
//     128 columns, so whole tiles and, at 128-token pages, whole pages).
//     A block takes one piece of one (b, h) for all its q-rows and walks
//     its columns up to the rows' largest live limit; a piece that starts
//     past it writes an empty partial (m = -inf, l = 0) at once. A row
//     whose columns all lie in piece 0 (every row, with one piece) has
//     its output written by piece 0's block, and the later pieces of it
//     write nothing; a longer row's blocks write its fp32 partials (m, l,
//     acc[d]) to a workspace, and decode_attention_combine (launched as a
//     programmatic dependent launch, so its launch overlaps the split
//     kernel's last blocks) merges them in piece order,
//     o = sum_i exp(m_i - M) acc_i / sum_i exp(m_i - M) l_i, M = max m_i:
//     no atomics, so a result is the same from run to run, and a paged
//     launch and a dense launch of the same pieces agree bit for bit;
//   * every q-row of a (b, h) is in the block (up to 8 / NP of them, as
//     the host's decode_block_rows says; more rows take more blocks), so
//     each K/V tile crosses HBM once whatever Q is: the rows' scores
//     share one shared-memory read of each key slice;
//   * tiles of TR key columns are copied global -> shared with 16-byte
//     cp.async into a ring of kStages buffers: the first kStages tiles
//     are issued at once, then the copies of the next kStages - 1 tiles
//     are in flight while the block does the math of the current one (K
//     and V of a tile travel together). A stage holds at most 16 KB (32
//     keys of fp32 d 64; fewer keys of wider rows), so the ring takes
//     48 KB and four blocks share an SM: a short row's block, which
//     issues all its copies and then waits one round trip, overlaps three
//     others (rings of 2 or 4 tiles and tiles of 16 keys measured no
//     better: PERF.md);
//   * the math reads rows with 16-byte shared loads: a group of L lanes
//     covers one row of Dp elements, d rounded up to a multiple of 16
//     bytes, each lane holding NP 16-byte slices of each q-row in
//     registers (slices s, s + L, ...); up to 512 bytes NP is 1 and L the
//     row's 16-byte slices rounded up to a power of two (1 to 32), past
//     that L is 32 and NP 2 or 4 (rows up to 2048 bytes: fp32 d 512,
//     16-bit d 1024); both are template parameters, and the lanes past
//     the row (at 48, 96, 192 ... bytes) stay idle in loads and add zeros
//     to the shuffles; a group's partial dot products meet by shuffles,
//     those of a thread's rows interleaved;
//   * a row that is not a multiple of 16 bytes (fp32 d 6, bf16 d 12), or
//     a cache that does not start on a 16-byte boundary, cannot travel by
//     16-byte cp.async: its tiles are copied element by element with
//     ordinary loads into the same padded shared rows, zeros up to Dp
//     (zero key columns add nothing to q.k^T); the decode sessions pad
//     their caches' rows to 16 bytes, so this narrow copy serves only a
//     cache a caller passes in unpadded;
//   * each q-row's running max is block-wide, so every group rescales its
//     share of the sum and of the accumulator by the same factor, and the
//     groups' shares are added once at the end.
// Rows past 2048 bytes (fp32 d > 512, 16-bit d > 1024) take
// decode_attention_wide, in one piece: their output's columns are split
// across blocks, one 2048-byte chunk each (32 lanes of four 16-byte
// slices), and each block computes every key's full-row score by looping
// over the row's chunks (one chunk of a tile's K rows in shared memory at
// a time), then accumulates its own chunk of the V rows. Its copies wait
// for the block before its math (no ring): no preset has such rows, so it
// is right first; the bound is the same bytes, read once by each chunk's
// block for K.
//
// The dense and paged kernels are one template over a key/value source.
// Hopper has no scalar prefetch: the paged source copies the page indices
// of its block's piece into shared memory once, and each tile copy reads
// them there. The paged kernel on a pool and the dense kernel on the
// gathered cache see identical pieces and tiles and agree bit for bit.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 3;          // shared-memory tile buffers in the ring
constexpr int kStageBytes = 16384;  // the K and V rows of one tile, at most
constexpr int kCombineThreads = 64;
constexpr float kMasked = -1e30f;

// key columns of a tile for L lanes of NP 16-byte slices (rows up to
// 16 * L * NP bytes): 32, or fewer so that a stage stays in kStageBytes
__host__ __device__ constexpr int tile_rows(int L, int NP) {
  return kStageBytes / (2 * 16 * L * NP) < 32
             ? kStageBytes / (2 * 16 * L * NP)
             : 32;
}

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
  __device__ __forceinline__ DenseKV bind(int, int*, int, int) const {
    return *this;
  }
  __device__ __forceinline__ size_t offset(int b, int h, int col) const {
    return ((static_cast<size_t>(b) * H + h) * C + col) * d;
  }
};

// Paged pool [P, H, ptok, d]: logical column c of slot b lives in pool
// row table[b, c / ptok] at offset c % ptok. bind() copies the page
// indices of slot b's columns [c0, c1) into shared memory, so a tile copy
// reads its page index there instead of waiting on a global load before
// each 16-byte copy.
struct PagedKV {
  const int* table;  // [B, npages]; once bound, pages page0, page0 + 1, ...
  int H, ptok, npages, d, page0;
  static constexpr bool kHasTable = true;
  __device__ __forceinline__ PagedKV bind(int b, int* s_table, int c0,
                                          int c1) const {
    const int first = c0 / ptok, n = (c1 - 1) / ptok - first + 1;
    for (int i = threadIdx.x; i < n; i += kThreads)
      s_table[i] = table[static_cast<size_t>(b) * npages + first + i];
    PagedKV bound = *this;
    bound.table = s_table;
    bound.page0 = first;
    return bound;
  }
  __device__ __forceinline__ size_t offset(int, int h, int col) const {
    const int page = table[col / ptok - page0];
    return ((static_cast<size_t>(page) * H + h) * ptok + col % ptok) * d;
  }
};

// Start the copies of `n` key and value rows of D elements from logical
// column `col0` into the stage buffers sk / sv ([rows][Dp] each, Dp = D
// rounded up to 16 bytes): 16-byte cp.async slices, one per thread per
// step, or with ``narrow`` element by element through registers, with
// zeros from D to Dp.
template <typename T, typename KV>
__device__ __forceinline__ void issue_tile(const KV& kv, const T* k,
                                           const T* v, int b, int h,
                                           int col0, int n, int D, int Dp,
                                           bool narrow, T* sk, T* sv) {
  constexpr int kVec = 16 / sizeof(T);
  if (!narrow) {
    const int slices = D / kVec;
    for (int c = threadIdx.x; c < n * slices; c += kThreads) {
      const int row = c / slices, off = (c % slices) * kVec;
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

// What a launch of decode_attention_kernel reads and writes: q / out
// [B, H, Q, d], the caches through the KV source, lens [B]; with more
// than one piece the workspace ws: acc [B*H*Q][splits][d], then (m, l)
// [B*H*Q][splits][2], fp32.
template <typename T>
struct Args {
  const T* q;
  const T* k;
  const T* v;
  T* out;
  float* ws;
  const int* lens;
  int B, H, Q, d, Dp, narrow, capacity, piece, splits, causal_window;
  float scale;
};

// Bytes of the ring, which the groups' accumulators reuse at the end.
template <typename T, int L, int NP>
__host__ __device__ constexpr size_t front_bytes(int Dp) {
  return sizeof(T) * kStages * 2 * tile_rows(L, NP) * Dp >
                 sizeof(float) * (kThreads / L) * Dp
             ? sizeof(T) * kStages * 2 * tile_rows(L, NP) * Dp
             : sizeof(float) * (kThreads / L) * Dp;
}

// L lanes cover one key row of Dp elements, NP 16-byte slices a lane
// (Dp * sizeof(T) / 16 <= L * NP slices; lanes past them idle); a tile
// holds TR key rows; the block holds G = kThreads / L row groups, each
// taking R rows of a tile (rows g, g + G, ...; at L = 1 and 2 the groups
// past the tile's rows take none), so the R dot products of a thread are
// independent and their shuffles interleave. A block takes q-rows r0 to
// r0 + QB - 1 (those below Q) of one (b, h) over one piece of its keys.
template <typename T, int L, int NP, int QB, typename KV>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const Args<T> a, KV kv) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int TR = tile_rows(L, NP);
  constexpr int G = kThreads / L, R = (TR + G - 1) / G;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Dp = a.Dp;
  T* s_tiles = reinterpret_cast<T*>(smem_raw);        // [kStages][2][TR][Dp]
  float* s_acc = reinterpret_cast<float*>(smem_raw);  // [G][Dp] at the end
  float* s_l = reinterpret_cast<float*>(smem_raw +
                                        front_bytes<T, L, NP>(Dp));  // [G]
  float* s_red = s_l + G;                                // [QB][kWarps]
  int* s_table = reinterpret_cast<int*>(s_red + QB * kWarps);  // paged

  // the combine (a programmatic dependent launch) may start its blocks
  // once every block of this grid has started; they wait for its end
  asm volatile("griddepcontrol.launch_dependents;");
  // the pieces are the grid's slowest axis: every (b, h)'s piece 0, which
  // holds the work of a short row, is launched before any later piece
  const int split = blockIdx.z % a.splits;
  const int r0 = blockIdx.z / a.splits * QB, nq = min(QB, a.Q - r0);
  const int h = blockIdx.x, b = blockIdx.y;
  const int c_begin = split * a.piece;
  const int c_end =
      split == a.splits - 1 ? a.capacity : (split + 1) * a.piece;
  const int len = a.lens[b];
  const KV src = kv.bind(b, s_table, c_begin, c_end);

  const int tid = threadIdx.x, lane = tid & 31;
  const int g = tid / L, slice = tid % L;  // row group, first 16-byte slice
  const int slices = Dp / kVec;
  bool live[NP];                           // lanes past the row idle
#pragma unroll
  for (int j = 0; j < NP; ++j) live[j] = slice + j * L < slices;
  // the block's first q-row, counted over [B, H, Q]
  const size_t row0 = (static_cast<size_t>(b) * a.H + h) * a.Q + r0;
  float qv[QB][NP][kVec];
#pragma unroll
  for (int r = 0; r < QB; ++r)
#pragma unroll
    for (int j = 0; j < NP; ++j)
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const int at = (slice + j * L) * kVec + e;
        qv[r][j][e] = r < nq && live[j] && at < a.d
                          ? to_f32(a.q[(row0 + r) * a.d + at])
                          : 0.f;
      }

  // every column < limit[r] is live for row r; an empty window walks the
  // whole capacity with every score masked, which makes the softmax
  // uniform; the block walks its piece up to the rows' largest limit
  const int valid = min(len, a.capacity);
  int limit[QB], n_row[QB], need = 0;
#pragma unroll
  for (int r = 0; r < QB; ++r) {
    limit[r] = a.causal_window ? valid - (a.Q - 1 - (r0 + r)) : valid;
    n_row[r] = r < nq ? (limit[r] > 0 ? limit[r] : a.capacity) : 0;
    need = max(need, n_row[r]);
  }
  const int n_cols = min(need, c_end) - c_begin;
  float* ws_ml = a.splits == 1 ? nullptr
                               : a.ws + static_cast<size_t>(a.B) * a.H *
                                            a.Q * a.splits * a.d;
  if (KV::kHasTable) __syncthreads();
  if (n_cols <= 0) {
    // the piece starts past every row's live columns: an empty partial
    // for each row that spans more than piece 0 (piece 0 wrote the
    // others' outputs, and the combine skips them)
#pragma unroll
    for (int r = 0; r < QB; ++r)
      if (tid == r && n_row[r] > a.piece) {
        float* ml = ws_ml + ((row0 + r) * a.splits + split) * 2;
        ml[0] = -INFINITY;
        ml[1] = 0.f;
      }
    return;
  }
  const int n_tiles = (n_cols + TR - 1) / TR;

  // the whole ring at once: a short piece's tiles all travel in one
  // round trip
  for (int s = 0; s < kStages; ++s) {
    if (s < n_tiles) {
      T* sk = s_tiles + s * 2 * TR * Dp;
      issue_tile<T>(src, a.k, a.v, b, h, c_begin + s * TR,
                    min(TR, n_cols - s * TR), a.d, Dp, a.narrow, sk,
                    sk + TR * Dp);
    }
    cp_async_commit();  // empty groups keep the count per tile uniform
  }

  float acc[QB][NP][kVec], m[QB], l[QB];
#pragma unroll
  for (int r = 0; r < QB; ++r) {
    m[r] = kMasked;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < NP; ++j)
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[r][j][e] = 0.f;
  }

  for (int i = 0; i < n_tiles; ++i) {
    // tile i has landed for every thread (copy group i: the prologue's
    // kStages, then one a tile from tile 1 on), and every thread is done
    // with tile i - 1, whose buffer the copy below reuses
    if (i == 0)
      cp_async_wait<kStages - 1>();
    else
      cp_async_wait<kStages - 2>();
    __syncthreads();
    if (i > 0) {
      const int nxt = i + kStages - 1;
      if (nxt < n_tiles) {
        T* sk = s_tiles + (nxt % kStages) * 2 * TR * Dp;
        issue_tile<T>(src, a.k, a.v, b, h, c_begin + nxt * TR,
                      min(TR, n_cols - nxt * TR), a.d, Dp, a.narrow, sk,
                      sk + TR * Dp);
      }
      cp_async_commit();
    }

    const int col0 = c_begin + i * TR, n = min(TR, n_cols - i * TR);
    const T* sk = s_tiles + (i % kStages) * 2 * TR * Dp;
    const T* sv = sk + TR * Dp;
    float sc[QB][R];
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
      const int j = g + rr * G;
      float kx[NP][kVec];
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        if (j < n && live[p]) {
          load16(sk + j * Dp + (slice + p * L) * kVec, kx[p]);
        } else {
#pragma unroll
          for (int e = 0; e < kVec; ++e) kx[p][e] = 0.f;
        }
      }
#pragma unroll
      for (int r = 0; r < QB; ++r) {
        float dot = 0.f;
#pragma unroll
        for (int p = 0; p < NP; ++p)
#pragma unroll
          for (int e = 0; e < kVec; ++e)
            dot = fmaf(qv[r][p][e], kx[p][e], dot);
        sc[r][rr] = dot;
      }
    }
#pragma unroll
    for (int o = L >> 1; o > 0; o >>= 1) {
#pragma unroll
      for (int r = 0; r < QB; ++r)
#pragma unroll
        for (int rr = 0; rr < R; ++rr)
          sc[r][rr] += __shfl_xor_sync(0xffffffffu, sc[r][rr], o);
    }
    // a column past the tile or past its row's columns takes no part at
    // all (-inf: weight 0)
#pragma unroll
    for (int r = 0; r < QB; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int rr = 0; rr < R; ++rr) {
        const int j = g + rr * G, col = col0 + j;
        if (j < n && col < n_row[r]) {
          sc[r][rr] = col < limit[r] ? sc[r][rr] * a.scale : kMasked;
          mx = fmaxf(mx, sc[r][rr]);
        } else {
          sc[r][rr] = -INFINITY;
        }
      }
      mx = warp_max(mx);
      if (lane == 0) s_red[r * kWarps + (tid >> 5)] = mx;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < QB; ++r) {
      float m_new = m[r];
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        m_new = fmaxf(m_new, s_red[r * kWarps + w]);
      const float corr = expf(m[r] - m_new);
      l[r] *= corr;
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[r][p][e] *= corr;
#pragma unroll
      for (int rr = 0; rr < R; ++rr) {
        sc[r][rr] = expf(sc[r][rr] - m_new);
        l[r] += sc[r][rr];
      }
      m[r] = m_new;
    }
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
      const int j = g + rr * G;
      if (j >= n) continue;
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        if (!live[p]) continue;
        float vx[kVec];
        load16(sv + j * Dp + (slice + p * L) * kVec, vx);
#pragma unroll
        for (int r = 0; r < QB; ++r)
#pragma unroll
          for (int e = 0; e < kVec; ++e)
            acc[r][p][e] = fmaf(sc[r][rr], vx[e], acc[r][p][e]);
      }
    }
  }

  // the groups' shares of each row meet in shared memory, over the ring
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int r = 0; r < QB; ++r) {
    if (r >= nq) break;
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      if (!live[p]) continue;
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        s_acc[g * Dp + (slice + p * L) * kVec + e] = acc[r][p][e];
    }
    if (slice == 0) s_l[g] = l[r];
    __syncthreads();
    float sum = 0.f;
    for (int gg = 0; gg < G; ++gg) sum += s_l[gg];
    const size_t row = row0 + r;
    // piece 0 holds all of a short row's columns: it writes the output,
    // and l = -1 tells the combine that the row is done; a later piece
    // has no part of such a row and writes nothing
    const bool whole = split == 0 && n_row[r] <= c_end;
    if (whole || n_row[r] > a.piece) {
      for (int t = tid; t < a.d; t += kThreads) {
        float o = 0.f;
        for (int gg = 0; gg < G; ++gg) o += s_acc[gg * Dp + t];
        if (whole)
          store_f32(o / sum, a.out + row * a.d + t);
        else
          a.ws[(row * a.splits + split) * a.d + t] = o;
      }
      if (a.splits > 1 && tid == 0) {
        float* ml = ws_ml + (row * a.splits + split) * 2;
        ml[0] = sum > 0.f ? m[r] : -INFINITY;
        ml[1] = whole ? -1.f : sum;
      }
    }
    __syncthreads();  // before the next row's shares overwrite these
  }
}

// One block per q-row of [B * H * Q]: the row's partials, merged in piece
// order, o = sum_i exp(m_i - M) acc_i / sum_i exp(m_i - M) l_i, unless
// piece 0 held the whole row (l_0 = -1: it wrote the output). An empty
// piece (m = -inf) weighs nothing; piece 0 always holds a live column or
// an empty window's masked ones, so M is finite.
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
    decode_attention_combine(const float* __restrict__ ws,
                             T* __restrict__ out, int rows, int splits,
                             int d) {
  asm volatile("griddepcontrol.wait;" ::: "memory");  // the partials
  const size_t row = blockIdx.x;
  const float* acc = ws + row * splits * d;
  const float* ml = ws + static_cast<size_t>(rows) * splits * d +
                    row * splits * 2;
  if (ml[1] < 0.f) return;  // piece 0 held the whole row and wrote it
  float M = -INFINITY;
  for (int s = 0; s < splits; ++s) M = fmaxf(M, ml[2 * s]);
  for (int t = threadIdx.x; t < d; t += kCombineThreads) {
    float o = 0.f, sum = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float m = ml[2 * s];
      if (m == -INFINITY) continue;
      const float w = expf(m - M);
      o = fmaf(w, acc[static_cast<size_t>(s) * d + t], o);
      sum = fmaf(w, ml[2 * s + 1], sum);
    }
    store_f32(o / sum, out + row * d + t);
  }
}

// Rows past 2048 bytes: a block per (q-row and 2048-byte chunk of the
// output's columns, head, batch); decode_attention_kernel's math with
// L = 32 lanes of NP = 4 16-byte slices on each chunk of a row in turn.
constexpr int kChunkBytes = 2048;  // the widest row of one lane group
constexpr int kWideKeys = 16;      // keys of a tile of a wide row

// Start the copies of elements [c0, c0 + w) of `n` rows of x from logical
// column `col0` into s [n][kChunkBytes / sizeof(T)]: 16-byte cp.async
// slices, or with ``narrow`` element by element, with zeros from w to
// wp (w rounded up to 16 bytes).
template <typename T, typename KV>
__device__ __forceinline__ void issue_chunk(const KV& kv, const T* x, int b,
                                            int h, int col0, int n, int c0,
                                            int w, int wp, bool narrow,
                                            T* s) {
  constexpr int kVec = 16 / sizeof(T), CW = kChunkBytes / sizeof(T);
  if (!narrow) {
    const int slices = w / kVec;
    for (int i = threadIdx.x; i < n * slices; i += kThreads) {
      const int row = i / slices, off = (i % slices) * kVec;
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

  const KV src = kv.bind(b, s_table, 0, capacity);
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
        const int at = (lane + p * L) * kVec;  // the lane's slice of the chunk
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

template <typename T>
size_t wide_smem(int table_ints) {
  constexpr int CW = kChunkBytes / sizeof(T), G = kThreads / 32;
  return sizeof(T) * 2 * kWideKeys * CW +
         sizeof(float) * (G * CW + G + kWarps) + sizeof(int) * table_ints;
}

template <typename T, typename KV>
int launch_wide(const T* q, const T* k, const T* v, T* out, const int* lens,
                KV kv, int table_ints, int B, int H, int Q, int D,
                int narrow, int capacity, float scale, int causal_window,
                cudaStream_t stream) {
  constexpr int CW = kChunkBytes / sizeof(T);
  const int chunks = (D + CW - 1) / CW;
  const size_t smem = wide_smem<T>(table_ints);
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

template <typename T, int L, int NP, int QB>
size_t rows_smem(int Dp, int table_ints) {
  return front_bytes<T, L, NP>(Dp) +
         sizeof(float) * (kThreads / L + QB * kWarps) +
         sizeof(int) * table_ints;
}

template <typename T, int L, int NP, int QB, typename KV>
int launch_rows(const Args<T>& a, KV kv, int table_ints,
                cudaStream_t stream) {
  const size_t smem = rows_smem<T, L, NP, QB>(a.Dp, table_ints);
  auto kernel = decode_attention_kernel<T, L, NP, QB, KV>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(a.H, a.B, a.splits * ((a.Q + QB - 1) / QB));
  kernel<<<grid, kThreads, smem, stream>>>(a, kv);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || a.splits == 1) return static_cast<int>(e);
  // launched programmatically dependent: its launch overlaps the split
  // kernel's last blocks instead of following its end
  const int rows = a.B * a.H * a.Q;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(rows);
  cfg.blockDim = dim3(kCombineThreads);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, decode_attention_combine<T>,
                         static_cast<const float*>(a.ws), a.out, rows,
                         a.splits, a.d);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The q-rows a block takes, as the host decided them (decode_block_rows:
// 1, or all of up to 8 / NP, or 4 of them): f.template rows<L, NP, QB>()
// for the instance of QB q-rows; other counts are refused.
template <int L, int NP, typename F>
int by_rows(int rows, const F& f) {
  constexpr int kMost = 8 / NP, kMid = kMost > 4 ? 4 : kMost;
  if (rows == 1) return f.template rows<L, NP, 1>();
  if (rows == kMid) return f.template rows<L, NP, kMid>();
  if (rows == kMost) return f.template rows<L, NP, kMost>();
  return static_cast<int>(cudaErrorInvalidValue);
}

// Rows of any d: Dp is d rounded up to 16 bytes; the lanes a row takes
// are its 16-byte slices rounded up to a power of two, at most 32, with 2
// or 4 slices a lane past 512 bytes; f.template rows<L, NP, QB>(), or past
// 2048 bytes f.wide().
template <typename T, typename F>
int dispatch(int d, int rows, const F& f) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  const int slices = (d + kVec - 1) / kVec;
  if (slices > 4 * 32) return f.wide();
  if (slices > 2 * 32) return by_rows<32, 4>(rows, f);
  if (slices > 32) return by_rows<32, 2>(rows, f);
  int lanes = 1;
  while (lanes < slices && lanes < 32) lanes *= 2;
  switch (lanes) {
    case 1: return by_rows<1, 1>(rows, f);
    case 2: return by_rows<2, 1>(rows, f);
    case 4: return by_rows<4, 1>(rows, f);
    case 8: return by_rows<8, 1>(rows, f);
    case 16: return by_rows<16, 1>(rows, f);
    default: return by_rows<32, 1>(rows, f);
  }
}

template <typename T, typename KV>
struct Launch {
  const Args<T>& a;
  KV kv;
  int table_ints;
  cudaStream_t stream;
  template <int L, int NP, int QB>
  int rows() const {
    return launch_rows<T, L, NP, QB, KV>(a, kv, table_ints, stream);
  }
  int wide() const {
    if (a.splits != 1) return static_cast<int>(cudaErrorInvalidValue);
    return launch_wide<T, KV>(a.q, a.k, a.v, a.out, a.lens, kv, table_ints,
                              a.B, a.H, a.Q, a.d, a.narrow, a.capacity,
                              a.scale, a.causal_window, stream);
  }
};

// The copies are narrow (element by element) when a row is not a
// multiple of 16 bytes or a cache does not start on a 16-byte boundary.
// Piece i of `splits` covers columns [i * piece, (i + 1) * piece), the
// last one up to the capacity; with more than one, ws holds the partials.
template <typename T, typename KV>
int launch(Args<T> a, int rows, KV kv, int table_ints,
           cudaStream_t stream) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  if (a.B < 1 || a.H < 1 || a.Q < 1 || a.capacity < 1 || a.d < 1 ||
      a.piece < 1 || a.splits < 1 || rows < 1 ||
      static_cast<long long>(a.splits - 1) * a.piece >= a.capacity ||
      (a.splits > 1 && a.ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.splits == 1) a.piece = a.capacity;
  a.Dp = (a.d + kVec - 1) / kVec * kVec;
  a.narrow = a.d % kVec != 0 ||
             reinterpret_cast<uintptr_t>(a.k) % 16 != 0 ||
             reinterpret_cast<uintptr_t>(a.v) % 16 != 0;
  return dispatch<T>(a.d, rows, Launch<T, KV>{a, kv, table_ints, stream});
}

template <typename T>
int dense(const void* q, const void* k, const void* v, const void* lens,
          void* out, void* ws, int B, int H, int Q, int d, int C,
          int causal_window, int piece, int splits, int rows, float scale,
          void* stream) {
  Args<T> a{static_cast<const T*>(q), static_cast<const T*>(k),
            static_cast<const T*>(v), static_cast<T*>(out),
            static_cast<float*>(ws), static_cast<const int*>(lens),
            B, H, Q, d, 0, 0, C, piece, splits, causal_window, scale};
  return launch<T>(a, rows, DenseKV{H, C, d}, 0,
                   static_cast<cudaStream_t>(stream));
}

template <typename T>
int paged(const void* q, const void* k_pool, const void* v_pool,
          const void* table, const void* lens, void* out, void* ws, int B,
          int H, int Q, int d, int ptok, int npages, int piece, int splits,
          int rows, float scale, void* stream) {
  Args<T> a{static_cast<const T*>(q), static_cast<const T*>(k_pool),
            static_cast<const T*>(v_pool), static_cast<T*>(out),
            static_cast<float*>(ws), static_cast<const int*>(lens),
            B, H, Q, d, 0, 0, ptok * npages, piece, splits, 0, scale};
  PagedKV kv{static_cast<const int*>(table), H, ptok, npages, d, 0};
  return launch<T>(a, rows, kv, npages, static_cast<cudaStream_t>(stream));
}

}  // namespace

// Plain C entry points for ctypes. Each returns cudaGetLastError() after
// each launch (0 on success); the kernels run on `stream` and do not
// synchronise. All pointers are device pointers to contiguous tensors:
// q/out [B, H, Q, d], k/v [B, H, C, d] or pools [P, H, ptok, d] (any d;
// 16-byte rows on 16-byte boundaries take the asynchronous copies), lens
// [B] int32, table [B, npages] int32; `splits` pieces of `piece` key
// columns, the last up to the capacity ((splits - 1) * piece below it;
// with one, ws is unused and may be null; with more, ws holds B * H * Q *
// splits * (d + 2) floats, and rows past 2048 bytes refuse them); `rows`
// the q-rows a block takes (decode_block_rows: 1, 4 or 8 / slices a
// lane; others are refused); one entry per type (f32, bf16, f16) and
// source.
extern "C" {

int pt_decode_attention_f32(const void* q, const void* k, const void* v,
                            const void* lens, void* out, void* ws, int B,
                            int H, int Q, int d, int C, int causal_window,
                            int piece, int splits, int rows, float scale,
                            void* stream) {
  return dense<float>(q, k, v, lens, out, ws, B, H, Q, d, C, causal_window,
                      piece, splits, rows, scale, stream);
}

int pt_decode_attention_bf16(const void* q, const void* k, const void* v,
                             const void* lens, void* out, void* ws, int B,
                             int H, int Q, int d, int C, int causal_window,
                             int piece, int splits, int rows, float scale,
                             void* stream) {
  return dense<__nv_bfloat16>(q, k, v, lens, out, ws, B, H, Q, d, C,
                              causal_window, piece, splits, rows, scale,
                              stream);
}

int pt_decode_attention_f16(const void* q, const void* k, const void* v,
                            const void* lens, void* out, void* ws, int B,
                            int H, int Q, int d, int C, int causal_window,
                            int piece, int splits, int rows, float scale,
                            void* stream) {
  return dense<__half>(q, k, v, lens, out, ws, B, H, Q, d, C, causal_window,
                       piece, splits, rows, scale, stream);
}

int pt_paged_attention_f32(const void* q, const void* k_pool,
                           const void* v_pool, const void* table,
                           const void* lens, void* out, void* ws, int B,
                           int H, int Q, int d, int ptok, int npages,
                           int piece, int splits, int rows, float scale,
                           void* stream) {
  return paged<float>(q, k_pool, v_pool, table, lens, out, ws, B, H, Q, d,
                      ptok, npages, piece, splits, rows, scale, stream);
}

int pt_paged_attention_bf16(const void* q, const void* k_pool,
                            const void* v_pool, const void* table,
                            const void* lens, void* out, void* ws, int B,
                            int H, int Q, int d, int ptok, int npages,
                            int piece, int splits, int rows, float scale,
                            void* stream) {
  return paged<__nv_bfloat16>(q, k_pool, v_pool, table, lens, out, ws, B, H,
                              Q, d, ptok, npages, piece, splits, rows, scale,
                              stream);
}

int pt_paged_attention_f16(const void* q, const void* k_pool,
                           const void* v_pool, const void* table,
                           const void* lens, void* out, void* ws, int B,
                           int H, int Q, int d, int ptok, int npages,
                           int piece, int splits, int rows, float scale,
                           void* stream) {
  return paged<__half>(q, k_pool, v_pool, table, lens, out, ws, B, H, Q, d,
                       ptok, npages, piece, splits, rows, scale, stream);
}

}  // extern "C"
