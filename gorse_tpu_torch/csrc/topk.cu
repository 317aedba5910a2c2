// Exact dot-product top-k over a bf16 or scalar-quantized item table, for
// Hopper (sm_90a).
//
// Three kernels replace the TPU top-k in gorse_tpu/ops/topk.py. The TPU
// version walks item blocks in order on one core and carries a sorted
// running top-k in VMEM from grid step to grid step. Here blocks run in
// parallel with nothing carried between them, so the work splits into
// four launches per query chunk:
//
//   block_max    per-query maximum score of every item block, and
//                optionally of every group of 4 items            (K4)
//   block_seeds  per query, the seed (k-th largest block or group
//                maximum, nudged down) and how many beat it      (K5)
//   block_topk   every block whose maximum beats the query's seed
//                appends its best entries to a per-query
//                candidate buffer                                  (K5, K6)
//   merge_topk   per query, the final k from the candidates      (K5, K6)
//
// The route for a top-k of k over n_pad items (n_blocks = n_pad / 256) is
// chosen by ops/topk.py kernel_route:
//   k <= n_blocks             block gate: block_max, block_seeds on the
//                             block maxima, gated block_topk, merge (K5)
//   k <= n_pad / 4            group gate: block_max with its group output,
//                             block_seeds on the group maxima, gated
//                             block_topk, merge (K6's function: the TPU
//                             kernel carries its own running k-th best)
//   n_pad < 4 k               no gate: block_topk with every block firing,
//                             then merge_topk (K6's single pass)
// The k largest group maxima belong to k distinct items, so the k-th of
// them, nudged down, is below the k-th best score, as the k-th block
// maximum is: every top-k item beats the seed and lands in the candidates.
//
// Two tables, as the TPU kernels' two bodies (``has_affine``):
// - bf16 items: score = q (bf16) . item (bf16);
// - uint8 scalar-quantized items (the _sq entries, gorse_tpu/ops/topk.py
//   _block_scores :322-358): item v = minv + scale * codes per row, so
//   score = (q . codes) * scale + qsum * minv, and for euclidean
//   2 * that - norms2 - q2 (a negative squared distance). q is bf16 for
//   the dot, qsum and q2 come from the f32 queries (computed by the
//   wrapper, so kernel and plain version read the same bits).
//
// Scores: the dot accumulates in f32 by scalar FMA in ascending dimension
// order. A bf16 x bf16 product, and a bf16 x integer (0-255) product, is
// exact in f32, so every dot equals the sequential f32 sum that the plain
// PyTorch version (ops/topk.py, _scores_plain) computes. The epilogue is
// separate rounded multiplies and adds (__fmul_rn/__fadd_rn/__fsub_rn,
// never a contracted FMA), one per torch op of the plain version. Kernel and
// plain version agree bit for bit, and block_max and block_topk see the
// same scores.
//
// Order: (score descending, item index ascending), the tie order of
// jax.lax.top_k and of the TPU kernels. It is carried as one 64-bit key:
// high word the score mapped to an order-preserving signed int, low word
// 0xFFFFFFFF - index. The candidate buffer stores the key as int64 (signed
// order); kernels compare it as uint64 with the sign bit flipped.
//
// Layouts: q [b_pad, d_pad] bf16 and table [n_pad, d_pad] bf16 or uint8,
// both row-major, zero padded (b_pad % 32 == 0, d_pad % 64 == 0,
// n_pad % 256 == 0); for the quantized table an affine [3, n_pad] f32
// (scale, minv, norms2) and qstats [2, b_pad] f32 (qsum, q2). Padded items
// (index >= n_items) are never candidates.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_N = 256;  // items per block: the gate's granularity
constexpr int GROUP = 4;      // items per group maximum: a thread's 4 items
constexpr int QT = 32;        // queries per tile
constexpr int DC = 64;        // dimensions staged per pass
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MERGE_MAX_K = 2048;
constexpr float NEG_INF = -1e30f;

// ------------------------------------------------------------------ keys

__device__ __forceinline__ uint32_t ord_u32(float f) {
  uint32_t b = __float_as_uint(f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float from_ord_u32(uint32_t u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7FFFFFFFu) : ~u);
}

// unsigned key: larger = better (higher score, then lower index)
__device__ __forceinline__ unsigned long long make_key(float s, int idx) {
  return ((unsigned long long)ord_u32(s) << 32) |
         (unsigned long long)(0xFFFFFFFFu - (uint32_t)idx);
}

constexpr unsigned long long SIGN64 = 0x8000000000000000ull;

// ------------------------------------------------------------ score tile

// Scores of the QT queries of tile ``q0`` against the BLOCK_N items of
// block ``blk``. Thread t owns queries (t / 64) * 8 + a, a < 8, and items
// (t % 64) * 4 + c, c < 4: acc[a][c]. Each 64-dim pass stages the query
// tile as f32 [DC][QT] (read as broadcasts) and the item block as T
// [DC][BLOCK_N] (transposed, so a thread's 4 items are one 8-byte read of
// bf16, one 4-byte read of uint8 codes).
template <typename T>
struct TileSmem {
  float q[DC][QT];                                  // 8 KB
  union {
    T items[DC][BLOCK_N];                           // 32 KB bf16, 16 KB uint8
    float scores[QT][BLOCK_N];                      // 32 KB
  } u;
};

// item block: thread t loads item t, dims c0 .. c0 + 63
__device__ __forceinline__ void stage_items(const __nv_bfloat16* __restrict__ table, int blk,
                                            int c0, int d_pad,
                                            TileSmem<__nv_bfloat16>& sm) {
  const int t = threadIdx.x;
  const __nv_bfloat16* row = table + ((size_t)blk * BLOCK_N + t) * d_pad + c0;
#pragma unroll
  for (int u = 0; u < DC / 8; ++u) {
    uint4 v = __ldg(reinterpret_cast<const uint4*>(row + u * 8));
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
    for (int h = 0; h < 8; ++h) sm.u.items[u * 8 + h][t] = e[h];
  }
}

__device__ __forceinline__ void stage_items(const uint8_t* __restrict__ table, int blk, int c0,
                                            int d_pad, TileSmem<uint8_t>& sm) {
  const int t = threadIdx.x;
  const uint8_t* row = table + ((size_t)blk * BLOCK_N + t) * d_pad + c0;
#pragma unroll
  for (int u = 0; u < DC / 16; ++u) {
    uint4 v = __ldg(reinterpret_cast<const uint4*>(row + u * 16));
    const uint8_t* e = reinterpret_cast<const uint8_t*>(&v);
#pragma unroll
    for (int h = 0; h < 16; ++h) sm.u.items[u * 16 + h][t] = e[h];
  }
}

// items ti * 4 .. + 3 of staged dim j as f32 (both conversions exact)
__device__ __forceinline__ void load_items(const TileSmem<__nv_bfloat16>& sm, int j, int ti,
                                           float it[4]) {
  const uint2 iv = *reinterpret_cast<const uint2*>(&sm.u.items[j][ti * 4]);
  it[0] = __uint_as_float(iv.x << 16);
  it[1] = __uint_as_float(iv.x & 0xFFFF0000u);
  it[2] = __uint_as_float(iv.y << 16);
  it[3] = __uint_as_float(iv.y & 0xFFFF0000u);
}

__device__ __forceinline__ void load_items(const TileSmem<uint8_t>& sm, int j, int ti,
                                           float it[4]) {
  const uint32_t iv = *reinterpret_cast<const uint32_t*>(&sm.u.items[j][ti * 4]);
#pragma unroll
  for (int c = 0; c < 4; ++c) it[c] = __uint2float_rn((iv >> (8 * c)) & 0xFFu);
}

template <typename T>
__device__ __forceinline__ void score_tile(
    const __nv_bfloat16* __restrict__ q, const T* __restrict__ table,
    int q0, int blk, int d_pad, TileSmem<T>& sm, float acc[8][4]) {
  const int t = threadIdx.x;
  const int tq = t >> 6, ti = t & 63;
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] = 0.0f;

  for (int c0 = 0; c0 < d_pad; c0 += DC) {
    __syncthreads();  // previous readers of the staging buffers are done
    {
      // query tile: thread t loads row t / 8, dims (t % 8) * 8 .. + 7
      const int r = t >> 3, j0 = (t & 7) * 8;
      uint4 v = *reinterpret_cast<const uint4*>(q + (size_t)(q0 + r) * d_pad + c0 + j0);
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        sm.q[j0 + 2 * h][r] = __uint_as_float(w[h] << 16);
        sm.q[j0 + 2 * h + 1][r] = __uint_as_float(w[h] & 0xFFFF0000u);
      }
    }
    stage_items(table, blk, c0, d_pad, sm);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < DC; ++j) {
      const float4 qa = *reinterpret_cast<const float4*>(&sm.q[j][tq * 8]);
      const float4 qb = *reinterpret_cast<const float4*>(&sm.q[j][tq * 8 + 4]);
      float it[4];
      load_items(sm, j, ti, it);
      const float qv[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(qv[a], it[c], acc[a][c]);
    }
  }
}

// The quantized table's per-item affine and per-query statistics; a null
// ``affine`` means a plain bf16 table and no epilogue.
struct Affine {
  const float* affine;  // [3, n_pad]: scale, minv, norms2
  const float* qstats;  // [2, b_pad]: qsum, q2 of the f32 queries
  int n_pad, b_pad, euclid;
};

// The epilogue of gorse_tpu/ops/topk.py _block_scores (:353-357) on the
// thread's acc[a][c]: dots = raw * scale + qsum * minv, and for euclidean
// 2 * dots - norms2 - q2, each op rounded on its own.
__device__ __forceinline__ void apply_affine(const Affine& af, int q0, int blk,
                                             float acc[8][4]) {
  const int t = threadIdx.x, tq = t >> 6, ti = t & 63;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int idx = blk * BLOCK_N + ti * 4 + c;
    const float scale = af.affine[idx], minv = af.affine[af.n_pad + idx];
    const float n2 = af.affine[2 * af.n_pad + idx];
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const int qi = q0 + tq * 8 + a;
      const float qsum = af.qstats[qi], q2 = af.qstats[af.b_pad + qi];
      const float d = __fadd_rn(__fmul_rn(acc[a][c], scale), __fmul_rn(qsum, minv));
      acc[a][c] = af.euclid ? __fsub_rn(__fsub_rn(__fmul_rn(2.0f, d), n2), q2) : d;
    }
  }
}

// --------------------------------------------------------------- K4

// Replaces gorse_tpu/ops/topk.py _block_max_kernel (pass 1).
// Bound on this card: at the serving shape (B 256, 1M x 64 items) one
// table stream is 128 MB bf16 or 64 MB of codes + 12 MB of affine (~38 or
// ~23 us at 3.35 TB/s) and the dots are 33.6 GFLOP (~34 us on bf16 tensor
// cores). This kernel runs the dots as
// scalar f32 FMA (67 TFLOP/s peak, so >= 0.5 ms): it is bound by FMA
// issue, not by bytes. Its design keeps the bytes at one stream: grid x
// is the query tile, so the tiles of one item block run side by side and
// share the block through L2. The FMA order is fixed so that the plain
// version reproduces every score; tensor cores (mma/wgmma) are later work.
// With ``gmax`` (the group gate) each thread also writes the maximum of its
// 4 items for each of its 8 queries, [b_pad, n_pad / 4] f32: a query's 64
// group maxima of a block are 64 neighbouring floats, so the stores
// coalesce. That adds b_pad * n_pad bytes written (128 MB at 256 x 500k,
// ~38 us) to a kernel bound by FMA issue.
template <typename T>
__global__ void __launch_bounds__(THREADS) block_max_kernel(
    const __nv_bfloat16* __restrict__ q, const T* __restrict__ table, Affine af,
    float* __restrict__ bmax, float* __restrict__ gmax, int d_pad, int n_items,
    int n_blocks) {
  __shared__ TileSmem<T> sm;
  __shared__ float red[WARPS][8];
  const int q0 = blockIdx.x * QT, blk = blockIdx.y;
  float acc[8][4];
  score_tile(q, table, q0, blk, d_pad, sm, acc);
  if (af.affine != nullptr) apply_affine(af, q0, blk, acc);

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int tq = t >> 6, ti = t & 63;
  const size_t n_groups = (size_t)n_blocks * (BLOCK_N / GROUP);
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    float m = NEG_INF;
#pragma unroll
    for (int c = 0; c < GROUP; ++c) {
      const int idx = blk * BLOCK_N + ti * GROUP + c;
      if (idx < n_items) m = fmaxf(m, acc[a][c]);
    }
    if (gmax != nullptr)
      gmax[(q0 + tq * 8 + a) * n_groups + blk * (BLOCK_N / GROUP) + ti] = m;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (lane == 0) red[warp][a] = m;
  }
  __syncthreads();
  if (t < QT) {
    // query t lives in warps 2 * (t / 8) and 2 * (t / 8) + 1, slot t % 8
    const int w0 = 2 * (t >> 3), a = t & 7;
    bmax[(size_t)(q0 + t) * n_blocks + blk] = fmaxf(red[w0][a], red[w0 + 1][a]);
  }
}

// --------------------------------------------------------------- K5, K6

struct SelectSmem {
  unsigned int hist[256];
  int bin, above;
};

// The k-th largest of the n unsigned keys key(0..n) (duplicates counted),
// by the whole thread block: radix select, 8 bits per pass from the top.
template <typename U, typename KeyFn>
__device__ U block_kth_largest(int n, int k, KeyFn key, SelectSmem& sm) {
  const int t = threadIdx.x;
  U prefix = 0, mask = 0;
  int need = k;
  for (int shift = 8 * (int)sizeof(U) - 8; shift >= 0; shift -= 8) {
    for (int i = t; i < 256; i += THREADS) sm.hist[i] = 0;
    __syncthreads();
    for (int i = t; i < n; i += THREADS) {
      const U u = key(i);
      if ((u & mask) == prefix) atomicAdd(&sm.hist[(unsigned int)(u >> shift) & 255u], 1u);
    }
    __syncthreads();
    if (t == 0) {
      int cum = 0, b = 255;
      for (; b > 0; --b) {
        if (cum + (int)sm.hist[b] >= need) break;
        cum += (int)sm.hist[b];
      }
      sm.bin = b;
      sm.above = cum;
    }
    __syncthreads();
    need -= sm.above;
    prefix |= (U)sm.bin << shift;
    mask |= (U)0xFF << shift;
  }
  return prefix;
}

// The seed step of gorse_tpu/ops/topk.py _topk_seeded_kernel (topk.py:501).
// One thread block per query: the k-th largest of its block maxima, nudged
// down (a lower bound on its k-th best score), or NEG_INF when
// k > n_blocks, and the number of blocks whose maximum beats it. That
// number sizes block_topk's candidate buffer, so the buffer grows with
// what the gate lets through, not with the catalog. Bound: one read of
// bmax (4 MB at the serving shape, ~1.2 us at 3.35 TB/s); four radix
// passes over a row that stays in L1/L2. Deriving the seeds here once,
// not in each of block_topk's item-block stripes, keeps block_topk's
// work to the blocks that fire.
__global__ void __launch_bounds__(THREADS) block_seeds_kernel(
    const float* __restrict__ bmax, float* __restrict__ seeds, int* __restrict__ fired,
    int n_blocks, int k) {
  __shared__ SelectSmem sm;
  __shared__ int n_fired;
  const int t = threadIdx.x;
  const float* row = bmax + (size_t)blockIdx.x * n_blocks;
  float s = NEG_INF;
  if (k <= n_blocks) {
    const float v = from_ord_u32(block_kth_largest<uint32_t>(
        n_blocks, k, [row](int i) { return ord_u32(row[i]); }, sm));
    s = __fsub_rn(v, __fadd_rn(__fmul_rn(fabsf(v), 1.2e-7f), 1e-30f));
  }
  if (t == 0) n_fired = 0;
  __syncthreads();
  int c = 0;
  for (int i = t; i < n_blocks; i += THREADS) c += row[i] > s;
  c = __reduce_add_sync(0xffffffffu, c);
  if ((t & 31) == 0) atomicAdd(&n_fired, c);
  __syncthreads();
  if (t == 0) {
    seeds[blockIdx.x] = s;
    fired[blockIdx.x] = n_fired;
  }
}

// Replaces gorse_tpu/ops/topk.py _topk_seeded_kernel (K5, with ``bmax``)
// and _topk_kernel (K6: with ``bmax`` and seeds from the group maxima, or
// with ``bmax`` and ``seeds`` null, every block firing, when n_pad < 4 k).
// A block fires for a query when its maximum beats the query's seed
// (block_seeds); it then appends its entries above the seed to the
// query's candidates, or, when more than k are, its own top k by key.
// Every global top-k entry beats the seed and is among its block's top
// k, so the candidates hold the answer. Every entry above the seed lies in
// a block (group) whose maximum beats it, so the buffer holds min(k, 256)
// keys for each block (min(k, 4) for each group) that fires for the query
// that fires most, every block's when ungated: nothing is cut.
// Bound on this card: the dots of the tiles that fire (same FMA issue
// bound as block_max) plus the candidate bytes. The gate skips a whole
// tile when none of its 32 queries fires; at k = 10 about 8% of tiles
// fire at 1M items, at k = 300 most do. Grid: (query tiles, n_split);
// a block reads its 32 seeds once and then walks every n_split-th item
// block.
template <typename T>
__global__ void __launch_bounds__(THREADS) block_topk_kernel(
    const __nv_bfloat16* __restrict__ q, const T* __restrict__ table, Affine af,
    const float* __restrict__ bmax, const float* __restrict__ seeds,
    long long* __restrict__ cand,
    int* __restrict__ count, int b, int d_pad, int n_items, int n_blocks, int k,
    int cap) {
  __shared__ TileSmem<T> sm;
  __shared__ float seed[QT];
  __shared__ int fire[QT];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int q0 = blockIdx.x * QT;

  if (t < QT) seed[t] = (seeds != nullptr && q0 + t < b) ? seeds[q0 + t] : NEG_INF;
  __syncthreads();

  for (int blk = blockIdx.y; blk < n_blocks; blk += gridDim.y) {
    int f = 0;
    if (t < QT && q0 + t < b)
      f = bmax == nullptr ? 1 : (bmax[(size_t)(q0 + t) * n_blocks + blk] > seed[t]);
    if (t < QT) fire[t] = f;
    if (!__syncthreads_or(f)) continue;  // no query of the tile needs this block

    float acc[8][4];
    score_tile(q, table, q0, blk, d_pad, sm, acc);
    if (af.affine != nullptr) apply_affine(af, q0, blk, acc);
    __syncthreads();  // the item staging buffer becomes the score buffer
    {
      const int tq = t >> 6, ti = t & 63;
#pragma unroll
      for (int a = 0; a < 8; ++a)
        *reinterpret_cast<float4*>(&sm.u.scores[tq * 8 + a][ti * 4]) =
            make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
    }
    __syncthreads();

    for (int r = warp * (QT / WARPS); r < (warp + 1) * (QT / WARPS); ++r) {
      if (!fire[r]) continue;
      const float sd = seed[r];
      unsigned long long key[8];
      bool valid[8], sel[8];
      int c = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int idx = blk * BLOCK_N + i * 32 + lane;  // ballot order = index order
        const float s = sm.u.scores[r][i * 32 + lane];
        valid[i] = idx < n_items;
        key[i] = valid[i] ? make_key(s, idx) : 0ull;
        sel[i] = valid[i] && s > sd;
        c += __popc(__ballot_sync(0xffffffffu, sel[i]));
      }
      if (c == 0) continue;
      if (c > k) {
        // more than k above the seed: keep the block's own top k. rank =
        // number of keys of the block larger than this one.
        int rank[8] = {0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
        for (int i2 = 0; i2 < 8; ++i2) {
          for (int src = 0; src < 32; ++src) {
            const unsigned long long o = __shfl_sync(0xffffffffu, key[i2], src);
#pragma unroll
            for (int i = 0; i < 8; ++i) rank[i] += (o > key[i]);
          }
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) sel[i] = valid[i] && rank[i] < k;
        c = k;
      }
      int off = 0;
      if (lane == 0) off = atomicAdd(&count[q0 + r], c);
      off = __shfl_sync(0xffffffffu, off, 0);
      long long* dst = cand + (size_t)(q0 + r) * cap;
      const unsigned int lt = (1u << lane) - 1u;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const unsigned int m = __ballot_sync(0xffffffffu, sel[i]);
        if (sel[i]) dst[off + __popc(m & lt)] = (long long)(key[i] ^ SIGN64);
        off += __popc(m);
      }
    }
    __syncthreads();  // score buffer is read before the next tile restages
  }
}

// The final merge of K5/K6: one block per query selects the k largest
// keys of its candidates (block_kth_largest over the 64-bit keys, when
// there are more than k), sorts them (bitonic, in shared
// memory) and writes (score, index), with NEG_INF / 0 filling the slots
// that have no candidate. Bound: the candidate bytes, a few KB per query
// at the serving shape.
__global__ void __launch_bounds__(THREADS) merge_topk_kernel(
    const long long* __restrict__ cand, const int* __restrict__ count,
    float* __restrict__ out_s, int* __restrict__ out_i, int k, int k_pow2, int cap) {
  __shared__ unsigned long long keys[MERGE_MAX_K];
  __shared__ SelectSmem sm;
  __shared__ int n_sel;
  const int t = threadIdx.x, qi = blockIdx.x;
  const int c = count[qi];
  const long long* src = cand + (size_t)qi * cap;

  unsigned long long prefix = 0;
  if (c > k)
    prefix = block_kth_largest<unsigned long long>(
        c, k, [src](int i) { return (unsigned long long)src[i] ^ SIGN64; }, sm);
  // keys are unique, so exactly min(c, k) of them are >= the k-th largest
  if (t == 0) n_sel = 0;
  for (int i = t; i < k_pow2; i += THREADS) keys[i] = 0ull;
  __syncthreads();
  for (int i = t; i < c; i += THREADS) {
    const unsigned long long u = (unsigned long long)src[i] ^ SIGN64;
    if (c <= k || u >= prefix) keys[atomicAdd(&n_sel, 1)] = u;
  }
  // bitonic sort, descending
  for (int size = 2; size <= k_pow2; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      __syncthreads();
      for (int i = t; i < k_pow2; i += THREADS) {
        const int j = i ^ stride;
        if (j > i) {
          const unsigned long long a = keys[i], bb = keys[j];
          if (((i & size) == 0) ? (a < bb) : (a > bb)) {
            keys[i] = bb;
            keys[j] = a;
          }
        }
      }
    }
  }
  __syncthreads();
  const int n = min(c, k);
  for (int j = t; j < k; j += THREADS) {
    float s = NEG_INF;
    int idx = 0;
    if (j < n) {
      const unsigned long long u = keys[j];
      s = from_ord_u32((uint32_t)(u >> 32));
      idx = (int)(0xFFFFFFFFu - (uint32_t)(u & 0xFFFFFFFFull));
    }
    out_s[(size_t)qi * k + j] = s;
    out_i[(size_t)qi * k + j] = idx;
  }
}

}  // namespace

// ------------------------------------------------------------ C entries
// Each returns cudaGetLastError() after its launch; the Python wrapper
// raises when it is not 0. Launches go on the caller's stream.

extern "C" int gt_block_max(const void* q, const void* table, void* bmax, void* gmax,
                            int b_pad, int d_pad, int n_items, int n_blocks, void* stream) {
  dim3 grid(b_pad / QT, n_blocks);
  block_max_kernel<__nv_bfloat16><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)table, Affine{nullptr, nullptr, 0, 0, 0},
      (float*)bmax, (float*)gmax, d_pad, n_items, n_blocks);
  return (int)cudaGetLastError();
}

extern "C" int gt_block_max_sq(const void* q, const void* codes, const void* affine,
                               const void* qstats, void* bmax, void* gmax, int b_pad, int d_pad,
                               int n_items, int n_blocks, int euclid, void* stream) {
  dim3 grid(b_pad / QT, n_blocks);
  block_max_kernel<uint8_t><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const uint8_t*)codes,
      Affine{(const float*)affine, (const float*)qstats, n_blocks * BLOCK_N, b_pad, euclid},
      (float*)bmax, (float*)gmax, d_pad, n_items, n_blocks);
  return (int)cudaGetLastError();
}

extern "C" int gt_block_seeds(const void* bmax, void* seeds, void* fired, int b, int n_blocks,
                              int k, void* stream) {
  block_seeds_kernel<<<b, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)bmax, (float*)seeds, (int*)fired, n_blocks, k);
  return (int)cudaGetLastError();
}

extern "C" int gt_block_topk(const void* q, const void* table, const void* bmax,
                             const void* seeds, void* cand, void* count, int b, int b_pad,
                             int d_pad, int n_items, int n_blocks, int k, int cap, int n_split,
                             void* stream) {
  dim3 grid(b_pad / QT, n_split);
  block_topk_kernel<__nv_bfloat16><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)table, Affine{nullptr, nullptr, 0, 0, 0},
      (const float*)bmax, (const float*)seeds, (long long*)cand, (int*)count, b, d_pad, n_items,
      n_blocks, k, cap);
  return (int)cudaGetLastError();
}

extern "C" int gt_block_topk_sq(const void* q, const void* codes, const void* affine,
                                const void* qstats, const void* bmax, const void* seeds,
                                void* cand, void* count, int b, int b_pad, int d_pad,
                                int n_items, int n_blocks, int k, int cap, int n_split,
                                int euclid, void* stream) {
  dim3 grid(b_pad / QT, n_split);
  block_topk_kernel<uint8_t><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const uint8_t*)codes,
      Affine{(const float*)affine, (const float*)qstats, n_blocks * BLOCK_N, b_pad, euclid},
      (const float*)bmax, (const float*)seeds, (long long*)cand, (int*)count, b, d_pad, n_items,
      n_blocks, k, cap);
  return (int)cudaGetLastError();
}

extern "C" int gt_merge_topk(const void* cand, const void* count, void* out_s, void* out_i,
                             int b, int k, int k_pow2, int cap, void* stream) {
  merge_topk_kernel<<<b, THREADS, 0, (cudaStream_t)stream>>>(
      (const long long*)cand, (const int*)count, (float*)out_s, (int*)out_i, k, k_pow2, cap);
  return (int)cudaGetLastError();
}
