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
//                maximum, nudged down) and how many beat it, by a
//                4,096-bin select that reads the maxima once or
//                twice                                             (K5)
//   block_topk   every block whose maximum beats the query's seed
//                appends its best entries to a per-query
//                candidate buffer                                  (K5, K6)
//   merge_topk   per query, the final k from the candidates: the
//                output cut by rank into slices of up to 4,096, a
//                block per slice, each selecting its two boundary
//                keys and sorting its keys in shared memory      (K5, K6)
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
// Scores: one score tile (score_blocks / mma_pass) serves block_max and
// block_topk, both tables. The dot runs on the tensor cores,
// mma.sync m16n8k16 bf16 x bf16 -> f32, operands from shared memory by
// ldmatrix; codes 0-255 are exact in bf16, so they are converted as they
// are staged and take the same instruction (the reference scores each
// block with one MXU dot with f32 accumulation, gorse_tpu/ops/topk.py
// :336-351). The epilogue is separate rounded multiplies and adds
// (__fmul_rn/__fadd_rn/__fsub_rn, never a contracted FMA), one per torch
// op of the plain version. The tensor cores sum in another order than the
// plain version's sequential f32 FMA chain (ops/topk.py _scores_plain), so
// kernel and plain version agree within a summation-order bound, exactly
// where every partial sum is an integer below 2^24. block_max and
// block_topk run the same instructions on the same fragments in the same
// k order, so they see the same f32 bits for every (query, item): a block
// whose maximum beats a seed holds an item that beats it in block_topk too,
// which is what keeps the gate sound.
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
// (index >= n_items) are never candidates. A launch holds at most 256
// queries; the C entries launch once per 256-query slice.
//
// A fifth kernel, bin_max (and bin_max_sq), serves the approximate tier
// (ops/topk.py dot_topk_approx, sq_topk_approx): each query's maximum key
// in each of L strided bins (item j in bin j mod L), the PartialReduce
// step of jax.lax.approx_max_k, which merge_topk then reduces to the top k.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BLOCK_N = 256;  // items per block: the gate's granularity
constexpr int GROUP = 4;      // items per group maximum
constexpr int DC = 64;        // dimensions per pass: one 128-byte bf16 row
constexpr int RQ = 64;        // queries per round of the score tile
constexpr int QSLICE = 256;   // most queries one launch holds
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int NSTAGE = 2;     // item slabs in flight
constexpr int WIN = 256;      // block_topk: item blocks gated per window
constexpr int GSTRIDE = 68;   // floats per row of the staged group maxima
constexpr int SSTRIDE = 264;  // floats per row of block_topk's staged scores
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

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

// ------------------------------------------------- staging (cp.async)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A staged row is 64 bf16 = 8 chunks of 16 bytes; chunk c of row r sits at
// chunk c ^ (r % 8), so the 8 rows an ldmatrix reads hit 8 distinct bank
// groups.
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * 128 + ((chunk ^ (row & 7)) << 4);
}

// rows row0 .. row0 + nrows - 1, dims c0 .. c0 + 63 of a bf16 [*, d_pad]
// array into a swizzled [nrows][64] slab
__device__ __forceinline__ void stage_rows(const __nv_bfloat16* __restrict__ src, size_t row0,
                                           int nrows, int c0, int d_pad, uint8_t* dst) {
  for (int id = threadIdx.x; id < nrows * 8; id += THREADS) {
    const int r = id >> 3, c = id & 7;
    cp_async16(dst + swz(r, c), src + (row0 + r) * (size_t)d_pad + c0 + c * 8);
  }
}

__device__ __forceinline__ void stage_items(const __nv_bfloat16* __restrict__ table, int blk,
                                            int c0, int d_pad, uint8_t* dst) {
  stage_rows(table, (size_t)blk * BLOCK_N, BLOCK_N, c0, d_pad, dst);
}

// uint8 codes land raw ([256][64] bytes) and are converted by convert_codes
__device__ __forceinline__ void stage_items(const uint8_t* __restrict__ table, int blk, int c0,
                                            int d_pad, uint8_t* dst) {
  for (int id = threadIdx.x; id < BLOCK_N * 4; id += THREADS) {
    const int r = id >> 2, c = id & 3;
    cp_async16(dst + id * 16, table + ((size_t)blk * BLOCK_N + r) * d_pad + c0 + c * 16);
  }
}

template <typename T>
__host__ __device__ constexpr int slab_bytes() {
  return BLOCK_N * DC * (int)sizeof(T);
}

// two codes (bytes j and j + 1 of w) as a bf16 pair: an integer below 256
// has at most 8 significant bits, so its f32 value's upper half is its
// bf16 value exactly
__device__ __forceinline__ uint32_t bf16x2_of_codes(uint32_t w, int j) {
  const uint32_t lo = __float_as_uint(__uint2float_rn((w >> (8 * j)) & 0xFFu));
  const uint32_t hi = __float_as_uint(__uint2float_rn((w >> (8 * j + 8)) & 0xFFu));
  return __byte_perm(lo, hi, 0x7632);
}

// raw codes [256][64] -> the swizzled bf16 slab the tile reads
__device__ __forceinline__ void convert_codes(const uint8_t* raw, uint8_t* dst) {
  for (int id = threadIdx.x; id < BLOCK_N * 4; id += THREADS) {
    const int r = id >> 2, c = id & 3;
    const uint4 v = *reinterpret_cast<const uint4*>(raw + id * 16);
    *reinterpret_cast<uint4*>(dst + swz(r, 2 * c)) =
        make_uint4(bf16x2_of_codes(v.x, 0), bf16x2_of_codes(v.x, 2), bf16x2_of_codes(v.y, 0),
                   bf16x2_of_codes(v.y, 2));
    *reinterpret_cast<uint4*>(dst + swz(r, 2 * c + 1)) =
        make_uint4(bf16x2_of_codes(v.z, 0), bf16x2_of_codes(v.z, 2), bf16x2_of_codes(v.w, 0),
                   bf16x2_of_codes(v.w, 2));
  }
}

// ------------------------------------------------------------ score tile

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const uint8_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The score tile of one round: RQ = 64 queries x 256 items. Warp w holds
// queries (w / 4) * 32 + [0, 32) (two 16-row m tiles) and items
// (w % 4) * 64 + [0, 64) (eight 8-column n tiles): acc[mt][nt][e] is the
// m16n8 C fragment, row (lane / 4) + 8 (e / 2), column 2 (lane % 4) + e % 2.
// One pass adds the 64 dimensions of the staged slabs to acc, in four k16
// steps, ascending; passes run in ascending dimension order. ``live`` has a
// bit per 16-query m tile of the round; a dead tile is not computed.
using Acc = float[2][8][4];

__device__ __forceinline__ void mma_pass(const uint8_t* qs, const uint8_t* items, unsigned live,
                                         Acc& acc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wq = warp >> 2, wn = warp & 3;
  const unsigned mine = (live >> (2 * wq)) & 3u;
  if (mine == 0) return;
#pragma unroll
  for (int ks = 0; ks < DC / 16; ++ks) {
    uint32_t a[2][4], b[4][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      if (mine >> mt & 1u)
        ldsm_x4(a[mt], qs + swz(wq * 32 + mt * 16 + (lane & 15), 2 * ks + (lane >> 4)));
#pragma unroll
    for (int np = 0; np < 4; ++np)
      ldsm_x4(b[np], items + swz(wn * 64 + np * 16 + (lane & 7) + ((lane >> 4) << 3),
                                 2 * ks + ((lane >> 3) & 1)));
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      if (mine >> mt & 1u)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
          mma_bf16(acc[mt][nt], a[mt], b[nt >> 1][(nt & 1) * 2], b[nt >> 1][(nt & 1) * 2 + 1]);
  }
}

template <typename T>
__host__ __device__ constexpr int score_smem_bytes(int nq, int d_pad) {
  return (d_pad == DC ? nq : RQ) * 128 + NSTAGE * slab_bytes<T>() +
         (sizeof(T) == 1 ? BLOCK_N * DC * 2 : 0);
}

// Scores the listed item blocks against the launch's nq queries, round by
// round, and hands each round's fragments to ``epi(i, blk, round, acc)``.
// ``block_at(i)`` is the i-th block of the list, ``live(i, round)`` the
// round's live m tiles (0: the round is skipped). With d_pad = 64 the
// queries stay resident in shared memory and the item slabs stream through
// an NSTAGE-deep cp.async ring, so the table is read once; wider tables
// stage each (round, 64-dimension pass) in turn. All threads of the block
// call this with the same arguments; ``epi`` may synchronise.
template <typename T, typename BlockAt, typename Live, typename Epi>
__device__ __forceinline__ void score_blocks(const __nv_bfloat16* __restrict__ q,
                                             const T* __restrict__ table, int nq, int d_pad,
                                             uint8_t* smem, int n_list, BlockAt block_at,
                                             Live live, Epi epi) {
  const bool resident = d_pad == DC;
  uint8_t* qbuf = smem;
  uint8_t* stages = qbuf + (resident ? nq : RQ) * 128;
  uint8_t* conv = stages + NSTAGE * slab_bytes<T>();
  const bool codes = sizeof(T) == 1;
  const int n_rounds = (nq + RQ - 1) / RQ;
  Acc acc;

  auto zero = [&acc]() {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;
  };

  if (resident) {
    stage_rows(q, 0, nq, 0, d_pad, qbuf);
#pragma unroll
    for (int s = 0; s < NSTAGE - 1; ++s) {
      if (s < n_list) stage_items(table, block_at(s), 0, d_pad, stages + s * slab_bytes<T>());
      cp_async_commit();
    }
    for (int i = 0; i < n_list; ++i) {
      cp_async_wait<NSTAGE - 2>();
      __syncthreads();  // slab i landed; the slab read at i - 1 is free
      const int nx = i + NSTAGE - 1;
      if (nx < n_list)
        stage_items(table, block_at(nx), 0, d_pad, stages + (nx % NSTAGE) * slab_bytes<T>());
      cp_async_commit();
      const uint8_t* items = stages + (i % NSTAGE) * slab_bytes<T>();
      if (codes) {
        convert_codes(items, conv);
        __syncthreads();
        items = conv;
      }
      const int blk = block_at(i);
      for (int r = 0; r < n_rounds; ++r) {
        const unsigned m = live(i, r);
        if (m == 0) continue;
        zero();
        mma_pass(qbuf + r * RQ * 128, items, m, acc);
        epi(i, blk, r, acc);
      }
    }
  } else {
    for (int i = 0; i < n_list; ++i) {
      const int blk = block_at(i);
      for (int r = 0; r < n_rounds; ++r) {
        const unsigned m = live(i, r);
        if (m == 0) continue;
        zero();
        for (int c0 = 0; c0 < d_pad; c0 += DC) {
          __syncthreads();  // the previous pass's readers are done
          stage_rows(q, (size_t)r * RQ, min(RQ, nq - r * RQ), c0, d_pad, qbuf);
          stage_items(table, blk, c0, d_pad, stages);
          cp_async_commit();
          cp_async_wait<0>();
          __syncthreads();
          const uint8_t* items = stages;
          if (codes) {
            convert_codes(items, conv);
            __syncthreads();
            items = conv;
          }
          mma_pass(qbuf, items, m, acc);
        }
        epi(i, blk, r, acc);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the buffers are free for the caller
}

// The quantized table's per-item affine and the slice's per-query
// statistics; a null ``affine`` means a plain bf16 table and no epilogue.
struct Affine {
  const float* affine;  // [3, n_pad]: scale, minv, norms2
  const float* qsum;    // [nq]: sum(q) of the f32 queries
  const float* q2;      // [nq]: sum(q * q)
  int n_pad, euclid;
};

// The epilogue of gorse_tpu/ops/topk.py _block_scores (:353-357) on a
// round's fragments: dots = raw * scale + qsum * minv, and for euclidean
// 2 * dots - norms2 - q2, each op rounded on its own.
__device__ __forceinline__ void apply_affine(const Affine& af, int blk, int q0, int nq, Acc& acc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wq = warp >> 2, wn = warp & 3, g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int row0 = q0 + wq * 32 + mt * 16;
    if (row0 >= nq) continue;
    float qs[2], qq[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      qs[h] = __ldg(af.qsum + row0 + g + 8 * h);
      qq[h] = __ldg(af.q2 + row0 + g + 8 * h);
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e1 = 0; e1 < 2; ++e1) {
        const int idx = blk * BLOCK_N + wn * 64 + nt * 8 + tq * 2 + e1;
        const float scale = __ldg(af.affine + idx), minv = __ldg(af.affine + af.n_pad + idx);
        const float n2 = __ldg(af.affine + 2 * af.n_pad + idx);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float& x = acc[mt][nt][2 * h + e1];
          const float d = __fadd_rn(__fmul_rn(x, scale), __fmul_rn(qs[h], minv));
          x = af.euclid ? __fsub_rn(__fsub_rn(__fmul_rn(2.0f, d), n2), qq[h]) : d;
        }
      }
    }
  }
}

// this block's share of the n item blocks: a contiguous range
__device__ __forceinline__ void block_range(int n, int& lo, int& hi) {
  lo = (int)((long long)blockIdx.x * n / gridDim.x);
  hi = (int)((long long)(blockIdx.x + 1) * n / gridDim.x);
}

// m tiles of round r that hold queries below nq
__device__ __forceinline__ unsigned rows_live(int r, int nq) {
  unsigned m = 0;
#pragma unroll
  for (int j = 0; j < RQ / 16; ++j)
    if (r * RQ + j * 16 < nq) m |= 1u << j;
  return m;
}

// --------------------------------------------------------------- K4

// Replaces gorse_tpu/ops/topk.py _block_max_kernel (pass 1).
// Bound on this card: at the serving shape (B 256, 1M x 64 items) one
// table stream is 128 MB bf16 or 64 MB of codes + 8-12 MB of affine (~38
// or ~23 us at 3.35 TB/s) and the dots are 33.6 GFLOP (~34 us on bf16
// tensor cores): about balanced. The design reads the table once (queries
// resident, slabs through a cp.async ring, a persistent grid of one or two
// blocks per SM over contiguous ranges of item blocks, so no grid limit on
// the catalog) and runs the dots as mma.sync. Block maxima: a register max
// over the fragment, a quad shuffle, a reduction across the 4 warps of a
// row in shared memory. With ``gmax`` (the group gate) also the maximum of
// every 4 items, [b_pad, n_pad / 4] f32: in the C fragment a lane holds
// two adjacent columns, so a group is one shuffle between neighbouring
// lanes; the round's groups are staged in shared memory and written a row
// at a time (coalesced). That adds b_pad * n_pad bytes written (128 MB at
// 256 x 500k, ~38 us).
template <typename T>
__global__ void __launch_bounds__(THREADS) block_max_kernel(
    const __nv_bfloat16* __restrict__ q, const T* __restrict__ table, Affine af,
    float* __restrict__ bmax, float* __restrict__ gmax, int nq, int d_pad, int n_items,
    int n_blocks) {
  extern __shared__ __align__(128) uint8_t dsm[];
  float* red = reinterpret_cast<float*>(dsm + score_smem_bytes<T>(nq, d_pad));  // [4][RQ]
  float* gsm = red + 4 * RQ;                                                     // [RQ][GSTRIDE]
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int wq = warp >> 2, wn = warp & 3, g = lane >> 2, tq = lane & 3;
  const size_t n_groups = (size_t)n_blocks * (BLOCK_N / GROUP);
  int lo, hi;
  block_range(n_blocks, lo, hi);

  auto epi = [&](int, int blk, int r, Acc& acc) {
    if (af.affine != nullptr) apply_affine(af, blk, r * RQ, nq, acc);
    float rmax[2][2] = {{NEG_INF, NEG_INF}, {NEG_INF, NEG_INF}};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = wn * 64 + nt * 8 + tq * 2;
      const bool ok0 = blk * BLOCK_N + col < n_items, ok1 = blk * BLOCK_N + col + 1 < n_items;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float m = fmaxf(ok0 ? acc[mt][nt][2 * h] : NEG_INF, ok1 ? acc[mt][nt][2 * h + 1] : NEG_INF);
          rmax[mt][h] = fmaxf(rmax[mt][h], m);
          if (gmax != nullptr) {
            m = fmaxf(m, __shfl_xor_sync(FULL, m, 1));
            if ((tq & 1) == 0) gsm[(wq * 32 + mt * 16 + g + 8 * h) * GSTRIDE + col / GROUP] = m;
          }
        }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float m = rmax[mt][h];
        m = fmaxf(m, __shfl_xor_sync(FULL, m, 1));
        m = fmaxf(m, __shfl_xor_sync(FULL, m, 2));
        if (tq == 0) red[wn * RQ + wq * 32 + mt * 16 + g + 8 * h] = m;
      }
    __syncthreads();
    const int q0 = r * RQ;
    if (t < RQ && q0 + t < nq)
      bmax[(size_t)(q0 + t) * n_blocks + blk] =
          fmaxf(fmaxf(red[t], red[RQ + t]), fmaxf(red[2 * RQ + t], red[3 * RQ + t]));
    if (gmax != nullptr) {
      for (int id = t; id < RQ * (BLOCK_N / GROUP / 4); id += THREADS) {
        const int row = id >> 4, f = id & 15;
        if (q0 + row < nq)
          *reinterpret_cast<float4*>(gmax + (size_t)(q0 + row) * n_groups +
                                     (size_t)blk * (BLOCK_N / GROUP) + f * 4) =
              *reinterpret_cast<const float4*>(gsm + row * GSTRIDE + f * 4);
      }
    }
    __syncthreads();  // red and gsm are read before the next round writes them
  };
  score_blocks<T>(q, table, nq, d_pad, dsm, hi - lo, [lo](int i) { return lo + i; },
                  [nq](int, int r) { return rows_live(r, nq); }, epi);
}

// --------------------------------------------------------------- K5, K6

// ------------------------------------------------------------ block_seeds
//
// The seed step of gorse_tpu/ops/topk.py _topk_seeded_kernel (topk.py:501).
// One thread block per query: v, the k-th largest of its n maxima (block or
// group maxima; duplicates counted), the seed s = v - (|v| 1.2e-7 + 1e-30)
// in separately rounded f32 ops (a lower bound on the k-th best score), or
// NEG_INF when k > n, and ``fired``, the number of maxima above s. Both
// are exact. ``fired`` sizes block_topk's candidate buffer, so the buffer
// grows with what the gate lets through, not with the catalog.
//
// Bound on this card: one read of the maxima. At the group gate (256
// queries x 125,056 group maxima, 500k items) that is 128 MB, ~38 us at
// 3.35 TB/s, and it does not fit the 50 MB L2; at the block gate (256 x
// 3,907 block maxima, 1M items) 4 MB, ~1.2 us, and there the time is
// latency: barriers and serial steps.
//
// The select works on the order-preserving key u = ord_u32(x), whose top 12
// bits (sign, 8 exponent bits, 3 mantissa bits) split the line into 4,096
// bins an eighth of an octave wide:
// - A row of at most SEED_CAP maxima is read once, into shared memory, and
//   every pass runs there.
// - A longer row is read once for a 4,096-bin histogram of the top digit;
//   a block-wide scan (warp shuffles) finds the boundary bin B, the one
//   that holds the k-th largest, and the count above it. A second read
//   appends the keys of bin B to shared memory (one ballot and one
//   atomicAdd a warp); the select finishes there on the low 20 bits.
// - When bin B holds more than SEED_CAP keys (heavy ties, constant rows),
//   the next 12 bits take another histogram pass over the row, and so on;
//   the same launch, only slower on those inputs.
// - Histogram increments are plain shared atomicAdds. The maxima of one
//   query crowd a few dozen of the 4,096 bins, so lanes of a warp collide
//   a few at a time; aggregating within the warp first (__match_any_sync)
//   measured slower on the card than the collisions it avoids. Only
//   constant rows and heavy ties, where a warp's 32 lanes hit one bin,
//   serialise.
// - fired without another read: every key above the buffer's prefix beats
//   v and so s (s < v), and there are k - need of them; the rest that beat
//   s are in the buffer when s shares its prefix. When the nudge takes s
//   below the prefix (v at its bin's lower edge, e.g. a power of two), or
//   no buffer was used, one counting pass over the row gives fired.
// For floats that are not NaN, x > s exactly when ord_u32(x) > ord_u32(s)
// unless s is -0.0, which v - (positive) never is; so keys compare as the
// reference's floats do.
// Each row adds one to the count of the branch it took (one global atomic
// a launch's block), so a check can show which branch an input reached;
// gt_block_seeds_branches reads and clears the counts.

constexpr int SEED_THREADS = 1024;
constexpr int SEED_WARPS = SEED_THREADS / 32;
constexpr int SEED_BITS = 12;                    // digit of a histogram pass
constexpr int SEED_BINS = 1 << SEED_BITS;
constexpr int SEED_CAP = 8000;                   // keys the shared buffer holds (32 KB)
// the branches, in the order of ops/topk.py SEED_BRANCHES: k > n; the row
// staged whole; one histogram pass, fired from the buffer or (edge) by a
// count; two passes, likewise; every bit by passes over the row
enum SeedBranch {
  SB_K_ABOVE_N, SB_STAGED, SB_BIN, SB_EDGE, SB_OVERFLOW, SB_OVERFLOW_EDGE, SB_GLOBAL,
  SEED_BRANCHES
};
__device__ unsigned int seed_branch_rows[SEED_BRANCHES];

struct SeedSmem {
  unsigned int hist[SEED_BINS];                  // first: 16-byte aligned for uint4 reads
  int part[SEED_WARPS];
  int bin, above, count, n_buf, fired;
};

constexpr int seed_smem_bytes() { return (int)sizeof(SeedSmem) + SEED_CAP * 4; }
// within the 48 KB a launch may take without an opt-in attribute; two
// blocks of 1,024 threads (at most 32 registers each) share an SM
static_assert(seed_smem_bytes() <= 48 * 1024, "block_seeds' shared memory");

// f(u, ok) for the key of each of the n floats of ``row``, in no order.
// Every lane of a warp makes the same calls (ok false for the padding), so
// f may use warp collectives (the compaction's ballot). The 16-byte-aligned
// body goes in float4 loads, two in flight a thread; the unaligned head and
// the tail (at most 3 floats each) go to warp 0.
template <typename F>
__device__ __forceinline__ void each_in_row(const float* __restrict__ row, int n, F&& f) {
  const int t = threadIdx.x, lane = t & 31;
  const int head = min(n, (int)(((16u - ((uint32_t)(uintptr_t)row & 15u)) & 15u) >> 2));
  const int nv = (n - head) >> 2;
  const int tail0 = head + 4 * nv;
  if (t < 32) {
    const bool ok = t < head + (n - tail0);
    f(ok ? ord_u32(row[t < head ? t : tail0 + t - head]) : 0u, ok);
  }
  const float4* body = reinterpret_cast<const float4*>(row + head);
  for (int base = t - lane; base < nv; base += 2 * SEED_THREADS) {
    const int i0 = base + lane, i1 = i0 + SEED_THREADS;
    const bool ok0 = i0 < nv, ok1 = i1 < nv;
    const float4 x0 = ok0 ? __ldg(body + i0) : make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 x1 = ok1 ? __ldg(body + i1) : make_float4(0.f, 0.f, 0.f, 0.f);
    f(ord_u32(x0.x), ok0);
    f(ord_u32(x0.y), ok0);
    f(ord_u32(x0.z), ok0);
    f(ord_u32(x0.w), ok0);
    f(ord_u32(x1.x), ok1);
    f(ord_u32(x1.y), ok1);
    f(ord_u32(x1.z), ok1);
    f(ord_u32(x1.w), ok1);
  }
}

// The same over the n keys of the shared buffer.
template <typename F>
__device__ __forceinline__ void each_in_buf(const uint32_t* buf, int n, F&& f) {
  const int lane = threadIdx.x & 31;
  for (int base = threadIdx.x - lane; base < n; base += SEED_THREADS) {
    const bool ok = base + lane < n;
    f(ok ? buf[base + lane] : 0u, ok);
  }
}

// After a histogram pass of digit (u >> sh) & dmask: the boundary bin of
// the need-th largest key, by a scan from the top bin down (warp shuffles,
// then across warps). Narrows prefix/mask to it, leaves need for within
// the bin and cnt = the keys in it.
__device__ void seed_boundary(int sh, uint32_t dmask, uint32_t& prefix, uint32_t& mask,
                              int& need, int& cnt, SeedSmem& sm) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  // thread t holds bins 4 (SEED_THREADS - 1 - t) .. + 3, so a scan in thread
  // order runs from the top bin down
  const int b0 = (SEED_THREADS - 1 - t) * 4;
  const uint4 h = *reinterpret_cast<const uint4*>(&sm.hist[b0]);
  const int local = (int)(h.x + h.y + h.z + h.w);
  int incl = local;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) sm.part[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int p = sm.part[lane];
    int q = p;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, q, o);
      if (lane >= o) q += y;
    }
    sm.part[lane] = q - p;
  }
  __syncthreads();
  const int need0 = need;
  int cum = sm.part[warp] + incl - local;  // keys in the bins above this thread's
  if (cum < need0 && need0 <= cum + local) {
    const int c[4] = {(int)h.w, (int)h.z, (int)h.y, (int)h.x};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (cum + c[j] >= need0) {
        sm.bin = b0 + 3 - j;
        sm.above = cum;
        sm.count = c[j];
        break;
      }
      cum += c[j];
    }
  }
  __syncthreads();
  prefix |= (uint32_t)sm.bin << sh;
  mask |= dmask << sh;
  need -= sm.above;
  cnt = sm.count;
}

// One select pass over ``each``'s keys with (u & mask) == prefix: the
// histogram of their next digit of at most SEED_BITS bits below ``shift``
// (plain shared atomicAdds), then seed_boundary.
template <typename Each>
__device__ void seed_pass(Each each, uint32_t& prefix, uint32_t& mask, int& need, int& shift,
                          int& cnt, SeedSmem& sm) {
  const int bits = min(SEED_BITS, shift);
  shift -= bits;
  const uint32_t dmask = (1u << bits) - 1u, pre = prefix, msk = mask;
  const int sh = shift;
  for (int i = threadIdx.x; i < SEED_BINS; i += SEED_THREADS) sm.hist[i] = 0;
  __syncthreads();
  each([&](uint32_t u, bool ok) {
    if (ok && (u & msk) == pre) atomicAdd(&sm.hist[(u >> sh) & dmask], 1u);
  });
  __syncthreads();
  seed_boundary(sh, dmask, prefix, mask, need, cnt, sm);
}

// The keys of ``each`` that beat us, summed over the block (called once a
// launch: sm.fired starts at 0).
template <typename Each>
__device__ int seed_count_above(Each each, uint32_t us, SeedSmem& sm) {
  int c = 0;
  each([&](uint32_t u, bool ok) { c += ok && u > us; });
  c = __reduce_add_sync(FULL, c);
  if ((threadIdx.x & 31) == 0 && c != 0) atomicAdd(&sm.fired, c);
  __syncthreads();
  return sm.fired;
}

__global__ void __launch_bounds__(SEED_THREADS, 2) block_seeds_kernel(
    const float* __restrict__ bmax, float* __restrict__ seeds, int* __restrict__ fired, int n,
    int k) {
  extern __shared__ __align__(16) uint8_t dsm[];
  SeedSmem& sm = *reinterpret_cast<SeedSmem*>(dsm);
  uint32_t* buf = reinterpret_cast<uint32_t*>(dsm + sizeof(SeedSmem));
  const int t = threadIdx.x, lane = t & 31;
  const float* row = bmax + (size_t)blockIdx.x * n;
  auto global = [row, n](auto&& f) { each_in_row(row, n, f); };
  if (t == 0) {
    sm.n_buf = 0;
    sm.fired = 0;
  }
  __syncthreads();
  float s = NEG_INF;
  int n_fired = -1;  // -1: not known without a counting pass over the row
  int branch = SB_K_ABOVE_N;
  if (k <= n) {
    uint32_t prefix = 0, mask = 0;
    int need = k, shift = 32, cnt = n, passes = 0;
    for (; shift > 0 && cnt > SEED_CAP; ++passes)
      seed_pass(global, prefix, mask, need, shift, cnt, sm);
    const uint32_t bprefix = prefix, bmask = mask;
    const int bneed = need, bcnt = cnt;
    const bool buffered = shift > 0;
    if (buffered) {
      // the keys under the prefix (the whole row, when it fits) into shared memory
      each_in_row(row, n, [&](uint32_t u, bool ok) {
        const bool in = ok && (u & bmask) == bprefix;
        const unsigned bal = __ballot_sync(FULL, in);
        if (bal == 0u) return;
        int at = 0;
        if (lane == 0) at = atomicAdd(&sm.n_buf, __popc(bal));
        at = __shfl_sync(FULL, at, 0);
        if (in) buf[at + __popc(bal & ((1u << lane) - 1u))] = u;
      });
      __syncthreads();
      auto shared = [buf, bcnt](auto&& f) { each_in_buf(buf, bcnt, f); };
      while (shift > 0) seed_pass(shared, prefix, mask, need, shift, cnt, sm);
    }
    const float v = from_ord_u32(prefix);
    s = __fsub_rn(v, __fadd_rn(__fmul_rn(fabsf(v), 1.2e-7f), 1e-30f));
    if (buffered && (ord_u32(s) & bmask) == bprefix)
      n_fired = (k - bneed) + seed_count_above(
          [buf, bcnt](auto&& f) { each_in_buf(buf, bcnt, f); }, ord_u32(s), sm);
    branch = !buffered ? SB_GLOBAL : passes == 0 ? SB_STAGED
             : (passes == 1 ? SB_BIN : SB_OVERFLOW) + (n_fired < 0);
  }
  if (n_fired < 0) n_fired = seed_count_above(global, ord_u32(s), sm);
  if (t == 0) {
    seeds[blockIdx.x] = s;
    fired[blockIdx.x] = n_fired;
    atomicAdd(&seed_branch_rows[branch], 1u);
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
// Bound on this card: the dots of the (query, block) pairs that fire plus
// the candidate bytes. Design: the persistent grid of block_max; each
// block first reads its range's maxima row by row (coalesced) into a fire
// mask per item block (one bit per query), then runs the score tile over
// the blocks where some query fires, skipping rounds and 16-query m tiles
// where none does. A round's scores of the firing queries go to shared
// memory; a warp per firing query ballots its 256 entries in index order
// and appends the selected ones with one atomicAdd on the query's count.
template <typename T>
__global__ void __launch_bounds__(THREADS) block_topk_kernel(
    const __nv_bfloat16* __restrict__ q, const T* __restrict__ table, Affine af,
    const float* __restrict__ bmax, const float* __restrict__ seeds,
    long long* __restrict__ cand, int* __restrict__ count, int nq, int b, int d_pad,
    int n_items, int n_blocks, int k, int cap) {
  extern __shared__ __align__(128) uint8_t dsm[];
  float* scores = reinterpret_cast<float*>(dsm + score_smem_bytes<T>(nq, d_pad));  // [RQ][SSTRIDE]
  uint32_t* qmask = reinterpret_cast<uint32_t*>(scores + RQ * SSTRIDE);  // [WIN][QSLICE / 32]
  float* seed = reinterpret_cast<float*>(qmask + WIN * (QSLICE / 32));   // [QSLICE]
  int* list = reinterpret_cast<int*>(seed + QSLICE);                     // [WIN]
  int* wcount = list + WIN;                                              // [WARPS]
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int wq = warp >> 2, wn = warp & 3, g = lane >> 2, tq = lane & 3;
  constexpr int MW = QSLICE / 32;  // mask words per item block
  int lo, hi;
  block_range(n_blocks, lo, hi);
  if (t < QSLICE) seed[t] = (seeds != nullptr && t < b) ? seeds[t] : NEG_INF;

  auto fires = [&](int slot, int qi) { return (qmask[slot * MW + (qi >> 5)] >> (qi & 31)) & 1u; };

  for (int w0 = lo; w0 < hi; w0 += WIN) {
    const int wl = min(WIN, hi - w0);
    for (int i = t; i < WIN * MW; i += THREADS) qmask[i] = 0;
    __syncthreads();
    for (int qi = warp; qi < b; qi += WARPS) {
      const float sd = seed[qi];
      for (int j = lane; j < wl; j += 32)
        if (bmax == nullptr || bmax[(size_t)qi * n_blocks + w0 + j] > sd)
          atomicOr(&qmask[j * MW + (qi >> 5)], 1u << (qi & 31));
    }
    __syncthreads();
    // the window's blocks where some query fires, in order
    bool any = false;
    if (t < wl)
#pragma unroll
      for (int w = 0; w < MW; ++w) any |= qmask[t * MW + w] != 0u;
    const unsigned bal = __ballot_sync(FULL, any);
    if (lane == 0) wcount[warp] = __popc(bal);
    __syncthreads();
    int off = 0, n_list = 0;
    for (int w = 0; w < WARPS; ++w) {
      off += w < warp ? wcount[w] : 0;
      n_list += wcount[w];
    }
    if (any) list[off + __popc(bal & ((1u << lane) - 1u))] = t;
    __syncthreads();

    auto live = [&](int i, int r) {
      const int slot = list[i];
      unsigned m = 0;
#pragma unroll
      for (int j = 0; j < RQ / 16; ++j) {
        const int q16 = r * RQ + j * 16;
        if (q16 < nq && ((qmask[slot * MW + (q16 >> 5)] >> (q16 & 16)) & 0xFFFFu) != 0u)
          m |= 1u << j;
      }
      return m;
    };
    auto epi = [&](int i, int blk, int r, Acc& acc) {
      const int slot = list[i], q0 = r * RQ;
      if (af.affine != nullptr) apply_affine(af, blk, q0, nq, acc);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = wq * 32 + mt * 16 + g + 8 * h;
          if (q0 + row < nq && fires(slot, q0 + row))
#pragma unroll
            for (int nt = 0; nt < 8; ++nt)
              *reinterpret_cast<float2*>(scores + row * SSTRIDE + wn * 64 + nt * 8 + tq * 2) =
                  make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
        }
      __syncthreads();
      for (int row = warp * (RQ / WARPS); row < (warp + 1) * (RQ / WARPS); ++row) {
        const int qi = q0 + row;
        if (qi >= b || !fires(slot, qi)) continue;
        const float sd = seed[qi];
        unsigned long long key[8];
        bool valid[8], sel[8];
        int c = 0;
#pragma unroll
        for (int i2 = 0; i2 < 8; ++i2) {
          const int idx = blk * BLOCK_N + i2 * 32 + lane;  // ballot order = index order
          const float s = scores[row * SSTRIDE + i2 * 32 + lane];
          valid[i2] = idx < n_items;
          key[i2] = valid[i2] ? make_key(s, idx) : 0ull;
          sel[i2] = valid[i2] && s > sd;
          c += __popc(__ballot_sync(FULL, sel[i2]));
        }
        if (c == 0) continue;
        if (c > k) {
          // more than k above the seed: keep the block's own top k. rank =
          // number of keys of the block larger than this one.
          int rank[8] = {0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
          for (int i2 = 0; i2 < 8; ++i2) {
            for (int src = 0; src < 32; ++src) {
              const unsigned long long o = __shfl_sync(FULL, key[i2], src);
#pragma unroll
              for (int i3 = 0; i3 < 8; ++i3) rank[i3] += (o > key[i3]);
            }
          }
#pragma unroll
          for (int i2 = 0; i2 < 8; ++i2) sel[i2] = valid[i2] && rank[i2] < k;
          c = k;
        }
        int at = 0;
        if (lane == 0) at = atomicAdd(&count[qi], c);
        at = __shfl_sync(FULL, at, 0);
        long long* dst = cand + (size_t)qi * cap;
        const unsigned int lt = (1u << lane) - 1u;
#pragma unroll
        for (int i2 = 0; i2 < 8; ++i2) {
          const unsigned int m = __ballot_sync(FULL, sel[i2]);
          if (sel[i2]) dst[at + __popc(m & lt)] = (long long)(key[i2] ^ SIGN64);
          at += __popc(m);
        }
      }
      __syncthreads();  // the score rows are read before the next round writes them
    };
    score_blocks<T>(q, table, nq, d_pad, dsm, n_list, [&](int i) { return w0 + list[i]; }, live,
                    epi);
  }
}

// ------------------------------------------------------------- merge_topk
//
// The final stage of K5/K6, the running top-k fold of
// gorse_tpu/ops/topk.py (:404): each query's min(count, k) largest
// candidate keys, sorted descending, written as (score, index), NEG_INF / 0
// in the slots past the count. The keys of a query are unique (one per
// item), so the result is exact.
//
// Bound on this card: the live candidate keys read once and the output
// written once, a few KB a query at the serving shapes (0.4 us at 256
// queries x k = 298), so the time is latency: barriers and dependent
// steps. The design:
// - Split by rank. A query's output is cut into slices of ``slice`` ranks
//   (at most MERGE_SLICE); one block of 1,024 threads owns a slice. Its
//   keys are exactly those between two boundary keys, the (lo + 1)-th and
//   the hi-th largest, so blocks share nothing and any k runs on chip. The
//   wrapper halves the slice (down to 1,024) while b x slices would leave
//   SMs idle.
// - The boundaries by block_seeds' select (seed_pass, seed_boundary): 12-bit
//   digits of the high word (the score's ord), then of the low word among
//   the keys that share it, stopping when the boundary bin holds one key,
//   which a last read finds. A row of at most MERGE_STAGE keys is read once
//   into shared memory and every pass runs there. A longer row is read once
//   for the top digit of both boundaries; each boundary's bin is appended to
//   shared memory (one ballot and one atomicAdd a warp) and its select
//   finishes there; a bin over MERGE_STAGE keys (heavy ties) takes its
//   passes over the row instead (L2-resident).
// - The slice's keys appended to shared memory (padded with zero keys to a
//   power of two) and sorted there: each warp sorts runs of 32 by a bitonic
//   network of shuffles, then rounds of merges double the runs, each
//   thread placing 4 outputs after a binary search on its diagonal (merge
//   path), one block barrier a round. Two other sorts measured slower on
//   the card: a bitonic network over the whole slice (66 steps at 2,048
//   keys, bound by the SM's one warp shuffle a clock) and merges that
//   place every key by a binary search of the partner run (shared-memory
//   traffic). Decoded and written by coalesced stores.
// Shared memory: 16.5 KB for the select, the staging buffer (32 KB, the
// sort's second buffer too) and the slice (32 KB) at most: two blocks an
// SM, at 32 registers a thread.
// Each block adds one to the count of the path it took;
// gt_merge_topk_paths reads and clears the counts.

constexpr int MERGE_SLICE = 4096;  // most ranks one block sorts (32 KB of keys)
constexpr int MERGE_STAGE = 4096;  // most keys of a row staged in shared memory (32 KB)
// the paths, in the order of ops/topk.py MERGE_PATHS: ranks past the count
// (fill only); no select (the slice holds every key); the row staged; a
// long row, its boundary bins staged; a boundary bin too large to stage
enum MergePath { MP_FILL, MP_WHOLE, MP_STAGED, MP_BIN, MP_GLOBAL, MERGE_PATHS };
__device__ unsigned int merge_path_blocks[MERGE_PATHS];

struct MergeSmem {
  SeedSmem seed;             // the select's histogram and scan
  unsigned long long found;  // a boundary key
  int n_buf, n_sel;
};
constexpr int MERGE_HEAD = ((int)sizeof(MergeSmem) + 15) / 16 * 16;

// the staged row, then the slice's keys; the staging buffer holds at least
// the slice, as the sort's second buffer
constexpr int merge_smem_bytes(int stage_cap, int slots) {
  return MERGE_HEAD + ((stage_cap > slots ? stage_cap : slots) + slots) * 8;
}
static_assert(MERGE_SLICE <= MERGE_STAGE, "the staging buffer holds a slice");
static_assert(2 * (merge_smem_bytes(MERGE_STAGE, MERGE_SLICE) + 1024) <= 228 * 1024,
              "two merge_topk blocks an SM");

typedef unsigned long long u64;

// f(u, ok) for each of the n keys of a candidate row (int64, compared as
// uint64 with the sign bit flipped), in no order. Every lane of a warp
// makes the same calls, so f may use warp collectives. 16-byte loads; an
// unaligned first key and an odd last one go to warp 0.
template <typename F>
__device__ __forceinline__ void each_in_cand(const long long* __restrict__ row, int n, F&& f) {
  const int t = threadIdx.x, lane = t & 31;
  const int head = min(n, (int)(((uintptr_t)row >> 3) & 1u));
  const int nv = (n - head) >> 1;
  const int tail = n - head - 2 * nv;
  if (t < 32) {
    const bool ok = t < head + tail;
    f(ok ? (u64)__ldg(row + (t < head ? 0 : n - 1)) ^ SIGN64 : 0ull, ok);
  }
  const longlong2* body = reinterpret_cast<const longlong2*>(row + head);
  for (int base = t - lane; base < nv; base += SEED_THREADS) {
    const int i = base + lane;
    const bool ok = i < nv;
    const longlong2 v = ok ? __ldg(body + i) : make_longlong2(0, 0);
    f((u64)v.x ^ SIGN64, ok);
    f((u64)v.y ^ SIGN64, ok);
  }
}

// The same over n keys in shared memory.
template <typename F>
__device__ __forceinline__ void each_in_keys(const u64* buf, int n, F&& f) {
  const int lane = threadIdx.x & 31;
  for (int base = threadIdx.x - lane; base < n; base += SEED_THREADS) {
    const bool ok = base + lane < n;
    f(ok ? buf[base + lane] : 0ull, ok);
  }
}

// Warp-collective: the lanes with ``in`` append u to dst at *n (at most
// lim keys are kept).
__device__ __forceinline__ void append_key(u64 u, bool in, u64* dst, int* n, int lim) {
  const int lane = threadIdx.x & 31;
  const unsigned bal = __ballot_sync(FULL, in);
  if (bal == 0u) return;
  int at = 0;
  if (lane == 0) at = atomicAdd(n, __popc(bal));
  at = __shfl_sync(FULL, at, 0) + __popc(bal & ((1u << lane) - 1u));
  if (in && at < lim) dst[at] = u;
}

// The need-th largest of ``each``'s keys, continuing a select whose
// high-word digits so far are (prefix, mask, shift) with cnt keys under
// them: 12-bit passes over the high word, then over the low word of the
// keys that share the high word, until the boundary bin holds one key,
// which one more read finds.
template <typename Each>
__device__ u64 merge_select(Each each, int need, int cnt, uint32_t prefix, uint32_t mask,
                            int shift, MergeSmem& sm) {
  auto high = [&](auto&& f) { each([&](u64 u, bool ok) { f((uint32_t)(u >> 32), ok); }); };
  while (shift > 0 && cnt > 1) seed_pass(high, prefix, mask, need, shift, cnt, sm.seed);
  const uint32_t hword = prefix, hmask = mask;
  const bool low = cnt > 1;  // every high bit fixed, and cnt keys share them
  if (low) {
    prefix = 0;
    mask = 0;
    shift = 32;
    auto lowf = [&](auto&& f) {
      each([&](u64 u, bool ok) { f((uint32_t)u, ok && (uint32_t)(u >> 32) == hword); });
    };
    while (shift > 0 && cnt > 1) seed_pass(lowf, prefix, mask, need, shift, cnt, sm.seed);
    if (shift == 0) return ((u64)hword << 32) | prefix;
  }
  each([&](u64 u, bool ok) {
    const uint32_t h = (uint32_t)(u >> 32);
    const bool at = low ? h == hword && ((uint32_t)u & mask) == prefix : (h & hmask) == hword;
    if (ok && at) sm.found = u;
  });
  __syncthreads();
  const u64 key = sm.found;
  __syncthreads();  // read before another select writes it
  return key;
}

// One compare-exchange of a bitonic network: of keys x and y (y the one
// ``stride`` away in the network), the larger stays at the lower index of
// a descending block.
__device__ __forceinline__ u64 bitonic_keep(u64 x, u64 y, bool lower, bool desc) {
  return lower == desc ? (x > y ? x : y) : (x < y ? x : y);
}

// The 32 keys of a warp (x at its lane) sorted descending by a bitonic
// network, every step a shuffle.
__device__ __forceinline__ u64 warp_sort32(u64 x, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
    const bool desc = (lane & size) == 0;  // the last stage: every lane
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1)
      x = bitonic_keep(x, __shfl_xor_sync(FULL, x, stride), (lane & stride) == 0, desc);
  }
  return x;
}

constexpr int MERGE_ITEMS = 4;  // outputs a thread merges a round

// keys[0, n) sorted descending (n a power of two, at least 32), using tmp
// [n]: each warp sorts runs of 32 in registers, then rounds of merges
// double the runs. In a round each thread writes MERGE_ITEMS outputs of a
// pair of runs: a binary search on its diagonal finds how many of them
// come from the first run (merge path), then a sequential merge. Returns
// the buffer that holds the result.
__device__ u64* sort_desc(u64* keys, u64* tmp, int n) {
  const int t = threadIdx.x;
  for (int i = t; i < n; i += SEED_THREADS) keys[i] = warp_sort32(keys[i], t & 31);
  u64 *src = keys, *dst = tmp;
  for (int run = 32; run < n; run <<= 1) {
    __syncthreads();
    for (int o = t * MERGE_ITEMS; o < n; o += SEED_THREADS * MERGE_ITEMS) {
      const int d = o & (2 * run - 1);  // the diagonal within the pair
      const u64* a = src + (o - d);
      const u64* b = a + run;
      int lo = max(0, d - run), hi = min(d, run);
      while (lo < hi) {  // a[mid] is among the pair's first d outputs?
        const int mid = (lo + hi) >> 1;
        if (a[mid] >= b[d - 1 - mid])
          lo = mid + 1;
        else
          hi = mid;
      }
      int i = lo, j = d - lo;
      u64 va = i < run ? a[i] : 0ull, vb = j < run ? b[j] : 0ull;
#pragma unroll
      for (int e = 0; e < MERGE_ITEMS; ++e) {
        if (j >= run || (i < run && va >= vb)) {  // the first run's key first on ties
          dst[o + e] = va;
          va = ++i < run ? a[i] : 0ull;
        } else {
          dst[o + e] = vb;
          vb = ++j < run ? b[j] : 0ull;
        }
      }
    }
    u64* x = src;
    src = dst;
    dst = x;
  }
  __syncthreads();
  return src;
}

// Block blockIdx.x owns ranks [lo, hi) of query blockIdx.x / n_slices.
// Shared memory (merge_smem_bytes): MergeSmem, the staging buffer
// (stage_cap = min(cap, MERGE_STAGE) keys staged, at least ``slots``
// long), then ``slots`` keys of the slice.
__global__ void __launch_bounds__(SEED_THREADS, 2) merge_topk_kernel(
    const long long* __restrict__ cand, const int* __restrict__ count, float* __restrict__ out_s,
    int* __restrict__ out_i, int k, int cap, int slice, int n_slices, int stage_cap,
    int slots) {
  extern __shared__ __align__(16) uint8_t dsm[];
  MergeSmem& sm = *reinterpret_cast<MergeSmem*>(dsm);
  u64* stage = reinterpret_cast<u64*>(dsm + MERGE_HEAD);
  u64* keys = stage + max(stage_cap, slots);
  const int t = threadIdx.x;
  const int qi = blockIdx.x / n_slices, r = blockIdx.x % n_slices;
  const long long* row = cand + (size_t)qi * cap;
  const int c = min(count[qi], cap);
  const int lo = r * slice, hi = min(k, lo + slice);
  const int hi_live = min(hi, c), m = max(hi_live - lo, 0);
  int path = MP_FILL;
  if (m > 0) {
    if (t == 0) {
      sm.n_buf = 0;
      sm.n_sel = 0;
    }
    __syncthreads();
    const bool upper = lo > 0, lower = hi_live < c;  // which boundaries bound the slice
    u64 ukey = ~0ull, lkey = 0ull;
    auto global = [row, c](auto&& f) { each_in_cand(row, c, f); };
    if (!upper && !lower) {
      path = MP_WHOLE;
    } else if (c <= stage_cap) {
      path = MP_STAGED;
      each_in_cand(row, c, [&](u64 u, bool ok) { append_key(u, ok, stage, &sm.n_buf, stage_cap); });
      __syncthreads();
      auto shared = [stage, c](auto&& f) { each_in_keys(stage, c, f); };
      if (upper) ukey = merge_select(shared, lo + 1, c, 0u, 0u, 32, sm);
      if (lower) lkey = merge_select(shared, hi_live, c, 0u, 0u, 32, sm);
    } else {
      path = MP_BIN;
      // the top digit of both boundaries from one read of the row
      for (int i = t; i < SEED_BINS; i += SEED_THREADS) sm.seed.hist[i] = 0;
      __syncthreads();
      each_in_cand(row, c, [&](u64 u, bool ok) {
        if (ok) atomicAdd(&sm.seed.hist[(uint32_t)(u >> (64 - SEED_BITS))], 1u);
      });
      __syncthreads();
      constexpr int SH = 32 - SEED_BITS;
      uint32_t pre[2] = {0u, 0u}, msk[2] = {0u, 0u};
      int need[2] = {lo + 1, hi_live}, cnt[2] = {0, 0};
      const bool want[2] = {upper, lower};
      for (int j = 0; j < 2; ++j)
        if (want[j]) seed_boundary(SH, SEED_BINS - 1, pre[j], msk[j], need[j], cnt[j], sm.seed);
      for (int j = 0; j < 2; ++j) {
        if (!want[j]) continue;
        u64 key;
        if (cnt[j] <= stage_cap) {
          if (t == 0) sm.n_buf = 0;
          __syncthreads();
          const uint32_t p = pre[j], mk = msk[j];
          each_in_cand(row, c, [&](u64 u, bool ok) {
            append_key(u, ok && ((uint32_t)(u >> 32) & mk) == p, stage, &sm.n_buf, stage_cap);
          });
          __syncthreads();
          const int nb = cnt[j];
          key = merge_select([stage, nb](auto&& f) { each_in_keys(stage, nb, f); }, need[j], nb,
                             pre[j], msk[j], SH, sm);
        } else {
          path = MP_GLOBAL;
          key = merge_select(global, need[j], cnt[j], pre[j], msk[j], SH, sm);
        }
        (j == 0 ? ukey : lkey) = key;
      }
    }
    // the slice: the keys from the lower boundary to the upper one
    auto in_slice = [&](u64 u, bool ok) {
      append_key(u, ok && u >= lkey && u <= ukey, keys, &sm.n_sel, m);
    };
    if (path == MP_STAGED)
      each_in_keys(stage, c, in_slice);
    else
      each_in_cand(row, c, in_slice);
    int pc = 32;
    while (pc < m) pc <<= 1;
    for (int i = m + t; i < pc; i += SEED_THREADS) keys[i] = 0ull;
    __syncthreads();
    keys = sort_desc(keys, stage, pc);
  }
  float* os = out_s + (size_t)qi * k + lo;
  int* oi = out_i + (size_t)qi * k + lo;
  for (int j = t; j < hi - lo; j += SEED_THREADS) {
    float s = NEG_INF;
    int idx = 0;
    if (j < m) {
      const u64 u = keys[j];
      s = from_ord_u32((uint32_t)(u >> 32));
      idx = (int)(0xFFFFFFFFu - (uint32_t)u);
    }
    os[j] = s;
    oi[j] = idx;
  }
  if (t == 0) atomicAdd(&merge_path_blocks[path], 1u);
}

// --------------------------------------------------------------- bin_max
//
// The PartialReduce step of jax.lax.approx_max_k (arXiv 2206.14286), which
// gorse_tpu/ops/topk.py dot_topk_approx (:860) and sq_topk_approx (:903)
// run on the scores of a query batch: the N items fall into L strided bins,
// item j into bin j mod L, and each query keeps each bin's maximum. The
// result is the maximum key (score descending, index ascending) of every
// (query, bin), [b_pad, L] int64 in candidate order; a bin with no item
// below n_items holds INT64_MIN. merge_topk takes the top k of the L keys.
// It replaces no Pallas kernel: on the TPU the reduction is one XLA op that
// the hardware runs, and the [B, N] score matrix never exists; here it
// never exists either.
//
// Bound on this card: one table stream (1M x 64 bf16: 128 MB, ~38 us at
// 3.35 TB/s) against the dots (33.6 GFLOP at 256 queries, ~34 us on the bf16
// tensor cores), plus the keys written once (256 x L x 8 bytes: 2 MB at
// L = 1,024, 64 MB at L = 31,360).
//
// Design: view the items as rows of L, row r holding items r L + [0, L).
// A work unit is a chunk of BIN_W = 64 bins and a range of rows; the plan
// of units comes from ops/topk.py bin_plan, one (bin0, r_lo, r_hi) triple
// each, and a persistent grid walks it (block b takes units b, b + grid,
// ...). A block holds all of the launch's queries (up to 256) resident in
// shared memory, so each item slab (64 items r L + bin0 + [0, 64), 64
// dimensions) is staged once a launch:
// - a producer warpgroup, one thread of it at work, keeps a ring of
//   BIN_STAGES slabs in flight by TMA, one mbarrier per stage for "full"
//   (the transaction bytes landed) and one for "empty" (every consumer warp
//   is done with it); the loop has no __syncthreads;
// - two consumer warpgroups, 128 queries each, score a slab in two query
//   halves of 64, each four wgmma m64n64k16 (items on M, queries on N; A and
//   B K-major in shared memory with the 128-byte swizzle that TMA writes).
//   The uint8 table's codes (0-255, exact in bf16) are converted in
//   registers and fed as the A fragment, so no converted copy is staged;
// - a half's 64 x 64 products sit in 32 registers a thread; each thread
//   keeps its 64 slots' running maxima and winning rows in 128 more
//   (setmaxnreg gives the consumers 232 registers and the producer 40).
//   Rows are taken in ascending order and a score replaces the maximum only
//   when larger, so equal scores keep the lower index. The fold is four
//   instructions a score: +0 (a sum of -0 products reads +0, as the plain
//   sum from +0 does), one comparison as 0/1, max, and one FMA on the
//   winner's row kept relative to the current one.
// At the end of a unit each (query, bin) key goes to the output: a plain
// store where the unit owns its bins' every row (the wrapper then allocates
// the keys with torch.empty: no fill, no atomic), a 64-bit atomicMax over
// INT64_MIN-filled keys where the plan splits rows over several units. A
// thread's stores for one register run along 8 consecutive bins of 4
// queries: 64-byte runs, whole 32-byte sectors. Items past n_items (and
// rows past the table, which TMA fills with zeros) never count.
// Tables wider than 128 dimensions carry each slab's 64-dimension query pass
// in its stage (the queries stream from L2 beside the items), staged once
// for each query half.
// What bounds it: the consumer warps' latency. A warp's half waits for its
// four products, then folds 32 scores (the comparison and the max at half
// rate), so neither the tensor cores nor the memory stream stays busy.
// Running a half's products under the previous half's fold (two
// accumulators) measured no faster; across rows, with the accumulator in
// flight over the loop, ptxas serialized the wgmma.
constexpr int BIN_W = 64;                 // bins a unit owns: the wgmma tile's M
constexpr int BIN_QRES = 2;               // passes whose queries stay resident
constexpr int BIN_STAGES = 8;             // ring depth with resident queries
constexpr int BIN_STAGES_WIDE = 4;        // ... when a stage carries its query pass
constexpr int BIN_THREADS = 384;          // two consumer warpgroups, one producer
constexpr int BIN_QBYTES = QSLICE * 128;  // one 64-dimension pass of 256 queries
constexpr int BIN_PRODUCER_REGS = 40;    // setmaxnreg: the producer warpgroup gives
constexpr int BIN_CONSUMER_REGS = 232;   // registers to the consumers' running maxima

// byte offsets into the 1024-aligned dynamic shared memory
struct BinLayout {
  int n_pass, resident, n_stages, stage_bits, slab, stage, ring, stats, bars, total;
};

template <typename T>
__host__ __device__ inline BinLayout bin_layout(int d_pad) {
  BinLayout l;
  l.n_pass = d_pad / DC;
  l.resident = l.n_pass <= BIN_QRES;
  l.n_stages = l.resident ? BIN_STAGES : BIN_STAGES_WIDE;  // powers of two
  l.stage_bits = l.resident ? 3 : 2;
  l.slab = BIN_W * DC * (int)sizeof(T);
  l.stage = l.slab + (l.resident ? 0 : BIN_QBYTES);  // [query pass][slab]
  l.ring = l.resident ? l.n_pass * BIN_QBYTES : 0;
  l.stats = l.ring + l.n_stages * l.stage;  // qsum[256], q2[256]
  l.bars = l.stats + 2 * QSLICE * 4;        // full[8], empty[8], the queries'
  l.total = l.bars + (2 * BIN_STAGES + 1) * 8;
  return l;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// until the phase of parity ``parity`` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
}

// the box at (c0, c1) of a 2D tensor map into shared memory, completing
// its bytes on ``bar``
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma's shared-memory operand: K-major rows of 128 bytes, 8-row groups
// 1,024 bytes apart, the 128-byte swizzle; + 2 per 16-element k step
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

// keeps the compiler from moving reads or writes of an operand of an
// asynchronous wgmma across the fences around it
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// D[64 items][64 queries] (+)= A[64][16] B[16][64] on the tensor cores, B
// (and A for wgmma_ss) in shared memory, K-major with the 128-byte swizzle;
// ``add`` 0 overwrites D.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(add));
}

// A from registers: the warpgroup's m64k16 fragment (warp w holds rows
// 16 w + [0, 16), laid out as mma.sync's m16n8k16 A fragment)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                         int add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(add));
}

// The A fragment of k step ks from a raw [64][64] code slab (64-byte rows,
// unswizzled): rows 16 w + g and + 8, dimensions 16 ks + 2 tq + {0, 1} and
// + 8, each pair of codes as a bf16 pair. A 16-byte load a row (no bank
// conflict: a quarter warp reads two rows).
__device__ __forceinline__ void code_frag(const uint8_t* slab, int w, int g, int tq, int ks,
                                          uint32_t (&a)[4]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint4 v = *reinterpret_cast<const uint4*>(slab + (16 * w + g + 8 * h) * DC + 16 * ks);
    const uint32_t lo = (tq & 2) ? v.y : v.x, hi = (tq & 2) ? v.w : v.z;
    a[h] = bf16x2_of_codes(lo, 2 * (tq & 1));
    a[2 + h] = bf16x2_of_codes(hi, 2 * (tq & 1));
  }
}

// 1.0f unless x beats m (NaN never does): one comparison, its result as f32
__device__ __forceinline__ float keep_of(float x, float m) {
  float k;
  asm("set.leu.f32.f32 %0, %1, %2;\n" : "=f"(k) : "f"(x), "f"(m));
  return k;
}

template <typename T>
__global__ void __launch_bounds__(BIN_THREADS, 1) bin_max_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap tmap,
    Affine af, long long* __restrict__ out, const int* __restrict__ units, int n_units, int q0,
    int nq, int d_pad, int n_items, int n_pad, int n_bins, int merge) {
  constexpr bool codes = sizeof(T) == 1;
  extern __shared__ uint8_t bin_smem[];
  uint8_t* sm = bin_smem + ((1024 - (smem_u32(bin_smem) & 1023)) & 1023);  // 1,024-aligned
  const BinLayout lay = bin_layout<T>(d_pad);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + lay.bars);
  uint64_t* empty = full + BIN_STAGES;
  uint64_t* qbar = empty + BIN_STAGES;
  const int wg = threadIdx.x >> 7, n_cwg = nq > 128 ? 2 : 1;
  // a row's slabs in ring order: its passes, read by both query halves;
  // streamed queries: the passes again for the second half
  const int n_seq = lay.resident ? lay.n_pass : 2 * lay.n_pass;
  if (threadIdx.x == 0) {
    for (int s = 0; s < lay.n_stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4 * n_cwg);  // one arrival a consumer warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(BIN_PRODUCER_REGS));
    if (threadIdx.x != 256) return;
    if (lay.resident) {
      mbar_expect_tx(qbar, lay.n_pass * BIN_QBYTES);
      for (int p = 0; p < lay.n_pass; ++p) tma_load(sm + p * BIN_QBYTES, &qmap, qbar, p * DC, q0);
    }
    uint32_t it = 0;  // slabs staged
    for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
      const int bin0 = units[3 * u], r_lo = units[3 * u + 1], r_hi = units[3 * u + 2];
      for (int r = r_lo; r < r_hi; ++r)
        for (int k = 0; k < n_seq; ++k, ++it) {
          const int s = it & (lay.n_stages - 1), p = k % lay.n_pass;
          mbar_wait(empty + s, ((it >> lay.stage_bits) & 1) ^ 1);  // round 0: the ring is empty
          uint8_t* st = sm + lay.ring + s * lay.stage;
          mbar_expect_tx(full + s, lay.stage);
          if (!lay.resident) tma_load(st, &qmap, full + s, p * DC, q0);
          tma_load(st + lay.stage - lay.slab, &tmap, full + s, p * DC, r * n_bins + bin0);
        }
    }
    return;
  }
  // ------------------------------------------------------ consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(BIN_CONSUMER_REGS));
  if (wg >= n_cwg) return;
  const int t = threadIdx.x & 127, w = t >> 5, lane = t & 31, g = lane >> 2, tq = lane & 3;
  const int qw = wg * 128;  // the warpgroup's first query of the launch
  float* s_qsum = reinterpret_cast<float*>(sm + lay.stats);
  float* s_q2 = s_qsum + QSLICE;
  if constexpr (codes) {
    s_qsum[qw + t] = qw + t < nq ? af.qsum[qw + t] : 0.0f;
    s_q2[qw + t] = qw + t < nq ? af.q2[qw + t] : 0.0f;
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  }
  if (lay.resident) mbar_wait(qbar, 0);

  // acc: the products of one query half (queries qw + 64 hf + [0, 64)) with
  // a slab. Slot b = 32 hf + i: best the maximum, lag its row less the
  // current row (an integer in f32), so a row updates it with one FMA.
  float acc[32], best[64], lag[64];
  uint32_t it = 0;  // slabs consumed
  // half hf of the row at ring position row_it into acc, pass by pass, each
  // stage released after its last reader's products complete
  auto products = [&](auto hf_c, uint32_t row_it) {
    constexpr int hf = decltype(hf_c)::value;
    for (int p = 0; p < lay.n_pass; ++p) {
      const uint32_t at = row_it + (lay.resident ? p : hf * lay.n_pass + p);
      const int s = at & (lay.n_stages - 1);
      if (hf == 0 || !lay.resident) mbar_wait(full + s, (at >> lay.stage_bits) & 1);
      const uint8_t* st = sm + lay.ring + s * lay.stage;
      const uint64_t bdesc =
          sw128_desc((lay.resident ? sm + p * BIN_QBYTES : st) + (qw + 64 * hf) * 128);
      const uint8_t* slab = st + lay.stage - lay.slab;
      if constexpr (!codes) {
        const uint64_t adesc = sw128_desc(slab);
        fence_regs(acc);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int ks = 0; ks < DC / 16; ++ks) wgmma_ss(acc, adesc + 2 * ks, bdesc + 2 * ks, p + ks);
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      } else {
        uint32_t a[DC / 16][4];  // written before the fence, live until the wait
#pragma unroll
        for (int ks = 0; ks < DC / 16; ++ks) code_frag(slab, w, g, tq, ks, a[ks]);
        fence_regs(acc);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int ks = 0; ks < DC / 16; ++ks) wgmma_rs(acc, a[ks], bdesc + 2 * ks, p + ks);
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
        for (int ks = 0; ks < DC / 16; ++ks) fence_regs(a[ks]);
      }
      fence_regs(acc);
      if (hf == 1 || !lay.resident) {  // the stage's last reader
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + s);
      }
    }
  };

  for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
    const int bin0 = units[3 * u], r_lo = units[3 * u + 1], r_hi = units[3 * u + 2];
#pragma unroll
    for (int b = 0; b < 64; ++b) {
      best[b] = __int_as_float(0xff800000);  // -inf: any item beats it
      lag[b] = 0.0f;
    }
    for (int r = r_lo; r < r_hi; ++r, it += n_seq) {
      // the thread's items: bins bin0 + 16 w + g (h = 0) and + 8 (h = 1)
      const long long item0 = (long long)r * n_bins + bin0 + 16 * w + g;
      const bool whole = bin0 + BIN_W <= n_bins && (long long)r * n_bins + bin0 + BIN_W <= n_items;
      bool ok[2];
      float scale[2], minv[2], n2[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        ok[h] = bin0 + 16 * w + g + 8 * h < n_bins && item0 + 8 * h < n_items;
        if constexpr (codes) {
          const long long at = item0 + 8 * h;
          const size_t idx = (size_t)(at < n_pad - 1 ? at : n_pad - 1);
          scale[h] = __ldg(af.affine + idx);
          minv[h] = __ldg(af.affine + af.n_pad + idx);
          n2[h] = __ldg(af.affine + 2 * (size_t)af.n_pad + idx);
        }
      }
      // fold half hf of row r: acc[4 j + e] is item h = e / 2, query
      // qw + 64 hf + 8 j + 2 tq + e % 2
      auto fold = [&](auto hf_c) {
        constexpr int hf = decltype(hf_c)::value;
        auto each = [&](auto masked) {
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int h = (i >> 1) & 1, b = 32 * hf + i;
            float x = __fadd_rn(acc[i], 0.0f);  // -0 reads +0, as the plain sum from +0
            if constexpr (codes) {
              // gorse_tpu/ops/topk.py _block_scores (:353-357): raw * scale +
              // qsum * minv, for euclidean 2 * that - norms2 - q2, each rounded
              const int qi = qw + 64 * hf + 8 * (i >> 2) + 2 * tq + (i & 1);
              const float d = __fadd_rn(__fmul_rn(x, scale[h]), __fmul_rn(s_qsum[qi], minv[h]));
              x = af.euclid ? __fsub_rn(__fsub_rn(__fmul_rn(2.0f, d), n2[h]), s_q2[qi]) : d;
            }
            if (decltype(masked)::value && !ok[h]) x = __int_as_float(0xff800000);
            const float keep = keep_of(x, best[b]);
            best[b] = fmaxf(best[b], x);
            lag[b] = __fmaf_rn(keep, lag[b], -keep);  // 0 where x won, else one less
          }
        };
        if (whole)
          each(std::false_type{});
        else
          each(std::true_type{});
      };
      products(std::integral_constant<int, 0>{}, it);
      fold(std::integral_constant<int, 0>{});
      products(std::integral_constant<int, 1>{}, it);
      fold(std::integral_constant<int, 1>{});
    }
    // the unit's keys: slot b is bin bin0 + 16 w + g (+ 8), query
    // qw + 64 (b / 32) + 8 (b % 32 / 4) + 2 tq + b % 2
#pragma unroll
    for (int b = 0; b < 64; ++b) {
      const int i = b & 31;
      const int bin = bin0 + 16 * w + g + 8 * ((i >> 1) & 1);
      const int qi = qw + 64 * (b >> 5) + 8 * (i >> 2) + 2 * tq + (i & 1);
      if (bin < n_bins && qi < nq) {
        long long* o = out + (size_t)qi * n_bins + bin;
        if (best[b] != __int_as_float(0xff800000)) {
          const int row = r_hi - 1 + (int)lag[b];
          const long long key = (long long)(make_key(best[b], row * n_bins + bin) ^ SIGN64);
          if (merge)
            atomicMax(o, key);
          else
            *o = key;
        } else if (!merge) {
          *o = (long long)SIGN64;  // INT64_MIN: no item in the bin
        }
      }
    }
  }
}

// A persistent grid: as many blocks as fit on the card at once, at most
// one per item block.
template <typename K>
int persistent_grid(K kernel, int smem, int n_blocks) {
  int dev = 0, n_sm = 0, occ = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, THREADS, smem);
  return max(1, min(n_blocks, max(occ, 1) * n_sm));
}

template <typename T>
int launch_block_max(const void* q, const void* table, const void* affine, const void* qstats,
                     void* bmax, void* gmax, int b_pad, int d_pad, int n_items, int n_blocks,
                     int euclid, cudaStream_t stream) {
  const size_t n_groups = (size_t)n_blocks * (BLOCK_N / GROUP);
  for (int s = 0; s < b_pad; s += QSLICE) {
    const int nq = min(QSLICE, b_pad - s);
    const int smem = score_smem_bytes<T>(nq, d_pad) + 4 * RQ * 4 +
                     (gmax != nullptr ? RQ * GSTRIDE * 4 : 0);
    const Affine af{(const float*)affine, qstats ? (const float*)qstats + s : nullptr,
                    qstats ? (const float*)qstats + b_pad + s : nullptr, n_blocks * BLOCK_N,
                    euclid};
    const int grid = persistent_grid(block_max_kernel<T>, smem, n_blocks);
    block_max_kernel<T><<<grid, THREADS, smem, stream>>>(
        (const __nv_bfloat16*)q + (size_t)s * d_pad, (const T*)table, af,
        (float*)bmax + (size_t)s * n_blocks, gmax ? (float*)gmax + s * n_groups : nullptr, nq,
        d_pad, n_items, n_blocks);
    const int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
  }
  return 0;
}

template <typename T>
int launch_block_topk(const void* q, const void* table, const void* affine, const void* qstats,
                      const void* bmax, const void* seeds, void* cand, void* count, int b,
                      int b_pad, int d_pad, int n_items, int n_blocks, int k, int cap, int euclid,
                      cudaStream_t stream) {
  for (int s = 0; s < b; s += QSLICE) {
    const int nq = min(QSLICE, b_pad - s);
    const int smem = score_smem_bytes<T>(nq, d_pad) +
                     (RQ * SSTRIDE + WIN * (QSLICE / 32) + QSLICE + WIN + WARPS) * 4;
    const Affine af{(const float*)affine, qstats ? (const float*)qstats + s : nullptr,
                    qstats ? (const float*)qstats + b_pad + s : nullptr, n_blocks * BLOCK_N,
                    euclid};
    const int grid = persistent_grid(block_topk_kernel<T>, smem, n_blocks);
    block_topk_kernel<T><<<grid, THREADS, smem, stream>>>(
        (const __nv_bfloat16*)q + (size_t)s * d_pad, (const T*)table, af,
        bmax ? (const float*)bmax + (size_t)s * n_blocks : nullptr,
        seeds ? (const float*)seeds + s : nullptr, (long long*)cand + (size_t)s * cap,
        (int*)count + s, nq, min(QSLICE, b - s), d_pad, n_items, n_blocks, k, cap);
    const int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
  }
  return 0;
}


// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no -lcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// a row-major [rows, cols] table read in boxes of 64 columns by box_rows
// rows: bf16 with the 128-byte swizzle that wgmma reads, uint8 as it lies
bool tile_map(CUtensorMap* map, const void* base, bool bf16, int rows, int cols, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * (bf16 ? 2 : 1)};
  const cuuint32_t box[2] = {(cuuint32_t)DC, (cuuint32_t)box_rows}, step[2] = {1, 1};
  return encode(map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                const_cast<void*>(base), dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                bf16 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// One launch over queries q0 .. q0 + nq - 1 (nq <= 256) of the plan's
// ``n_units`` units (int32 triples) on ``grid`` blocks; ``merge``: keys are
// INT64_MIN-filled and combined by atomicMax, else stored.
template <typename T>
int launch_bin_max(const void* q, const void* table, const void* affine, const void* qstats,
                   void* out, const void* units, int n_units, int grid, int merge, int q0, int nq,
                   int b_pad, int d_pad, int n_items, int n_pad, int n_bins, int euclid,
                   cudaStream_t stream) {
  if (n_bins < 1 || n_items < 1 || n_items > n_pad || n_units < 1 || grid < 1 || nq < 1 ||
      nq > QSLICE || q0 < 0 || q0 + nq > b_pad || d_pad % DC != 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap qmap, tmap;
  if (!tile_map(&qmap, q, true, b_pad, d_pad, QSLICE) ||
      !tile_map(&tmap, table, sizeof(T) == 2, n_pad, d_pad, BIN_W))
    return (int)cudaErrorNotSupported;
  const Affine af{(const float*)affine, qstats ? (const float*)qstats + q0 : nullptr,
                  qstats ? (const float*)qstats + b_pad + q0 : nullptr, n_pad, euclid};
  const int smem = bin_layout<T>(d_pad).total + 1024;  // + the 1,024-byte alignment
  // over 48 KB of dynamic shared memory needs the attribute: set once a
  // device, to the most either layout takes
  static unsigned long long opted = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && !((opted >> dev) & 1ull)) {
    const int most =
        max(bin_layout<T>(BIN_QRES * DC).total, bin_layout<T>((BIN_QRES + 1) * DC).total);
    const cudaError_t e = cudaFuncSetAttribute(
        bin_max_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, most + 1024);
    if (e != cudaSuccess) return (int)e;
    opted |= 1ull << dev;
  }
  bin_max_kernel<T><<<grid, BIN_THREADS, smem, stream>>>(
      qmap, tmap, af, (long long*)out + (size_t)q0 * n_bins, (const int*)units, n_units, q0, nq,
      d_pad, n_items, n_pad, n_bins, merge);
  return (int)cudaGetLastError();
}

}  // namespace

// ------------------------------------------------------------ C entries
// Each returns cudaGetLastError() after its launches; the Python wrapper
// raises when it is not 0. Launches go on the caller's stream.

extern "C" int gt_block_max(const void* q, const void* table, void* bmax, void* gmax, int b_pad,
                            int d_pad, int n_items, int n_blocks, void* stream) {
  return launch_block_max<__nv_bfloat16>(q, table, nullptr, nullptr, bmax, gmax, b_pad, d_pad,
                                         n_items, n_blocks, 0, (cudaStream_t)stream);
}

extern "C" int gt_block_max_sq(const void* q, const void* codes, const void* affine,
                               const void* qstats, void* bmax, void* gmax, int b_pad, int d_pad,
                               int n_items, int n_blocks, int euclid, void* stream) {
  return launch_block_max<uint8_t>(q, codes, affine, qstats, bmax, gmax, b_pad, d_pad, n_items,
                                   n_blocks, euclid, (cudaStream_t)stream);
}

extern "C" int gt_block_seeds(const void* bmax, void* seeds, void* fired, int b, int n_blocks,
                              int k, void* stream) {
  if (k < 1 || b < 1) return (int)cudaErrorInvalidValue;
  block_seeds_kernel<<<b, SEED_THREADS, seed_smem_bytes(), (cudaStream_t)stream>>>(
      (const float*)bmax, (float*)seeds, (int*)fired, n_blocks, k);
  return (int)cudaGetLastError();
}

// The rows that took each branch of block_seeds' select on the current
// device since the last call, into ``rows`` [SEED_BRANCHES]; clears them.
// Synchronous: call it after the launches it should see have finished.
extern "C" int gt_block_seeds_branches(unsigned int* rows) {
  static const unsigned int zero[SEED_BRANCHES] = {};
  cudaError_t e = cudaMemcpyFromSymbol(rows, seed_branch_rows, sizeof(zero));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(seed_branch_rows, zero, sizeof(zero));
  return (int)e;
}

extern "C" int gt_block_topk(const void* q, const void* table, const void* bmax,
                             const void* seeds, void* cand, void* count, int b, int b_pad,
                             int d_pad, int n_items, int n_blocks, int k, int cap, void* stream) {
  return launch_block_topk<__nv_bfloat16>(q, table, nullptr, nullptr, bmax, seeds, cand, count, b,
                                          b_pad, d_pad, n_items, n_blocks, k, cap, 0,
                                          (cudaStream_t)stream);
}

extern "C" int gt_block_topk_sq(const void* q, const void* codes, const void* affine,
                                const void* qstats, const void* bmax, const void* seeds,
                                void* cand, void* count, int b, int b_pad, int d_pad,
                                int n_items, int n_blocks, int k, int cap, int euclid,
                                void* stream) {
  return launch_block_topk<uint8_t>(q, codes, affine, qstats, bmax, seeds, cand, count, b, b_pad,
                                    d_pad, n_items, n_blocks, k, cap, euclid,
                                    (cudaStream_t)stream);
}

extern "C" int gt_merge_topk(const void* cand, const void* count, void* out_s, void* out_i,
                             int b, int k, int cap, int slice, void* stream) {
  if (b < 1 || k < 1 || cap < 0 || slice < 1 || slice > MERGE_SLICE)
    return (int)cudaErrorInvalidValue;
  const int n_slices = (k - 1) / slice + 1;
  if ((long long)b * n_slices > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  // over 48 KB of dynamic shared memory needs the attribute: set once a
  // device, to the most any launch takes
  static unsigned long long opted = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && !((opted >> dev) & 1ull)) {
    const cudaError_t e = cudaFuncSetAttribute(merge_topk_kernel,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               merge_smem_bytes(MERGE_STAGE, MERGE_SLICE));
    if (e != cudaSuccess) return (int)e;
    opted |= 1ull << dev;
  }
  const int stage_cap = min(cap, MERGE_STAGE);
  int slots = 32;
  while (slots < min(slice, k)) slots <<= 1;
  merge_topk_kernel<<<b * n_slices, SEED_THREADS, merge_smem_bytes(stage_cap, slots),
                      (cudaStream_t)stream>>>((const long long*)cand, (const int*)count,
                                              (float*)out_s, (int*)out_i, k, cap, slice,
                                              n_slices, stage_cap, slots);
  return (int)cudaGetLastError();
}

// The blocks of merge_topk that took each path on the current device since
// the last call, into ``blocks`` [MERGE_PATHS]; clears them. Synchronous.
extern "C" int gt_merge_topk_paths(unsigned int* blocks) {
  static const unsigned int zero[MERGE_PATHS] = {};
  cudaError_t e = cudaMemcpyFromSymbol(blocks, merge_path_blocks, sizeof(zero));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(merge_path_blocks, zero, sizeof(zero));
  return (int)e;
}

extern "C" int gt_bin_max(const void* q, const void* table, void* out, const void* units,
                          int n_units, int grid, int merge, int q0, int nq, int b_pad, int d_pad,
                          int n_items, int n_pad, int n_bins, void* stream) {
  return launch_bin_max<__nv_bfloat16>(q, table, nullptr, nullptr, out, units, n_units, grid,
                                       merge, q0, nq, b_pad, d_pad, n_items, n_pad, n_bins, 0,
                                       (cudaStream_t)stream);
}

extern "C" int gt_bin_max_sq(const void* q, const void* codes, const void* affine,
                             const void* qstats, void* out, const void* units, int n_units,
                             int grid, int merge, int q0, int nq, int b_pad, int d_pad,
                             int n_items, int n_pad, int n_bins, int euclid, void* stream) {
  return launch_bin_max<uint8_t>(q, codes, affine, qstats, out, units, n_units, grid, merge, q0,
                                 nq, b_pad, d_pad, n_items, n_pad, n_bins, euclid,
                                 (cudaStream_t)stream);
}
