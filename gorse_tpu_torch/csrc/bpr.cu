// The BPR pairwise sweep and the whole BPR epoch, for Hopper (sm_90a).
//
// Replaces the three TPU BPR kernels of gorse_tpu/ops/bpr_kernel.py:
//
//   bpr_epoch                  K1, _epoch_resident_kernel (:329): a whole
//                              epoch in one cooperative launch; each step the
//                              sampled sweep, a grid barrier, the fold
//                              q += delta; delta = 0, a grid barrier
//   bpr_sweep, sampled mode    K2, _fully_fused_kernel (:285): one sweep with
//                              in-kernel sampling
//   bpr_sweep, pairs mode      K3, _fused_kernel (:206): one sweep given
//                              explicit pos / neg / active
//
// All three run one device function, sweep_users. The TPU kernels gather
// and scatter through one-hot matmuls over a 128-lane packed item table,
// because a TPU has no fast gather; Hopper gathers rows natively and
// scatter-adds with atomics, so the table stays row-major [n_items, k] f32
// and a sweep's cost scales with the users, not with the catalog.
//
// The sweep's arithmetic, per active user: the draws of the reference's
// one-device epoch (_sample_pairs, gorse_tpu/models/bpr.py:66-104), built on
// jax.random: ks, kn = split(step key); slot = randint(ks, (U,), 0,
// max(count, 1))[u], candidate t = randint(kn, (U, n_tries), 0,
// n_items)[u, t]. Each warp derives, a step, the two keys each randint
// splits its key into (KEYS below); pos = max(row[slot], 0) (0 past the row's
// max_len entries); the first candidate not in the user's rejection set wins
// (else the first). The rejection set is the capped row
// (the first min(count, max_len) entries), or, given a full-set bitset
// (bits: [n_users, words] uint32, bit c % 32 of word c / 32 set when item c
// is among the user's positives, Dataset.positives_bitset), the user's
// whole positive set, as the reference's single-device epoch under its gate
// (gorse_tpu/models/bpr.py:398-409); the positive comes from the capped row
// either way.
// diff = sum(p*qi) - sum(p*qj) over the sweep's snapshot of q, cost
// softplus(-diff), grad sigmoid(-diff); p_new = p + lr * (grad * (qi - qj) -
// reg * p); adds of lr * (grad * p - reg * qi) into delta[pos] and lr *
// (-grad * p - reg * qj) into delta[neg].
//
// Bound: bytes. At the training shape (138k users x 27k items, k = 64) a
// step reads and writes p (70.7 MB), reads the rows' 1.6M items and the
// counts, gathers and adds into the touched q / delta rows; about 16 flops a
// factor element. What stands between the kernel and that bound, and what
// the design does about it:
// - HOST: an epoch is one launch; its step keys are an [n_steps, 2] device
//   array, so the host does no work between steps.
// - KEYS: a step's four randint keys are two levels of splits of its key,
//   six threefry blocks; each warp computes them on its lanes 0-3 (two
//   dependent blocks deep) and shuffles them to every lane, so the host
//   derives nothing (numpy took 0.35-0.8 ms a launch for it, more than K2
//   itself).
// - RANDINT: jax's randint takes 64 random bits an element, two threefry
//   blocks under two keys, and reduces them modulo the span in uint32 with
//   wrapping products: two blocks for the slot, two a candidate, eight a
//   user a step at n_tries = 3, all in registers.
// - BATCHES: a warp per user would repeat each user's scalar steps on 32
//   lanes and chain them. A warp owns a contiguous range of users and takes
//   them 32 at a time: the count, the draws, the positive, the rejection
//   scan, the hot-slot lookups and the cost run lane-parallel, a user a
//   lane; only what spans a factor row (dots, gradient, payloads) runs a
//   user at a time, on 16 lanes where k <= 64 (PAIRS: two users in one
//   instruction stream).
// - SCAN: against the capped row, the rejection test reads the first
//   min(count, max_len) entries of a row only, not the padded row: past the
//   count a row holds -1 and candidates lie in [0, n_items), so the answer
//   is the same. Its lines are touched once, behind the draws (TOUCH), and
//   read again from L1. BITS: against the full set, a candidate costs one
//   4-byte word of the user's bitset row; a lane issues the words of its
//   first min(n_tries, MAXC) candidates before it tests any, and reads its
//   row at the positive's slot only (no TOUCH).
// - HEAD: the Zipf head's item rows (the hottest takes ~9,000 adds a step
//   at the training shape, all on the same addresses) are staged per thread
//   block in shared memory and flushed with one global add an element.
// - STREAM: p and the padded rows pass through with evict-first hints, so q
//   and delta stay in L2; the bitset's words, scattered 4-byte reads, go
//   through the read-only path (__ldg).
// - VEC: with k a multiple of 4 (2 for k <= 32) and aligned rows, a lane's
//   elements are contiguous and move, and add into delta, as float4/float2.
//
// Where the numbers may differ from the plain versions, and why:
// (1) snapshot semantics: every user of a sweep reads the same q; the sweep
//     never writes q, only delta, and the fold adds delta in between grid
//     barriers. Rows that repeat in a sweep add up instead of chaining, as
//     in gorse_tpu/models/bpr.py:107-121. See SNAPSHOT below.
// (2) summation order: diff is sum(p*qi) - sum(p*qj), the order of the TPU
//     kernels (bpr_kernel.py:123-126), each sum a butterfly over the user's
//     lanes. The plain versions sum in another order: p_new and the cost
//     agree to a tolerance, not bit for bit. See ORDER below.
// (3) atomics: delta rows that many users of a sweep hit take their adds in
//     an order that changes from run to run (and, staged, as partial sums);
//     delta and the cost match the plain version to a tolerance. See ATOMICS.
// (4) transcendentals: expf / log1pf differ from torch's CPU sigmoid and
//     log1p by a few ulps; another reason p_new is held to a tolerance. The
//     sampled pos and neg are exact: their draws are integer arithmetic
//     only. See SAMPLING.
// (5) inactive users (count 0, or active 0): pos = max(row[0], 0) is still
//     written out, but p_out = p, and nothing goes into delta or the cost.
//     See INACTIVE.
//
// mm_dtype bf16: the gathered q rows and the two scatter payloads are
// rounded to bf16 (round to nearest even) where the TPU kernel casts them
// (bpr_kernel.py:213,307,355 and :188-202); everything else stays f32.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int WARPS = 8;  // warps per thread block
constexpr int THREADS = WARPS * 32;
constexpr unsigned FULL = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// 20-round threefry-2x32 of counter (x0, x1) under key (k0, k1).
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t& x0,
                                             uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[8] = {13, 15, 26, 6, 17, 29, 16, 24};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int d = 0; d < 5; ++d) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl32(x1, rot[(d % 2) * 4 + j]) ^ x0;
    }
    x0 += ks[(d + 1) % 3];
    x1 += ks[(d + 2) % 3] + (uint32_t)(d + 1);
  }
}

// jax.random's 32 random bits of element i (the flat index) under key (k0,
// k1): the two words of threefry2x32(key, (hi(i), lo(i))) xor-ed, as with
// jax_threefry_partitionable on
__device__ __forceinline__ uint32_t random_bits(uint32_t k0, uint32_t k1, unsigned long long i) {
  uint32_t x0 = (uint32_t)(i >> 32), x1 = (uint32_t)i;
  threefry2x32(k0, k1, x0, x1);
  return x0 ^ x1;
}

// RANDINT: jax.random.randint's reduction of 64 bits into [0, span): m =
// (2^16 % span)^2 % span, then (hi % span * m + lo % span) % span, every
// product and sum wrapping at 32 bits as in jax (for spans above 2^16, m
// wraps to 0)
__device__ __forceinline__ uint32_t randint_mult(uint32_t span) {
  const uint32_t m = 65536u % span;
  return (m * m) % span;
}

__device__ __forceinline__ uint32_t randint_reduce(uint32_t hi, uint32_t lo, uint32_t span,
                                                   uint32_t mult) {
  return (hi % span * mult + lo % span) % span;
}

// A step's keys: the two keys randint splits ks into (the slot's higher and
// lower bits), then kn's two (the candidates'), two words each
struct StepKey {
  uint32_t w[8];
};

// KEYS: ks, kn = split(step key), then split(ks) and split(kn) (split(k)[i]
// is threefry2x32(k, (0, i))), on every lane of the warp. Lane j computes
// block j & 1 of the first split, then block j & 1 of the split of ks (j <
// 2) or kn (2 <= j < 4); lanes 0-3 hold the four keys. The whole warp must
// call it.
__device__ __forceinline__ StepKey step_keys(uint32_t key0, uint32_t key1) {
  const int lane = threadIdx.x & 31;
  uint32_t x0 = 0u, x1 = (uint32_t)(lane & 1);
  threefry2x32(key0, key1, x0, x1);  // lane 0: ks, lane 1: kn
  const int half = (lane >> 1) & 1;
  const uint32_t h0 = __shfl_sync(FULL, x0, half), h1 = __shfl_sync(FULL, x1, half);
  uint32_t y0 = 0u, y1 = (uint32_t)(lane & 1);
  threefry2x32(h0, h1, y0, y1);
  StepKey key;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    key.w[2 * j] = __shfl_sync(FULL, y0, j);
    key.w[2 * j + 1] = __shfl_sync(FULL, y1, j);
  }
  return key;
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// What the ablate switch skips (cost attribution; results are wrong by
// design, as with the reference's ablate of bpr_epoch_fused)
enum Ablate {
  ABLATE_NONE = 0,
  ABLATE_NOSAMPLE = 1,    // pos = max(row[0], 0), neg = (pos + 37) % n_items
  ABLATE_SAMP_NOPOS = 2,  // pos = max(row[0], 0)
  ABLATE_SAMP_NOREJ = 3,  // neg = the first candidate
  ABLATE_NOGATHER = 4,    // q row 0 stands for both items
  ABLATE_NOSCATTER = 5,   // no delta adds
};

struct SweepArgs {
  const float* p;  // the users' factors read (the epoch: its first step only)
  float* p_out;    // written; the epoch reads and writes it in place after step 0
  float* q;        // read by a sweep; only the epoch's fold writes it
  float* delta;
  float* cost;
  int n_users, k, n_rows;
  // sampled mode
  const int* padded;
  const int* counts;
  int max_len;
  const uint32_t* bits;  // BITS: [n_users, words] full-set bitset; null: reject against the row
  int words;
  uint32_t key0, key1;  // bpr_sweep's step key (bpr_epoch reads its keys from an array)
  int n_items, n_tries;
  int* pos_out;
  int* neg_out;
  // pairs mode
  const int* pos_in;
  const int* neg_in;
  const int* active_in;
  float lr, reg;
  int ablate;
  // HEAD: the staged items (bpr_epoch only; hot_slot null: none)
  const short* hot_slot;  // [n_rows] the item's slot, -1 when not staged
  const int* hot_items;   // [n_hot] slot -> item
  int n_hot;              // slots in use, at most HOT_ITEMS and STAGE_FLOATS / k
};

constexpr int HOT_ITEMS = 64;                   // the staged head: 64 rows (ops/bpr_kernel.py)
constexpr int STAGE_FLOATS = HOT_ITEMS * 64;    // 16 KB: every row to k = 64, fewer above

constexpr int MAXC = 8;  // candidates each lane draws ahead (more are drawn as needed)

// candidate t of user u: element u * n_tries + t of randint(kn, (U, n_tries),
// 0, n_items)
__device__ __forceinline__ int candidate(const StepKey& key, int u, int t, int n_tries,
                                         uint32_t n_items, uint32_t mult) {
  const unsigned long long i = (unsigned long long)u * (unsigned)n_tries + (unsigned)t;
  return (int)randint_reduce(random_bits(key.w[4], key.w[5], i), random_bits(key.w[6], key.w[7], i),
                             n_items, mult);
}

// A user's factor row and the two q rows it gathers, EPL elements a lane of
// the LPU lanes that serve the user: with VEC (k a multiple of the vector,
// every row 16-byte aligned) lane gl owns the contiguous elements
// gl * EPL + i and moves them as float2 / float4; else element gl + LPU * i.
template <int EPL>
struct Rows {
  float p[EPL], qi[EPL], qj[EPL];
};

template <bool VEC, int EPL, int LPU>
__device__ __forceinline__ int elem(int gl, int i) {
  return VEC ? gl * EPL + i : gl + LPU * i;
}

__host__ __device__ constexpr int vec_width(int epl) { return epl == 2 ? 2 : 4; }

// VEC: the chunk of W floats at src into dst (streaming when STREAM)
template <int W, bool STREAM>
__device__ __forceinline__ void load_chunk(const float* src, float* dst) {
  if (W == 2) {
    const float2 v = STREAM ? __ldcs(reinterpret_cast<const float2*>(src))
                            : *reinterpret_cast<const float2*>(src);
    dst[0] = v.x;
    dst[1] = v.y;
  } else {
    const float4 v = STREAM ? __ldcs(reinterpret_cast<const float4*>(src))
                            : *reinterpret_cast<const float4*>(src);
    dst[0] = v.x;
    dst[1] = v.y;
    dst[2] = v.z;
    dst[3] = v.w;
  }
}

template <int W>
__device__ __forceinline__ void store_chunk_cs(float* dst, const float* v) {
  if (W == 2) {
    __stcs(reinterpret_cast<float2*>(dst), make_float2(v[0], v[1]));
  } else {
    __stcs(reinterpret_cast<float4*>(dst), make_float4(v[0], v[1], v[2], v[3]));
  }
}

// sm_90's vector atomics: one add of W floats
template <int W>
__device__ __forceinline__ void add_chunk(float* dst, const float* v) {
  if (W == 2) {
    atomicAdd(reinterpret_cast<float2*>(dst), make_float2(v[0], v[1]));
  } else {
    atomicAdd(reinterpret_cast<float4*>(dst), make_float4(v[0], v[1], v[2], v[3]));
  }
}

template <bool BF16, int EPL, int LPU, bool VEC>
__device__ __forceinline__ void load_rows(const SweepArgs& a, const float* p_in, int u, int pos,
                                          int neg, int gl, Rows<EPL>& r) {
  const int k = a.k;
  const bool gather = a.ablate != ABLATE_NOGATHER;
  const float* prow = p_in + (size_t)u * k;
  const float* qi_row = a.q + (gather ? (size_t)pos * k : 0);
  const float* qj_row = a.q + (gather ? (size_t)neg * k : 0);
#pragma unroll
  for (int i = 0; i < EPL; ++i) r.p[i] = r.qi[i] = r.qj[i] = 0.f;
  if (VEC) {
    constexpr int W = vec_width(EPL);
#pragma unroll
    for (int c = 0; c < EPL; c += W) {
      const int e = gl * EPL + c;
      if (e < k) {
        load_chunk<W, true>(prow + e, r.p + c);  // STREAM
        load_chunk<W, false>(qi_row + e, r.qi + c);
        load_chunk<W, false>(qj_row + e, r.qj + c);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < EPL; ++i) {
      const int e = gl + LPU * i;
      if (e < k) {
        r.p[i] = __ldcs(prow + e);  // STREAM
        r.qi[i] = qi_row[e];
        r.qj[i] = qj_row[e];
      }
    }
  }
  if (BF16) {
#pragma unroll
    for (int i = 0; i < EPL; ++i) {
      r.qi[i] = round_bf16(r.qi[i]);
      r.qj[i] = round_bf16(r.qj[i]);
    }
  }
}

// the sum over the LPU lanes of a group (a butterfly that stays inside it)
template <int LPU>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = LPU / 2; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// One sweep over the users. p_in is the users' factors this sweep reads,
// key0/key1 its step key, pos_out/neg_out (may be null) where its samples
// go; each lane adds its users' costs to warp_cost. stage / touched (shared;
// null without a.hot_slot) take the staged items' payloads.
//
// BATCHES: warp w owns the users [w * per_warp, (w + 1) * per_warp) and takes
// them 32 at a time. What is scalar per user runs lane-parallel, lane j for
// the batch's user j: the count, the threefry draws, the positive's load,
// the rejection scan, the hot-slot lookups, the cost. What spans a factor
// row runs in one pass, a user on LPU lanes: the two dot products, the
// gradient and the payloads.
template <bool SAMPLED, bool BF16, int KPL, bool VEC>
__device__ __forceinline__ void sweep_users(const SweepArgs& a, const float* p_in, uint32_t key0,
                                            uint32_t key1, int* pos_out, int* neg_out,
                                            float& warp_cost, float* stage, int* touched) {
  const int lane = threadIdx.x & 31;
  const StepKey key = SAMPLED ? step_keys(key0, key1) : StepKey{};  // KEYS, the whole warp
  const int k = a.k;
  const int n_warps = gridDim.x * WARPS;
  const int per_warp = (a.n_users + n_warps - 1) / n_warps;
  const int warp = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int first = warp * per_warp;
  const int last = min(first + per_warp, a.n_users);
  const bool staged = a.hot_slot != nullptr;
  const uint32_t n_items = (uint32_t)a.n_items;
  const uint32_t items_mult = SAMPLED ? randint_mult(n_items) : 0u;  // the candidates' m
  for (int base = first; base < last; base += 32) {
    const int n_here = min(32, last - base);
    const int u = base + lane;  // this lane's user
    const bool live = lane < n_here;

    // ---- lane-parallel: the user's count, draws and pair
    int count = 0, pos = 0, neg = 0, touch = 0;
    bool active;
    int cand[MAXC] = {};
    const bool scan = a.ablate != ABLATE_NOSAMPLE && a.ablate != ABLATE_SAMP_NOREJ;
    if (SAMPLED) {
      // SAMPLING: bit-equal to _sample_pairs (gorse_tpu/models/bpr.py)
      const int* row = a.padded + (size_t)u * a.max_len;
      count = live ? a.counts[u] : 0;  // 552 KB at the training shape: stays in L2
      const int valid = min(count, a.max_len);  // the entries the row holds
      // TOUCH: one load in each 128-byte line of the row's first `valid`
      // entries, all in flight at once and behind the draws; the positive
      // and the scan then read the row from L1 (an OR of ids >= 0 and -1 is
      // never INT_MIN). With BITS the row is read at the slot only.
      if (scan && a.bits == nullptr) {
        for (int i = 0; i < valid; i += 32) touch |= row[i];
        if (valid > 0) touch |= row[valid - 1];
      }
      // max(row[0], 0): the ablated positive (row[0] is -1 when count is 0)
      const bool first_pos = a.ablate == ABLATE_NOSAMPLE || a.ablate == ABLATE_SAMP_NOPOS;
      const int row0 = live && first_pos ? max(__ldcs(row), 0) : 0;
      if (a.ablate == ABLATE_NOSAMPLE) {
        pos = row0;
        neg = (pos + 37) % a.n_items;
      } else {
#pragma unroll
        for (int t = 0; t < MAXC; ++t)
          if (t < a.n_tries) cand[t] = candidate(key, u, t, a.n_tries, n_items, items_mult);
        if (a.ablate == ABLATE_SAMP_NOPOS) {
          pos = row0;
        } else {
          // the slot: element u of randint(ks, (U,), 0, max(count, 1))
          const uint32_t span = (uint32_t)max(count, 1);
          const int slot = (int)randint_reduce(random_bits(key.w[0], key.w[1], (unsigned)u),
                                               random_bits(key.w[2], key.w[3], (unsigned)u), span,
                                               randint_mult(span));
          pos = live && slot < a.max_len ? max(row[slot], 0) : 0;
        }
        neg = cand[0];  // every draw collides: keep the first
      }
      active = live && count > 0;
    } else {
      pos = live ? a.pos_in[u] : 0;
      neg = live ? a.neg_in[u] : 0;
      active = live && a.active_in[u] != 0;
    }

    // ---- lane-parallel: rejection, the first free candidate wins. BITS:
    // the words of the first min(n_tries, MAXC) candidates, all loads in
    // flight before any test. Else the scan over the first min(count,
    // max_len) entries of the lane's row (past the count a row holds -1 and
    // candidates lie in [0, n_items), so the full row gives the same
    // answer), touched above; each entry is held against every candidate.
    if (SAMPLED && scan && live) {
      const int* row = a.padded + (size_t)u * a.max_len;
      const int valid = min(count, a.max_len);
      const int nt = min(a.n_tries, MAXC);
      const uint32_t* brow = a.bits != nullptr ? a.bits + (size_t)u * a.words : nullptr;
      unsigned hit = 0u;
      if (brow != nullptr) {
        uint32_t word[MAXC];
#pragma unroll
        for (int t = 0; t < MAXC; ++t) word[t] = t < nt ? __ldg(brow + (cand[t] >> 5)) : 0u;
#pragma unroll
        for (int t = 0; t < MAXC; ++t)
          if ((word[t] >> (cand[t] & 31)) & 1u) hit |= 1u << t;
      } else {
        hit = touch == INT_MIN ? 1u : 0u;  // waits for the touches
#pragma unroll 4
        for (int i = 0; i < valid; ++i) {
          const int v = row[i];
#pragma unroll
          for (int t = 0; t < MAXC; ++t)
            if (t < nt && v == cand[t]) hit |= 1u << t;
        }
      }
      const unsigned free = ~hit & ((1u << nt) - 1u);
      if (free != 0u) {
        const int first_free = __ffs(free) - 1;
#pragma unroll
        for (int t = 0; t < MAXC; ++t)  // a select, not an index: cand stays in registers
          if (t == first_free) neg = cand[t];
      } else {
        for (int t = MAXC; t < a.n_tries; ++t) {  // more draws, one at a time
          const int c = candidate(key, u, t, a.n_tries, n_items, items_mult);
          bool collides = false;
          if (brow != nullptr) {
            collides = (__ldg(brow + (c >> 5)) >> (c & 31)) & 1u;
          } else {
            for (int i = 0; i < valid; ++i) collides |= row[i] == c;
          }
          if (!collides) {
            neg = c;
            break;
          }
        }
      }
    }
    if (SAMPLED && pos_out != nullptr && live) {
      pos_out[u] = pos;
      neg_out[u] = neg;
    }
    int hs_pos = -1, hs_neg = -1;
    if (staged && active) {
      hs_pos = __ldg(a.hot_slot + pos);
      hs_neg = __ldg(a.hot_slot + neg);
      hs_pos = hs_pos < a.n_hot ? hs_pos : -1;
      hs_neg = hs_neg < a.n_hot ? hs_neg : -1;
      if (hs_pos >= 0) touched[hs_pos] = 1;
      if (hs_neg >= 0) touched[hs_neg] = 1;
    }

    // ---- the pass, G users at a time, LPU lanes a user (PAIRS: two users a
    // warp where k <= 64, one instruction stream for both): diff =
    // sum(p*qi) - sum(p*qj) (ORDER: each sum over the user's lanes), the
    // gradient, p_out and the payloads; the next users' rows load meanwhile
    // (OVERLAP). Each user's diff goes back to its lane for the cost.
    constexpr int LPU = KPL <= 2 ? 16 : 32;
    constexpr int G = 32 / LPU;
    constexpr int EPL = KPL * 32 / LPU;
    const int grp = lane / LPU, gl = lane % LPU;
    const bool scatter = a.ablate != ABLATE_NOSCATTER;
    float my_diff = 0.f;
    Rows<EPL> nx;
    {
      const int p0 = __shfl_sync(FULL, pos, grp), n0 = __shfl_sync(FULL, neg, grp);
      if (grp < n_here) load_rows<BF16, EPL, LPU, VEC>(a, p_in, base + grp, p0, n0, gl, nx);
    }
    for (int j = 0; j < n_here; j += G) {
      const int jj = j + grp;  // this group's user
      const Rows<EPL> r = nx;
      const int pj = __shfl_sync(FULL, pos, jj & 31), nj = __shfl_sync(FULL, neg, jj & 31);
      const bool act = __shfl_sync(FULL, (int)active, jj & 31) != 0 && jj < n_here;
      const int sp = __shfl_sync(FULL, hs_pos, jj & 31), sn = __shfl_sync(FULL, hs_neg, jj & 31);
      const int jn = jj + G;
      const int pn = __shfl_sync(FULL, pos, jn & 31), nn = __shfl_sync(FULL, neg, jn & 31);
      if (jn < n_here) load_rows<BF16, EPL, LPU, VEC>(a, p_in, base + jn, pn, nn, gl, nx);
      float si = 0.f, sj = 0.f;
#pragma unroll
      for (int i = 0; i < EPL; ++i) {
        si += __fmul_rn(r.p[i], r.qi[i]);
        sj += __fmul_rn(r.p[i], r.qj[i]);
      }
      const float diff = group_sum<LPU>(si) - group_sum<LPU>(sj);
      // user L was the user of group L % G in the round j = L - L % G
      const float handed = __shfl_sync(FULL, diff, (lane % G) * LPU);
      if (lane - lane % G == j) my_diff = handed;
      if (jj >= n_here) continue;
      float* orow = a.p_out + (size_t)(base + jj) * k;
      constexpr int W = vec_width(EPL);
      float p_new[EPL], d_pos[EPL], d_neg[EPL];
      if (!act) {
        // INACTIVE: p unchanged, no payloads, no cost
#pragma unroll
        for (int i = 0; i < EPL; ++i) p_new[i] = r.p[i];
      } else {
        const float g = 1.f / (1.f + expf(diff));  // sigmoid(-diff)
#pragma unroll
        for (int i = 0; i < EPL; ++i) {
          // each product and difference rounded on its own, in the plain
          // version's order
          d_pos[i] =
              __fmul_rn(a.lr, __fsub_rn(__fmul_rn(g, r.p[i]), __fmul_rn(a.reg, r.qi[i])));
          d_neg[i] =
              __fmul_rn(a.lr, __fsub_rn(__fmul_rn(-g, r.p[i]), __fmul_rn(a.reg, r.qj[i])));
          const float d_pu = __fmul_rn(
              a.lr, __fsub_rn(__fmul_rn(g, __fsub_rn(r.qi[i], r.qj[i])), __fmul_rn(a.reg, r.p[i])));
          p_new[i] = __fadd_rn(r.p[i], d_pu);
          if (BF16) {
            d_pos[i] = round_bf16(d_pos[i]);
            d_neg[i] = round_bf16(d_neg[i]);
          }
        }
      }
      if (VEC) {
#pragma unroll
        for (int c = 0; c < EPL; c += W)
          if (gl * EPL + c < k) store_chunk_cs<W>(orow + gl * EPL + c, p_new + c);
      } else {
#pragma unroll
        for (int i = 0; i < EPL; ++i)
          if (gl + LPU * i < k) __stcs(orow + gl + LPU * i, p_new[i]);
      }
      if (!act || !scatter) continue;
      // ATOMICS: rows hit by many users of the sweep add in any order;
      // HEAD: a staged item's adds go to the block's shared row (each
      // branch is uniform across the user's lanes)
#pragma unroll
      for (int side = 0; side < 2; ++side) {
        const int slot = side ? sn : sp;
        const float* d = side ? d_neg : d_pos;
        if (slot >= 0) {
#pragma unroll
          for (int i = 0; i < EPL; ++i) {
            const int e = elem<VEC, EPL, LPU>(gl, i);
            if (e < k) atomicAdd(stage + slot * k + e, d[i]);
          }
        } else {
          float* row = a.delta + (size_t)(side ? nj : pj) * k;
          if (VEC) {
#pragma unroll
            for (int c = 0; c < EPL; c += W)
              if (gl * EPL + c < k) add_chunk<W>(row + gl * EPL + c, d + c);
          } else {
#pragma unroll
            for (int i = 0; i < EPL; ++i)
              if (gl + LPU * i < k) atomicAdd(row + gl + LPU * i, d[i]);
          }
        }
      }
    }
    // ---- lane-parallel: the cost
    if (active) {
      const float x = -my_diff;
      warp_cost += fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));  // logaddexp(0, -diff)
    }
  }
}

// HEAD: the staged rows zero, none touched
__device__ __forceinline__ void clear_stage(const SweepArgs& a, float* stage, int* touched) {
  for (int i = threadIdx.x; i < a.n_hot * a.k; i += THREADS) stage[i] = 0.f;
  for (int i = threadIdx.x; i < a.n_hot; i += THREADS) touched[i] = 0;
  __syncthreads();
}

// HEAD: the block's staged rows into delta, one global add an element of
// each row some user of the block touched; the stage is left zero
__device__ __forceinline__ void flush_stage(const SweepArgs& a, float* stage, int* touched) {
  __syncthreads();
  const int n = a.n_hot * a.k;
  for (int idx = threadIdx.x; idx < n; idx += THREADS) {
    const int s = idx / a.k;
    if (touched[s]) {
      atomicAdd(a.delta + (size_t)a.hot_items[s] * a.k + (idx - s * a.k), stage[idx]);
      stage[idx] = 0.f;
    }
  }
  __syncthreads();
  for (int s = threadIdx.x; s < a.n_hot; s += THREADS) touched[s] = 0;
}

// the block's lanes' costs, one atomicAdd
__device__ __forceinline__ void add_block_cost(float* cost, float lane_cost) {
  __shared__ float block_cost[WARPS];
  const int lane = threadIdx.x & 31;
  const float warp_cost = warp_sum(lane_cost);
  if (lane == 0) block_cost[threadIdx.x >> 5] = warp_cost;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) total += block_cost[w];
    atomicAdd(cost, total);
  }
}

template <bool SAMPLED, bool BF16, int KPL, bool VEC>
__global__ void __launch_bounds__(THREADS) bpr_sweep_kernel(SweepArgs a) {
  __shared__ float stage[STAGE_FLOATS];
  __shared__ int touched[HOT_ITEMS];
  clear_stage(a, stage, touched);
  float warp_cost = 0.f;
  sweep_users<SAMPLED, BF16, KPL, VEC>(a, a.p, a.key0, a.key1, a.pos_out, a.neg_out, warp_cost,
                                       stage, touched);
  if (a.hot_slot != nullptr) flush_stage(a, stage, touched);
  add_block_cost(a.cost, warp_cost);
}

// q += delta; delta = 0 over the whole grid, four floats a thread where both
// are 16-byte aligned
__device__ __forceinline__ void fold_all(float* q, float* delta, long long n, bool vec) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long done = 0;
  if (vec) {
    float4* q4 = reinterpret_cast<float4*>(q);
    float4* d4 = reinterpret_cast<float4*>(delta);
    const long long n4 = n / 4;
    for (long long i = tid; i < n4; i += stride) {
      float4 v = q4[i];
      const float4 d = d4[i];
      v.x += d.x;
      v.y += d.y;
      v.z += d.z;
      v.w += d.w;
      q4[i] = v;
      d4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    done = n4 * 4;
  }
  for (long long i = done + tid; i < n; i += stride) {
    q[i] += delta[i];
    delta[i] = 0.f;
  }
}

// OCCUPANCY: the co-resident blocks an SM keeps for the epoch, by factor
// width. Left free, ptxas gives the draws' threefry chains and keys about
// 120 registers at every width (2 blocks an SM); bounded to 3, 80 at k <=
// 128 (none or a few bytes spilled). The epoch is bound by how many warps
// hide its loads and barriers: on an H100 (tools/k1_occupancy_probe.py), 3
// blocks took about 0.1 ms off a 1.4 ms epoch at 138k x 27k, k = 64 and 32;
// 4 (64 registers) gained nothing at k = 32 and slowed the small epochs.
__host__ __device__ constexpr int epoch_min_blocks(int kpl) {
  return kpl <= 4 ? 3 : 2;
}

// GRID: the fewest users a warp takes in the epoch; it caps the grid only
// where the users are fewer than 32 for every resident warp. The row scan
// runs on a warp's lanes, a user each, for the widest row among them: a
// full warp scans 32 rows for the cost of one. The bitset has no scan; the
// pass then takes a warp's users G at a time, while every block more costs
// at each grid barrier. Measured at the reference's ml-1m shape (6,040
// users, k = 8) on an H100: against the rows 51 ms an epoch at 32 users a
// warp, 76 with every block; with the bitset 1.9 ms at 4, 2.0-2.5 at 2, 8,
// 16 or every block.
int epoch_users(const SweepArgs& a) {
  return a.bits != nullptr ? 4 : 32;
}

// K1: the whole epoch in one cooperative launch. Per step: the sampled sweep
// (p in place after step 0), a grid barrier, the fold, a grid barrier.
template <bool BF16, int KPL, bool VEC>
__global__ void __launch_bounds__(THREADS, epoch_min_blocks(KPL))
    bpr_epoch_kernel(SweepArgs a, const int* keys, int n_steps, int vec) {
  __shared__ float stage[STAGE_FLOATS];
  __shared__ int touched[HOT_ITEMS];
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  clear_stage(a, stage, touched);
  const long long n = (long long)a.n_rows * a.k;
  float warp_cost = 0.f;
  for (int s = 0; s < n_steps; ++s) {
    int* pos_out = a.pos_out ? a.pos_out + (size_t)s * a.n_users : nullptr;
    int* neg_out = a.neg_out ? a.neg_out + (size_t)s * a.n_users : nullptr;
    sweep_users<true, BF16, KPL, VEC>(a, s == 0 ? a.p : a.p_out, (uint32_t)keys[2 * s],
                                      (uint32_t)keys[2 * s + 1], pos_out, neg_out, warp_cost,
                                      stage, touched);
    if (a.hot_slot != nullptr) flush_stage(a, stage, touched);
    grid.sync();
    fold_all(a.q, a.delta, n, vec != 0);
    if (s + 1 < n_steps) grid.sync();
  }
  add_block_cost(a.cost, warp_cost);
}

// blocks of `kernel` that fit on the card at once
template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, int& blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0);
  blocks = sms * per_sm;
  return err;
}

// a persistent grid: each warp walks many users, so its loads ahead overlap
template <bool SAMPLED, bool BF16, int KPL, bool VEC>
cudaError_t launch_sweep_kpl(const SweepArgs& a, cudaStream_t stream) {
  int grid = 0;
  cudaError_t err = resident_blocks(bpr_sweep_kernel<SAMPLED, BF16, KPL, VEC>, grid);
  if (err != cudaSuccess) return err;
  const int need = (a.n_users + WARPS - 1) / WARPS;
  grid = grid < need ? grid : need;
  bpr_sweep_kernel<SAMPLED, BF16, KPL, VEC><<<grid > 0 ? grid : 1, THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

template <bool SAMPLED, bool BF16, bool VEC>
cudaError_t launch_sweep_vec(const SweepArgs& a, cudaStream_t stream) {
  const int kpl = (a.k + 31) / 32;
  if (kpl <= 1) return launch_sweep_kpl<SAMPLED, BF16, 1, VEC>(a, stream);
  if (kpl <= 2) return launch_sweep_kpl<SAMPLED, BF16, 2, VEC>(a, stream);
  if (kpl <= 4) return launch_sweep_kpl<SAMPLED, BF16, 4, VEC>(a, stream);
  if (kpl <= 8) return launch_sweep_kpl<SAMPLED, BF16, 8, VEC>(a, stream);
  return cudaErrorInvalidValue;
}

template <bool SAMPLED, bool BF16>
cudaError_t launch_sweep(const SweepArgs& a, bool vec, cudaStream_t stream) {
  return vec ? launch_sweep_vec<SAMPLED, BF16, true>(a, stream)
             : launch_sweep_vec<SAMPLED, BF16, false>(a, stream);
}

// the co-resident grid: every SM times the blocks that fit on it, capped by
// GRID; a grid the card cannot hold at once is refused (the wrapper raises)
template <bool BF16, int KPL, bool VEC>
cudaError_t launch_epoch_kpl(SweepArgs a, const int* keys, int n_steps, int vec,
                             cudaStream_t stream) {
  void (*kernel)(SweepArgs, const int*, int, int) = bpr_epoch_kernel<BF16, KPL, VEC>;
  int dev = 0, coop = 0, grid = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess) err = resident_blocks(kernel, grid);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  if (grid < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int users = epoch_users(a);
  const int need = (a.n_users + users * WARPS - 1) / (users * WARPS);
  grid = grid < need ? grid : need;
  grid = grid > 0 ? grid : 1;
  void* args[] = {(void*)&a, (void*)&keys, (void*)&n_steps, (void*)&vec};
  return cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid), dim3(THREADS), args, 0,
                                     stream);
}

template <bool BF16, bool VEC>
cudaError_t launch_epoch_vec(const SweepArgs& a, const int* keys, int n_steps, int vec,
                             cudaStream_t stream) {
  const int kpl = (a.k + 31) / 32;
  if (kpl <= 1) return launch_epoch_kpl<BF16, 1, VEC>(a, keys, n_steps, vec, stream);
  if (kpl <= 2) return launch_epoch_kpl<BF16, 2, VEC>(a, keys, n_steps, vec, stream);
  if (kpl <= 4) return launch_epoch_kpl<BF16, 4, VEC>(a, keys, n_steps, vec, stream);
  if (kpl <= 8) return launch_epoch_kpl<BF16, 8, VEC>(a, keys, n_steps, vec, stream);
  return cudaErrorInvalidValue;
}

// HEAD: the first rows of the hot table that fit the stage
void set_head(SweepArgs& a, const void* hot_slot, const void* hot_items, int n_hot) {
  if (hot_slot == nullptr || n_hot <= 0) return;
  a.hot_slot = (const short*)hot_slot;
  a.hot_items = (const int*)hot_items;
  const int fit = STAGE_FLOATS / a.k < HOT_ITEMS ? STAGE_FLOATS / a.k : HOT_ITEMS;
  a.n_hot = n_hot < fit ? n_hot : fit;
}

// VEC: every row starts 16-byte aligned and k is a multiple of the vector
// (float2 for k <= 32, float4 above)
bool rows_vectorized(int k, std::initializer_list<const void*> ptrs) {
  if (k % (k <= 32 ? 2 : 4) != 0) return false;
  for (const void* p : ptrs)
    if (p != nullptr && (uintptr_t)p % 16 != 0) return false;
  return true;
}

}  // namespace

// bits / words: the full-set rejection bitset, [n_users, words] (null / 0:
// reject against the rows); key0 / key1: the step key (sampled mode);
// hot_slot / hot_items / n_hot: the staged Zipf head (null / 0: none)
extern "C" int gt_bpr_sweep(int sampled, int bf16, const void* p, void* p_out, const void* q,
                            void* delta, void* cost, int n_users, int k, const void* padded,
                            const void* counts, int max_len, const void* bits, int words,
                            unsigned key0, unsigned key1, int n_items, int n_tries, void* pos_out,
                            void* neg_out, const void* pos_in, const void* neg_in,
                            const void* active_in, float lr, float reg, const void* hot_slot,
                            const void* hot_items, int n_hot, void* stream) {
  if (n_users <= 0) return 0;
  SweepArgs a = {};
  a.p = (const float*)p;
  a.p_out = (float*)p_out;
  a.q = (float*)q;
  a.delta = (float*)delta;
  a.cost = (float*)cost;
  a.n_users = n_users;
  a.k = k;
  a.padded = (const int*)padded;
  a.counts = (const int*)counts;
  a.max_len = max_len;
  a.bits = (const uint32_t*)bits;
  a.words = words;
  a.key0 = key0;
  a.key1 = key1;
  a.n_items = n_items;
  a.n_tries = n_tries;
  a.pos_out = (int*)pos_out;
  a.neg_out = (int*)neg_out;
  a.pos_in = (const int*)pos_in;
  a.neg_in = (const int*)neg_in;
  a.active_in = (const int*)active_in;
  a.lr = lr;
  a.reg = reg;
  a.ablate = ABLATE_NONE;
  set_head(a, hot_slot, hot_items, n_hot);
  const bool vec = rows_vectorized(k, {p, p_out, q, delta});
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (sampled) {
    err = bf16 ? launch_sweep<true, true>(a, vec, s) : launch_sweep<true, false>(a, vec, s);
  } else {
    err = bf16 ? launch_sweep<false, true>(a, vec, s) : launch_sweep<false, false>(a, vec, s);
  }
  return (int)err;
}

// bits / words: as gt_bpr_sweep; keys: [n_steps, 2] int32 step key words on
// the device; pos_out / neg_out null or [n_steps, n_users] int32; hot_slot /
// hot_items / n_hot: the staged Zipf head (null / 0: none)
extern "C" int gt_bpr_epoch(int bf16, const void* p, void* p_out, void* q, void* delta,
                            void* cost, int n_users, int k, int n_rows, const void* padded,
                            const void* counts, int max_len, const void* bits, int words,
                            const void* keys, int n_steps,
                            int n_items, int n_tries, void* pos_out, void* neg_out, float lr,
                            float reg, int ablate, const void* hot_slot,
                            const void* hot_items, int n_hot, void* stream) {
  if (n_steps <= 0) return 0;
  SweepArgs a = {};
  a.p = (const float*)p;
  a.p_out = (float*)p_out;
  a.q = (float*)q;
  a.delta = (float*)delta;
  a.cost = (float*)cost;
  a.n_users = n_users;
  a.k = k;
  a.n_rows = n_rows;
  a.padded = (const int*)padded;
  a.counts = (const int*)counts;
  a.max_len = max_len;
  a.bits = (const uint32_t*)bits;
  a.words = words;
  a.n_items = n_items;
  a.n_tries = n_tries;
  a.pos_out = (int*)pos_out;
  a.neg_out = (int*)neg_out;
  a.lr = lr;
  a.reg = reg;
  a.ablate = ablate;
  set_head(a, hot_slot, hot_items, n_hot);
  const int vec = ((uintptr_t)q % 16 == 0) && ((uintptr_t)delta % 16 == 0);
  cudaStream_t s = (cudaStream_t)stream;
  const int* kd = (const int*)keys;
  cudaError_t err;
  if (rows_vectorized(k, {p, p_out, q, delta})) {
    err = bf16 ? launch_epoch_vec<true, true>(a, kd, n_steps, vec, s)
               : launch_epoch_vec<false, true>(a, kd, n_steps, vec, s);
  } else {
    err = bf16 ? launch_epoch_vec<true, false>(a, kd, n_steps, vec, s)
               : launch_epoch_vec<false, false>(a, kd, n_steps, vec, s);
  }
  return (int)err;
}
