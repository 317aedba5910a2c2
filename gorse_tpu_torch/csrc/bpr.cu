// The BPR pairwise sweep and the sweep-boundary fold, for Hopper (sm_90a).
//
// Replaces the three TPU BPR kernels of gorse_tpu/ops/bpr_kernel.py:
//
//   bpr_sweep, sampled mode    one sweep with in-kernel sampling: the body
//                              of _fully_fused_kernel (K2, :285) and of one
//                              step of _epoch_resident_kernel (K1, :329)
//   bpr_sweep, pairs mode      one sweep given explicit pos / neg / active:
//                              _fused_kernel (K3, :206)
//   bpr_fold                   q += delta; delta = 0: K1's sweep boundary
//                              (:392)
//
// K1 (a whole epoch) is n_steps launches of the sampled sweep, each followed
// by a fold. The TPU kernels gather and scatter through one-hot matmuls over
// a 128-lane packed item table, because a TPU has no fast gather; Hopper
// gathers rows natively and scatter-adds with atomics, so the table stays
// row-major [n_items, k] f32 and the sweep's cost scales with the users, not
// with the catalog.
//
// One warp per user (grid-stride over users), lane l owning factor
// elements l, l + 32, ... (KPL = ceil(k / 32) of them). Per active user:
//   sample (sampled mode): 1 + n_tries uniforms from threefry-2x32 keyed by
//     (step key, global user id, column pair), as _per_user_uniforms in
//     gorse_tpu/parallel/sharded.py; lanes j < n_pairs each compute block j;
//     slot = int(u0 * max(count, 1)), pos = max(row[slot], 0); candidates
//     int(u_t * n_items), rejected against the user's padded row (the
//     capped rows, as the Pallas kernels do; a warp vote per candidate);
//   gather q[pos] and q[neg] from the sweep's snapshot of q;
//   diff = sum(p*qi) - sum(p*qj), cost softplus(-diff), grad sigmoid(-diff);
//   p_new = p + lr * (grad * (qi - qj) - reg * p) into p_out;
//   atomicAdd lr * (grad * p - reg * qi) into delta[pos],
//             lr * (-grad * p - reg * qj) into delta[neg];
//   the cost: a warp's running sum, one atomicAdd per thread block.
//
// Bound: bytes. Per active user the sweep reads p (k f32) and writes p_new,
// gathers two q rows, read-modify-writes two delta rows and scans the padded
// row (L int32); about 8 flops per factor element. Nothing is reused, so the
// design keeps every access a full-warp coalesced row and does no extra pass.
//
// Where the trouble is, and what the code does about it:
// (1) snapshot semantics: every user of a sweep reads the same q; the sweep
//     never writes q, only delta, and bpr_fold adds delta in after the
//     launch. Rows that repeat in a sweep add up instead of chaining, as in
//     gorse_tpu/models/bpr.py:107-121. See SNAPSHOT below.
// (2) summation order: diff is sum(p*qi) - sum(p*qj), the order of the TPU
//     kernels (bpr_kernel.py:123-126), each sum a butterfly over the warp.
//     The plain versions sum in another order: p_new and the cost agree to a
//     tolerance, not bit for bit. See ORDER below.
// (3) atomics: delta rows that many users of a sweep hit (a Zipf-popular
//     item) take their adds in an order that changes from run to run; delta
//     and the cost match the plain version to a tolerance. See ATOMICS.
// (4) transcendentals: expf / log1pf differ from torch's CPU sigmoid and
//     log1p by a few ulps; another reason p_new is held to a tolerance. The
//     sampled pos and neg are integers and are exact: both f32 products are
//     __fmul_rn, never contracted into an FMA. See SAMPLING.
// (5) inactive users (count 0, or active 0): pos = max(row[0], 0) is still
//     written out, but p_out = p, and nothing goes into delta or the cost.
//     See INACTIVE.
//
// mm_dtype bf16: the gathered q rows and the two scatter payloads are
// rounded to bf16 (round to nearest even) where the TPU kernel casts them
// (bpr_kernel.py:213,307,355 and :188-202); everything else stays f32.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;  // users in flight per thread block
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

__device__ __forceinline__ float bits_to_uniform(uint32_t bits) {
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;  // exact: [1, 2) - 1
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

struct SweepArgs {
  const float* p;
  float* p_out;
  const float* q;
  float* delta;
  float* cost;
  int n_users, k;
  // sampled mode
  const int* padded;
  const int* counts;
  int max_len;
  uint32_t key0, key1;
  int n_items, n_tries;
  int* pos_out;
  int* neg_out;
  // pairs mode
  const int* pos_in;
  const int* neg_in;
  const int* active_in;
  float lr, reg;
};

template <bool SAMPLED, bool BF16, int KPL>
__global__ void __launch_bounds__(THREADS) bpr_sweep_kernel(SweepArgs a) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int k = a.k;
  float warp_cost = 0.f;
  for (int u = blockIdx.x * WARPS + warp; u < a.n_users; u += gridDim.x * WARPS) {
    int pos, neg;
    bool active;
    if (SAMPLED) {
      // SAMPLING: bit-equal to _sample_pair (gorse_tpu/parallel/sharded.py)
      const int count = a.counts[u];
      const int* row = a.padded + (size_t)u * a.max_len;
      const int n_pairs = (2 + a.n_tries) / 2;  // blocks for 1 + n_tries words
      uint32_t w0 = 0, w1 = 0;
      if (lane < n_pairs) {
        w0 = (uint32_t)u;  // the counter is the user's row: unsharded global ids
        w1 = (uint32_t)lane;
        threefry2x32(a.key0, a.key1, w0, w1);
      }
      // column c is word c % 2 of block c / 2 (every lane takes part)
      const uint32_t c0w0 = __shfl_sync(FULL, w0, 0);
      const float u0 = bits_to_uniform(c0w0);
      const int slot = (int)__fmul_rn(u0, (float)max(count, 1));
      pos = slot < a.max_len ? max(row[slot], 0) : 0;
      const float fn = (float)a.n_items;
      neg = 0;
      bool ok = false;
      for (int t = 0; t < a.n_tries; ++t) {
        const int col = 1 + t;
        const uint32_t b0 = __shfl_sync(FULL, w0, col >> 1);
        const uint32_t b1 = __shfl_sync(FULL, w1, col >> 1);
        const int cand = (int)__fmul_rn(bits_to_uniform((col & 1) ? b1 : b0), fn);
        if (t == 0) neg = cand;  // every draw collides: keep the first
        bool hit = false;
        for (int j = lane; j < a.max_len; j += 32) hit |= (row[j] == cand);
        const bool collides = __any_sync(FULL, hit);
        if (!ok && !collides) {
          neg = cand;
          ok = true;
        }
      }
      if (lane == 0) {
        a.pos_out[u] = pos;
        a.neg_out[u] = neg;
      }
      active = count > 0;
    } else {
      pos = a.pos_in[u];
      neg = a.neg_in[u];
      active = a.active_in[u] != 0;
    }

    const float* prow = a.p + (size_t)u * k;
    float* orow = a.p_out + (size_t)u * k;
    if (!active) {
      // INACTIVE: p unchanged, no payloads, no cost
#pragma unroll
      for (int i = 0; i < KPL; ++i) {
        const int e = lane + 32 * i;
        if (e < k) orow[e] = prow[e];
      }
      continue;
    }

    // SNAPSHOT: q is only read here; the sweep writes delta, never q
    const float* qi_row = a.q + (size_t)pos * k;
    const float* qj_row = a.q + (size_t)neg * k;
    float pv[KPL], qi[KPL], qj[KPL];
    float si = 0.f, sj = 0.f;
#pragma unroll
    for (int i = 0; i < KPL; ++i) {
      const int e = lane + 32 * i;
      pv[i] = qi[i] = qj[i] = 0.f;
      if (e < k) {
        pv[i] = prow[e];
        qi[i] = qi_row[e];
        qj[i] = qj_row[e];
        if (BF16) {
          qi[i] = round_bf16(qi[i]);
          qj[i] = round_bf16(qj[i]);
        }
      }
      si += __fmul_rn(pv[i], qi[i]);
      sj += __fmul_rn(pv[i], qj[i]);
    }
    // ORDER: sum(p*qi) - sum(p*qj), each over the whole warp
    const float diff = warp_sum(si) - warp_sum(sj);
    const float x = -diff;
    const float c = fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));  // logaddexp(0, -diff)
    const float grad = 1.f / (1.f + expf(diff));               // sigmoid(-diff)
    if (lane == 0) warp_cost += c;

    float* dpos_row = a.delta + (size_t)pos * k;
    float* dneg_row = a.delta + (size_t)neg * k;
#pragma unroll
    for (int i = 0; i < KPL; ++i) {
      const int e = lane + 32 * i;
      if (e >= k) continue;
      // each product and difference rounded on its own, in the plain
      // version's order
      float d_pos = __fmul_rn(a.lr, __fsub_rn(__fmul_rn(grad, pv[i]), __fmul_rn(a.reg, qi[i])));
      float d_neg = __fmul_rn(a.lr, __fsub_rn(__fmul_rn(-grad, pv[i]), __fmul_rn(a.reg, qj[i])));
      const float d_pu = __fmul_rn(
          a.lr, __fsub_rn(__fmul_rn(grad, __fsub_rn(qi[i], qj[i])), __fmul_rn(a.reg, pv[i])));
      orow[e] = __fadd_rn(pv[i], d_pu);
      if (BF16) {
        d_pos = round_bf16(d_pos);
        d_neg = round_bf16(d_neg);
      }
      // ATOMICS: rows hit by many users of the sweep add in any order
      atomicAdd(dpos_row + e, d_pos);
      atomicAdd(dneg_row + e, d_neg);
    }
  }

  __shared__ float block_cost[WARPS];
  if (lane == 0) block_cost[warp] = warp_cost;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) total += block_cost[w];
    atomicAdd(a.cost, total);
  }
}

template <bool SAMPLED, bool BF16>
cudaError_t launch_sweep(const SweepArgs& a, int grid, cudaStream_t stream) {
  const int kpl = (a.k + 31) / 32;
  if (kpl <= 1) {
    bpr_sweep_kernel<SAMPLED, BF16, 1><<<grid, THREADS, 0, stream>>>(a);
  } else if (kpl <= 2) {
    bpr_sweep_kernel<SAMPLED, BF16, 2><<<grid, THREADS, 0, stream>>>(a);
  } else if (kpl <= 4) {
    bpr_sweep_kernel<SAMPLED, BF16, 4><<<grid, THREADS, 0, stream>>>(a);
  } else if (kpl <= 8) {
    bpr_sweep_kernel<SAMPLED, BF16, 8><<<grid, THREADS, 0, stream>>>(a);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// q += delta; delta = 0, four floats a thread where both are 16-byte aligned
__global__ void bpr_fold_kernel(float* __restrict__ q, float* __restrict__ delta, long long n,
                                int vec) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long done = 0;
  if (vec) {
    float4* q4 = reinterpret_cast<float4*>(q);
    float4* d4 = reinterpret_cast<float4*>(delta);
    const long long n4 = n / 4;
    for (long long i = tid; i < n4; i += stride) {
      float4 a = q4[i];
      const float4 b = d4[i];
      a.x += b.x;
      a.y += b.y;
      a.z += b.z;
      a.w += b.w;
      q4[i] = a;
      d4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    done = n4 * 4;
  }
  for (long long i = done + tid; i < n; i += stride) {
    q[i] += delta[i];
    delta[i] = 0.f;
  }
}

}  // namespace

extern "C" int gt_bpr_sweep(int sampled, int bf16, const void* p, void* p_out, const void* q,
                            void* delta, void* cost, int n_users, int k, const void* padded,
                            const void* counts, int max_len, unsigned key0, unsigned key1,
                            int n_items, int n_tries, void* pos_out,
                            void* neg_out, const void* pos_in, const void* neg_in,
                            const void* active_in, float lr, float reg, void* stream) {
  if (n_users <= 0) return 0;
  SweepArgs a;
  a.p = (const float*)p;
  a.p_out = (float*)p_out;
  a.q = (const float*)q;
  a.delta = (float*)delta;
  a.cost = (float*)cost;
  a.n_users = n_users;
  a.k = k;
  a.padded = (const int*)padded;
  a.counts = (const int*)counts;
  a.max_len = max_len;
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
  int grid = (n_users + WARPS - 1) / WARPS;
  if (grid > 8192) grid = 8192;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (sampled) {
    err = bf16 ? launch_sweep<true, true>(a, grid, s) : launch_sweep<true, false>(a, grid, s);
  } else {
    err = bf16 ? launch_sweep<false, true>(a, grid, s) : launch_sweep<false, false>(a, grid, s);
  }
  return (int)err;
}

extern "C" int gt_bpr_fold(void* q, void* delta, long long n, void* stream) {
  if (n <= 0) return 0;
  const int vec = ((uintptr_t)q % 16 == 0) && ((uintptr_t)delta % 16 == 0);
  long long work = vec ? n / 4 : n;
  long long blocks = (work + 255) / 256;
  if (blocks < 1) blocks = 1;
  if (blocks > 4096) blocks = 4096;
  bpr_fold_kernel<<<(int)blocks, 256, 0, (cudaStream_t)stream>>>((float*)q, (float*)delta, n, vec);
  return (int)cudaGetLastError();
}
