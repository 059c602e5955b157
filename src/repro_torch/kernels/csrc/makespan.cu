// Population makespan: capacity-aware, core-granular list scheduling of a
// population of candidate assignments (the metaheuristics' fitness).
//
// Replaces the TPU kernel population_makespan_pallas (_kernel) in
// src/repro/kernels/makespan.py, with the comparison-rank select of
// src/repro/kernels/select.py.  Its plain PyTorch version is
// population_makespan_ref in src/repro_torch/kernels/makespan.py; the two
// agree bit for bit.
//
// What bounds it on an H100.  The function needs an O(CMAX) selection and
// overwrite per (candidate, task) and one divide-add-max per dependency edge
// and candidate, and reads about a megabyte of the tables: at the Table IX
// shapes (P=64, T=500, N=500, CMAX=64) the roofline bound is under a
// microsecond, by bytes.  What that bound leaves out is the chain: task j
// needs the finish times of its predecessors and the core-free row left by
// every earlier task on its node, so each candidate walks T dependent steps.
// The kernel is latency-bound on that chain, not bound by bytes or
// operations.
//
// What the design does about it.  One warp per candidate, and nothing on a
// step's critical path that does not depend on earlier steps:
//   * the chain stays inside the warp: __syncwarp, ballots, shuffles and one
//     redux, no block barrier.  Lane l owns the S = ceil(CMAX / 32)
//     consecutive core slots S l .. S l + S - 1;
//   * every row keeps, beside its free times, each slot's stable rank (the
//     reference's comparison rank), so a step reads the c-th smallest and the
//     slots to overwrite off the ranks, and after overwriting the c smallest
//     with f it updates the ranks with a few ballots: a slot that kept its
//     time drops by the c overwritten ones and climbs back over those that
//     now hold f if f is smaller (or equal, from a lower slot); an
//     overwritten slot ranks after the kept times below f (or equal, from a
//     lower slot) and the overwritten slots below it.  A row that holds a
//     NaN, or an f that is NaN, takes the comparison rank itself instead
//     (every NaN ranks 0, as NaN compares false).  A first device kernel
//     (init_ranks) ranks the initial rows once per call;
//   * what the chain does not need is fetched ahead, with plain loads whose
//     registers are stored one step later into a ring in shared memory (no
//     load is waited on before then): the predecessor indices and per-task
//     values five steps ahead, their nodes' data and rates and the step's
//     duration, feasibility and core count three steps ahead, and the
//     transfer times (the divides) one step ahead into registers.  A node's
//     row comes from the registers when one of the two steps before used its
//     node, else it is fetched two steps ahead.  A step is then the max over
//     the predecessors of (fin[p] + tt) (one redux over order-preserving
//     integer keys), the c-th smallest off the ranks, the add, the overwrite
//     and the ballots;
//   * the core-free rows and ranks of a candidate live either in the warp's
//     shared memory (rows_in_smem: 192,000 B at Table IX, one warp per
//     block) or in a device-memory scratch that stays in the 50 MB L2, where
//     a node's row is read from init_free until the candidate first writes
//     it.  The wrapper chooses by shape (makespan_plan in makespan.py).
// Several candidates share a block, one warp each, when there are more
// candidates than SMs (the 8-instance sweep: 512).
//
// Bit-identity with the reference: the transfer time is a correctly
// rounded division (__fdiv_rn) and the adds are __fadd_rn, so nothing is
// contracted or approximated (never build this with --use_fast_math); the
// transfer rate is the direct gather dtr[pn * N + i], not the reference's
// one-hot product; maxima propagate NaN as jnp.maximum does and are exact in
// any order; the k-th smallest and the update use the same stable ranks as
// the reference, not a sort, so ties resolve identically, and the k-th
// smallest is, as the reference's masked sum, NaN when a NaN holds that
// rank, 0 when no slot does, and +0 for -0.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kPre = 2;       // predecessor slots a lane prefetches: the first 64
constexpr int kQ = 32 * kPre;
constexpr int kMaxWarps = 4;  // candidates a block at most
constexpr int kRing = 8;      // steps of prefetched inputs in flight: j .. j + 5
constexpr unsigned kAll = 0xffffffffu;

// jnp.maximum / torch.maximum: NaN in either operand gives NaN.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// An int whose signed order is the float's order, for floats that are not
// NaN; -0 counts as +0, as the comparisons do, and every NaN maps to INT_MAX,
// above +inf.
__device__ __forceinline__ int order_key(float x) {
  const int b = __float_as_int(__fadd_rn(x, 0.0f));
  return x != x ? INT_MAX : b >= 0 ? b : b ^ INT_MAX;
}

__device__ __forceinline__ float from_key(int k) { return __int_as_float(k >= 0 ? k : k ^ INT_MAX); }

// 4-byte words of u16 ranks a lane keeps of a prefetched row: its S slots,
// or for S = 1 the word that holds its slot.
__host__ __device__ constexpr int rank_words(int S) { return S > 1 ? S / 2 : 1; }

// Floats of one warp's shared memory (a multiple of four): the rows and
// their u16 ranks when they live there [N][CP]; the broadcast row [CP]; the
// prefetched rows [3][CP] and their ranks [3][32 rank_words] (two in flight
// and one that takes the stores nobody reads); the assignment and the finish
// times [T]; the ring of prefetched predecessors, their data and rates
// [kRing + 1][3][64] and per-step values [kRing + 1][8] (again one slot
// for stores nobody reads); a first-written byte per node [N].
__host__ __device__ inline long long warp_floats(int T, int N, int S, int rows_in_smem) {
  const long long CP = 32LL * S;
  const long long f = (rows_in_smem ? N * CP + (N * CP + 1) / 2 : 0) + CP + 3 * CP +
                      3 * 32 * rank_words(S) + 2LL * T + (kRing + 1) * (3 * kQ + 8) + (N + 3) / 4;
  return (f + 3) / 4 * 4;
}

// The stable rank of slot s, value v, in a row of C values: the slots below
// v, or equal to it and before s (NaN compares false, so a NaN ranks 0 and
// counts for no other slot).
__device__ __forceinline__ int comparison_rank(const float* row, int C, int s, float v) {
  int rank = 0;
  for (int m = 0; m < C; ++m) {
    const float u = row[m];
    rank += (u < v) | ((u == v) & (m < s));
  }
  return rank;
}

// The initial rows' ranks, once per call: one thread per (instance, node,
// slot) of ranks [B, N, CP] (u16; slots past C unused).
__global__ void population_makespan_init_ranks(const float* __restrict__ init_free,  // [B, N, C]
                                               unsigned short* __restrict__ ranks,   // [B, N, CP]
                                               long long rows, int C, int CP) {
  const long long u = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (u >= rows * CP) return;
  const long long row = u / CP;
  const int s = static_cast<int>(u % CP);
  const float* r = init_free + row * C;
  ranks[u] = s < C ? static_cast<unsigned short>(comparison_rank(r, C, s, r[s])) : 0;
}

// The ready-time key over the predecessors past the first 64 (rare; kept
// out of the step's code).
__device__ __noinline__ int late_predecessors(int key, const int* preds_j, const int* s_assign,
                                             const float* s_fin, const float* data_b,
                                             const float* dtr_b, int i, int N, int MAXP, int lane) {
  for (int q = 32 * kPre + lane; q < MAXP; q += 32) {
    const int p = preds_j[q];
    if (p >= 0) {
      const int pn = s_assign[p];
      const float tt = pn == i ? 0.0f : __fdiv_rn(data_b[p], dtr_b[static_cast<size_t>(pn) * N + i]);
      key = max(key, order_key(__fadd_rn(s_fin[p], tt)));
    }
  }
  return key;
}

// where a step's row comes from
enum RowSource { kFromLast = 0, kFromBefore = 1, kFromShared = 2, kFromRing = 3 };

template <int S, bool kRowsInSmem>
__global__ void __launch_bounds__(32 * kMaxWarps) population_makespan_kernel(
    const int* __restrict__ assign,                // [B, P, T]
    const float* __restrict__ durations,           // [B, T, N]
    const int* __restrict__ cores,                 // [B, T]
    const float* __restrict__ data,                // [B, T]
    const unsigned char* __restrict__ feasible,    // [B, T, N]
    const float* __restrict__ release,             // [B, T]
    const float* __restrict__ deadline,            // [B, T] or null
    const int* __restrict__ preds,                 // [B, T, MAXP], -1 padded
    const float* __restrict__ dtr,                 // [B, N, N]
    const float* __restrict__ init_free,           // [B, N, C]
    const unsigned short* __restrict__ init_rank,  // [B, N, CP], from init_ranks
    const int* __restrict__ node_cores,            // [B, N]
    float* __restrict__ makespan,                  // [B, P]
    float* __restrict__ violations,                // [B, P]
    float* __restrict__ core_free,                 // [B, P, N, CP] scratch (L2 path), else null
    unsigned short* __restrict__ core_rank,        // [B, P, N, CP] scratch (L2 path), else null
    int total, int P, int T, int N, int C, int MAXP) {
  constexpr int CP = 32 * S;  // the row padded to whole warps of slots
  constexpr int RW = rank_words(S);
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long cand = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (cand >= total) return;  // whole warps leave; no block barrier follows
  const int b = static_cast<int>(cand / P);

  float* ws = reinterpret_cast<float*>(smem4) + warp * warp_floats(T, N, S, kRowsInSmem);
  float* rows = ws;  // [N][CP] free times, then [N][CP] u16 ranks, when the rows live here
  unsigned short* rows_r = reinterpret_cast<unsigned short*>(rows + (kRowsInSmem ? N * CP : 0));
  float* vbuf = ws + (kRowsInSmem ? N * CP + (N * CP + 1) / 2 : 0);  // [CP] a row, to the warp
  float* rowf = vbuf + CP;                                           // [3][CP] prefetched rows
  unsigned* rowr = reinterpret_cast<unsigned*>(rowf + 3 * CP);        // [3][32][RW] their ranks
  int* s_assign = reinterpret_cast<int*>(rowr + 3 * 32 * RW);
  float* s_fin = reinterpret_cast<float*>(s_assign + T);
  int* ring_p = reinterpret_cast<int*>(s_fin + T);                      // [kRing + 1][kQ] predecessor
  float* ring_d = reinterpret_cast<float*>(ring_p + (kRing + 1) * kQ);  // its data
  float* ring_r = ring_d + (kRing + 1) * kQ;                            // its rate
  int* ring_s = reinterpret_cast<int*>(ring_r + (kRing + 1) * kQ);      // [kRing + 1][8] step values
  unsigned char* written = reinterpret_cast<unsigned char*>(ring_s + (kRing + 1) * 8);  // [N]

  const size_t tn = static_cast<size_t>(T) * N, nc = static_cast<size_t>(N) * C;
  const int* cores_b = cores + static_cast<size_t>(b) * T;
  const float* data_b = data + static_cast<size_t>(b) * T;
  const unsigned char* feas_b = feasible + b * tn;
  const float* rel_b = release + static_cast<size_t>(b) * T;
  const float* dl_b = deadline ? deadline + static_cast<size_t>(b) * T : nullptr;
  const int* preds_b = preds + static_cast<size_t>(b) * T * MAXP;
  const float* dtr_b = dtr + static_cast<size_t>(b) * N * N;
  const float* dur_b = durations + b * tn;
  const float* init_b = init_free + b * nc;
  const unsigned short* irank_b = init_rank + static_cast<size_t>(b) * N * CP;
  const int* ncores_b = node_cores + static_cast<size_t>(b) * N;
  const int* a = assign + cand * T;
  float* cf = kRowsInSmem ? nullptr : core_free + cand * N * CP;
  unsigned short* cr = kRowsInSmem ? nullptr : core_rank + cand * N * CP;
  const int s0 = S * lane;  // this lane's first slot

  for (int k = lane; k < T; k += 32) {
    s_assign[k] = a[k];
    s_fin[k] = 0.0f;
  }
  for (int n = lane; n < N; n += 32) written[n] = 0;
  __syncwarp();
  if (T == 0) {
    if (lane == 0) makespan[cand] = violations[cand] = 0.0f;
    return;
  }

  // Indices into one instance's tables and one candidate's rows fit 32 bits
  // (the wrapper checks).  What a step needs is fetched ahead with plain
  // loads into registers and stored one step later into the ring: slot
  // s % kRing of step s holds its predecessors and per-task values (A,
  // fetched five steps ahead), their data and rates and the node's values
  // (B, three steps ahead, which reads A's predecessors), and ring_s the
  // step's cores, release, deadline (A), duration, feasibility word and
  // node's core count (B), one lane fetching each; a node's row and ranks go
  // to prefetch slot s % 2, two steps ahead.  Every load is unconditional,
  // from a clamped address, and every store goes somewhere (slot kRing, row
  // slot 2 when nobody will read it), so the step has no branch for the
  // compiler to schedule around.
  struct Ahead {
    int p[kPre];             // A: predecessors of step sa
    float d[kPre], r[kPre];  // B: their data and rates, step sb
    int value;               // lanes 0-5: a per-step value of sa (0-2) or sb (3-5)
    float rv[S];             // the row of step sr, and its ranks
    unsigned rr[RW];
    int sa, sb, sr;          // the steps; >= T (sr < 0) for none
  };
  auto fetch = [&](int sa, int sb, int sr, int n) {
    Ahead f;
    f.sa = sa;
    f.sb = sb;
    f.sr = sr;
    const int ta = min(sa, T - 1), tb = min(sb, T - 1);
    const int ib = s_assign[tb];
#pragma unroll
    for (int k = 0; k < kPre; ++k) {
      const int q = lane + 32 * k;
      f.p[k] = *(MAXP > 0 ? preds_b + ta * MAXP + min(q, MAXP - 1) : cores_b);
      const int p = min(max(sb < T && q < MAXP ? ring_p[(sb & (kRing - 1)) * kQ + q] : 0, 0), T - 1);
      f.d[k] = data_b[p];
      f.r[k] = dtr_b[s_assign[p] * N + ib];
    }
    const int ti = tb * N + ib;
    const void* from = lane == 0   ? static_cast<const void*>(cores_b + ta)
                       : lane == 1 ? static_cast<const void*>(rel_b + ta)
                       : lane == 2 ? static_cast<const void*>((dl_b ? dl_b : rel_b) + ta)
                       : lane == 3 ? static_cast<const void*>(dur_b + ti)
                       : lane == 4 ? reinterpret_cast<const void*>(reinterpret_cast<uintptr_t>(feas_b + ti) & ~uintptr_t{3})
                       : lane == 5 ? static_cast<const void*>(ncores_b + ib)
                                   : static_cast<const void*>(cores_b);
    f.value = *static_cast<const int*>(from);
    // node n's row: from the scratch once the candidate has written it (L2
    // path), else the initial row
    const bool scratch = !kRowsInSmem && written[n];
#pragma unroll
    for (int k = 0; k < S; ++k)
      f.rv[k] = *(scratch ? cf + n * CP + s0 + k
                          : init_b + n * C + min(s0 + k, C - 1));
    const unsigned* rsrc = reinterpret_cast<const unsigned*>(
        (scratch ? cr : irank_b) + n * CP + (S > 1 ? s0 : s0 & ~1));
#pragma unroll
    for (int w = 0; w < RW; ++w) f.rr[w] = rsrc[w];
    return f;
  };
  auto store = [&](const Ahead& f) {
    const int sa = f.sa < T ? f.sa & (kRing - 1) : kRing, sb = f.sb < T ? f.sb & (kRing - 1) : kRing;
#pragma unroll
    for (int k = 0; k < kPre; ++k) {
      ring_p[sa * kQ + lane + 32 * k] = f.p[k];
      ring_d[sb * kQ + lane + 32 * k] = f.d[k];
      ring_r[sb * kQ + lane + 32 * k] = f.r[k];
    }
    ring_s[(lane < 3 ? sa : sb) * 8 + min(lane, 7)] = f.value;
    const int sr = f.sr >= 0 ? f.sr & 1 : 2;
#pragma unroll
    for (int k = 0; k < S; ++k) rowf[sr * CP + s0 + k] = f.rv[k];
#pragma unroll
    for (int w = 0; w < RW; ++w) rowr[(sr * 32 + lane) * RW + w] = f.rr[w];
  };
  // where step s (>= 1) takes its row from: the registers when one of the
  // two steps before used its node, the shared rows once written there,
  // else the prefetch slot, from node n (any node otherwise)
  auto plan_row = [&](int s, int& n) {
    const int m = s_assign[min(s, T - 1)];
    const bool last = s >= T || m == s_assign[s - 1];
    const bool before = !last && s >= 2 && m == s_assign[max(s - 2, 0)];
    const bool shared = !last && !before && kRowsInSmem && written[m];
    const int src = last ? kFromLast : before ? kFromBefore : shared ? kFromShared : kFromRing;
    n = src == kFromRing ? m : 0;
    return src;
  };
  // step s's predecessors and transfer times (0 on the same node), from its
  // stored B: p < 0 where there is none
  auto transfers = [&](int s, int (&p)[kPre], float (&tt)[kPre]) {
    const int i = s_assign[s];
#pragma unroll
    for (int k = 0; k < kPre; ++k) {
      const int q = lane + 32 * k;
      p[k] = q < MAXP ? ring_p[(s & (kRing - 1)) * kQ + q] : -1;
      const float div = __fdiv_rn(ring_d[(s & (kRing - 1)) * kQ + q], ring_r[(s & (kRing - 1)) * kQ + q]);
      tt[k] = p[k] >= 0 && s_assign[max(p[k], 0)] != i ? div : 0.0f;
    }
  };

  // prologue: A of steps 0-4, then B of 0-2 and the rows of steps 0 and 1
  for (int s = 0; s < 5; ++s) store(fetch(s, T, -1, 0));
  __syncwarp();
  for (int s = 0; s < 3; ++s) store(fetch(T, s, -1, 0));
  store(fetch(T, T, 0, s_assign[0]));
  int n1;
  int src = kFromRing, src1 = plan_row(1, n1);
  store(fetch(T, T, src1 == kFromRing ? 1 : -1, n1));
  __syncwarp();
  int pc[kPre];  // this step's predecessors and transfer times
  float ttc[kPre];
  transfers(0, pc, ttc);
  Ahead ahead = fetch(T, T, -1, 0);  // loads of the step before, stored at the top of this one

  float v[S], v1[S], v2[S];  // this step's row; the rows the last two steps left
  int r[S], r1[S], r2[S];    // and their ranks
#pragma unroll
  for (int k = 0; k < S; ++k) {
    v1[k] = v2[k] = 0.0f;
    r1[k] = r2[k] = 0;
  }
  int viol = 0;
  float mk = 0.0f;
  for (int j = 0; j < T; ++j) {
    store(ahead);
    __syncwarp();
    const int i = s_assign[j];
    const int* rs = ring_s + (j & (kRing - 1)) * 8;

    // this step's row and ranks
    const float* fv = src == kFromShared ? rows + i * CP + s0 : rowf + (j & 1) * CP + s0;
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const float loaded = s0 + k < C ? fv[k] : INFINITY;
      const unsigned w = rowr[((j & 1) * 32 + lane) * RW + (S > 1 ? k / 2 : 0)];
      const int ring_rank = (S > 1 ? k & 1 : lane & 1) ? w >> 16 : w & 0xffffu;
      const int shared_rank = kRowsInSmem ? rows_r[i * CP + s0 + k] : 0;
      v[k] = src == kFromLast ? v1[k] : src == kFromBefore ? v2[k] : loaded;
      r[k] = src == kFromLast ? r1[k] : src == kFromBefore ? r2[k] : src == kFromShared ? shared_rank : ring_rank;
    }

    // fetch ahead: the row of step j + 2 (unless one of the two steps
    // before it uses its node), B of j + 3 and A of j + 5
    int n2;
    const int src2 = plan_row(j + 2, n2);
    ahead = fetch(j + 5, j + 3, src2 == kFromRing ? j + 2 : -1, n2);

    // ready time (Eq. 12 with the Eq. 5 transfer): max over the
    // predecessors of fin[p] + tt, as order keys
    int rkey = order_key(kNeg);
#pragma unroll
    for (int k = 0; k < kPre; ++k) {
      const int key = order_key(__fadd_rn(s_fin[max(pc[k], 0)], ttc[k]));
      rkey = pc[k] >= 0 ? max(rkey, key) : rkey;
    }
    if (MAXP > kQ)
      rkey = late_predecessors(rkey, preds_b + j * MAXP, s_assign, s_fin, data_b, dtr_b, i,
                               N, MAXP, lane);
    const float ready = nan_max(__int_as_float(rs[1]), from_key(__reduce_max_sync(kAll, rkey)));

    // the c-th smallest off the ranks: the masked sum of the reference, so
    // NaN if a NaN holds rank c - 1, else the one slot that does, else 0
    const int c = max(min(rs[0], rs[5]), 1);
    bool nan_hit = false, hit = false, row_nan = false;
    float hv = 0.0f;
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const bool real = s0 + k < C, nan = v[k] != v[k], at = real && r[k] == c - 1;
      row_nan |= real && nan;
      nan_hit |= at && nan;
      hit |= at && !nan;
      hv = at && !nan ? v[k] : hv;
    }
    const unsigned hits = __ballot_sync(kAll, hit);
    const float kth0 = __shfl_sync(kAll, hv, hits ? __ffs(hits) - 1 : 0);
    const float kth = __any_sync(kAll, nan_hit) ? __int_as_float(0x7fffffff) : __fadd_rn(hits ? kth0 : 0.0f, 0.0f);
    const float f = __fadd_rn(nan_max(ready, kth), __int_as_float(rs[3]));

    // overwrite the c smallest with f, and rank the new row: by ballots
    // where the row holds no NaN, else by comparisons
    unsigned over[S], less[S], same[S];  // lanes whose slot k is overwritten; kept and below f; kept and equal
    int n_over = 0, n_less = 0;
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const bool real = s0 + k < C, o = real && r[k] < c;
      over[k] = __ballot_sync(kAll, o);
      less[k] = __ballot_sync(kAll, real && !o && v[k] < f);
      same[k] = __ballot_sync(kAll, real && !o && v[k] == f);
      n_over += __popc(over[k]);
      n_less += __popc(less[k]);
    }
    const unsigned below = (1u << lane) - 1u;  // the lanes before this one
#pragma unroll
    for (int k = 0; k < S; ++k) {
      // overwritten and kept-equal slots before slot s0 + k
      int over_before = 0, same_before = 0;
#pragma unroll
      for (int k2 = 0; k2 < S; ++k2) {
        over_before += __popc(over[k2] & below) + (k2 < k ? (over[k2] >> lane) & 1 : 0);
        same_before += __popc(same[k2] & below) + (k2 < k ? (same[k2] >> lane) & 1 : 0);
      }
      const bool o = (over[k] >> lane) & 1;
      const int kept = r[k] + (f < v[k] ? 0 : (f == v[k] ? over_before : 0) - n_over);
      r[k] = o ? n_less + same_before + over_before : kept;
      v[k] = o ? f : v[k];
    }
    if (__any_sync(kAll, row_nan) || f != f) {
#pragma unroll
      for (int k = 0; k < S; ++k) vbuf[s0 + k] = v[k];
      __syncwarp();
#pragma unroll
      for (int k = 0; k < S; ++k) r[k] = comparison_rank(vbuf, C, s0 + k, v[k]);
      __syncwarp();  // vbuf is read
    }

    // write the row back
#pragma unroll
    for (int k = 0; k < S; ++k) {
      if (s0 + k < C) {
        if (kRowsInSmem) {
          rows[i * CP + s0 + k] = v[k];
          rows_r[i * CP + s0 + k] = static_cast<unsigned short>(r[k]);
        } else {
          cf[i * CP + s0 + k] = v[k];
          cr[i * CP + s0 + k] = static_cast<unsigned short>(r[k]);
        }
      }
    }
    written[i] = 1;
    if (lane == 0) s_fin[j] = f;
    mk = nan_max(mk, f);
    const uintptr_t feas_at = reinterpret_cast<uintptr_t>(feas_b + j * N + i);
    viol += ((static_cast<unsigned>(rs[4]) >> (8 * (feas_at & 3))) & 0xffu) == 0;
    viol += dl_b != nullptr && f > __int_as_float(rs[2]);

    // the next step's transfer times, off its chain
    transfers(min(j + 1, T - 1), pc, ttc);
#pragma unroll
    for (int k = 0; k < S; ++k) {
      v2[k] = v1[k];
      r2[k] = r1[k];
      v1[k] = v[k];
      r1[k] = r[k];
    }
    src = src1;
    src1 = src2;
  }
  if (lane == 0) {
    makespan[cand] = mk;
    violations[cand] = static_cast<float>(viol);
  }
}

template <int S, bool kRowsInSmem>
cudaError_t launch(const void* assign, const void* durations, const void* cores, const void* data,
                   const void* feasible, const void* release, const void* deadline, const void* preds,
                   const void* dtr, const void* init_free, void* init_rank, const void* node_cores,
                   void* makespan, void* violations, void* core_free, void* core_rank, int B, int P,
                   int T, int N, int C, int MAXP, int warps, long long smem, cudaStream_t stream) {
  constexpr int CP = 32 * S;
  auto kernel = population_makespan_kernel<S, kRowsInSmem>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const long long ranks = static_cast<long long>(B) * N * CP;
  population_makespan_init_ranks<<<static_cast<unsigned>((ranks + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(init_free), static_cast<unsigned short*>(init_rank),
      static_cast<long long>(B) * N, C, CP);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long total = static_cast<long long>(B) * P;
  const unsigned blocks = static_cast<unsigned>((total + warps - 1) / warps);
  kernel<<<blocks, 32 * warps, static_cast<size_t>(smem), stream>>>(
      static_cast<const int*>(assign), static_cast<const float*>(durations),
      static_cast<const int*>(cores), static_cast<const float*>(data),
      static_cast<const unsigned char*>(feasible), static_cast<const float*>(release),
      static_cast<const float*>(deadline), static_cast<const int*>(preds),
      static_cast<const float*>(dtr), static_cast<const float*>(init_free),
      static_cast<const unsigned short*>(init_rank), static_cast<const int*>(node_cores),
      static_cast<float*>(makespan), static_cast<float*>(violations), static_cast<float*>(core_free),
      static_cast<unsigned short*>(core_rank), static_cast<int>(total), P, T, N, C, MAXP);
  return cudaGetLastError();
}

template <bool kRowsInSmem, typename... Args>
cudaError_t launch_slots(int slots, Args... args) {
  switch (slots) {
    case 1: return launch<1, kRowsInSmem>(args...);
    case 2: return launch<2, kRowsInSmem>(args...);
    case 4: return launch<4, kRowsInSmem>(args...);
    case 8: return launch<8, kRowsInSmem>(args...);
    case 16: return launch<16, kRowsInSmem>(args...);
    case 32: return launch<32, kRowsInSmem>(args...);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Dynamic shared memory of one warp (one candidate) for T tasks, N nodes
// and `slots` core slots a lane, with the rows in shared memory or not.
extern "C" long long population_makespan_warp_smem(int T, int N, int slots, int rows_in_smem) {
  return 4 * warp_floats(T, N, slots, rows_in_smem);
}

// Most dynamic shared memory a block of this kernel may ask for on the
// current device (the opt-in limit less its static shared memory).  A CUDA
// error comes back negated.
extern "C" long long population_makespan_max_smem() {
  int dev = 0, optin = 0;
  cudaFuncAttributes attr;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, population_makespan_kernel<2, true>);
  if (e != cudaSuccess) return -static_cast<long long>(e);
  return static_cast<long long>(optin) - static_cast<long long>(attr.sharedSizeBytes);
}

// Launches on `stream` and returns cudaGetLastError(); 0 means launched.
// Two device kernels: the initial rows' ranks into `init_rank` [B, N, 32 *
// slots] (u16), then the schedule.  `slots` core slots a lane (32 * slots
// >= C; 1, 2, 4, ..., 32), `warps` candidates a block, `rows_in_smem` the
// rows' place (else `core_free` f32 and `core_rank` u16, both [B, P, N, 32 *
// slots], are the scratch), `smem` the block's dynamic shared memory: the
// plan of makespan.py::makespan_plan, checked here.
extern "C" int population_makespan(
    const void* assign, const void* durations, const void* cores, const void* data,
    const void* feasible, const void* release, const void* deadline, const void* preds,
    const void* dtr, const void* init_free, void* init_rank, const void* node_cores, void* makespan,
    void* violations, void* core_free, void* core_rank, int B, int P, int T, int N, int C, int MAXP,
    int slots, int warps, int rows_in_smem, long long smem, void* stream) {
  if (32 * slots < C || warps < 1 || warps > kMaxWarps || init_rank == nullptr ||
      smem < warps * population_makespan_warp_smem(T, N, slots, rows_in_smem) ||
      (!rows_in_smem && (core_free == nullptr || core_rank == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      rows_in_smem
          ? launch_slots<true>(slots, assign, durations, cores, data, feasible, release, deadline,
                               preds, dtr, init_free, init_rank, node_cores, makespan, violations,
                               core_free, core_rank, B, P, T, N, C, MAXP, warps, smem, s)
          : launch_slots<false>(slots, assign, durations, cores, data, feasible, release, deadline,
                                preds, dtr, init_free, init_rank, node_cores, makespan, violations,
                                core_free, core_rank, B, P, T, N, C, MAXP, warps, smem, s);
  return static_cast<int>(e);
}

extern "C" const char* cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
