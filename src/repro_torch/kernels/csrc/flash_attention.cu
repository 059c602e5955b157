// Flash attention for prefill: blockwise online-softmax attention with GQA,
// causal masking at an offset, a sliding window and a logit softcap.
//
// Replaces the TPU kernel flash_attention_pallas (_flash_kernel) in
// src/repro/kernels/flash_attention.py.  Its plain PyTorch version is
// flash_attention_ref in src/repro_torch/kernels/flash_attention.py.
//
// What it computes, for q [B, H, Sq, D] and k, v [B, Hkv, Skv, D]: query row
// r sits at kv position r + (Skv - Sq); it sees column c when c <= r + off
// (causal) and c > r + off - window (window); logits are q.k * scale (the
// caller's, D^-0.5 by default), then
// softcap * tanh(s / softcap); the running max, sum and accumulator are f32;
// a row that sees nothing (l == 0) gives zeros.  Unlike the TPU kernel it
// takes any Sq and Skv.  Fully masked kv tiles are skipped, as the TPU
// kernel's pl.when does.
//
// Head widths.  The TPU kernel takes any D; this one takes every D that is
// a multiple of 8 from 8 to 256, so that a bf16 row is whole 16-byte units
// (TMA's row stride).  Each kernel is built
// for a padded width DP of 64, 128, 192 or 256 columns, the true D a
// runtime argument: the columns from D to DP are zeros in shared memory and
// are never stored, so the k16 steps of wgmma past D multiply zeros.  The bf16 kernel's products both run over DP, so at
// zamba2-7b's D 112 (DP 128) it does 8/7 of the products the function
// needs: stopping the Q K^T steps at D on a runtime condition made ptxas
// put warpgroup.arrive between the products and spill at DP 256.
//
// What bounds it on an H100.  The function needs 4 * D operations per
// visible (query, key) pair and head, and reads q, k, v once and writes o
// once.  At a prefill of qwen2.5-3b (H 16, Hkv 2, D 128) the operations at
// the bf16 tensor-core rate (989 TFLOP/s) outweigh the bytes from about 600
// tokens up, so the bound is operations, and only the tensor cores can
// approach it: the f32 CUDA cores peak at 67 TFLOP/s.
//
// bfloat16: wgmma fed by TMA (flash_attention_kernel_bf16_wgmma).  A block
// is one consumer warpgroup, which owns 64 query rows, and one producer
// warp.  At DP 64 and 128 two blocks share an SM, so one block's softmax
// overlaps the other's products; at DP 192 the shared memory (121 KB) and
// at DP 256 the O accumulator (128 registers a thread) leave room for one.  The producer loads the query tile once
// and then each visible 64-key tile of k and v with TMA
// (cp.async.bulk.tensor, 128-byte swizzle) into a ring of two stages,
// signalled by mbarriers, so the next tile's loads overlap the current
// tile's products.  The tensor maps are built over the 3-D views
// [B*H, Sq, D] and [B*Hkv, Skv, D]: rows past Sq or Skv arrive as zeros and
// never as the next head's rows.  The consumer computes
// S = Q K^T with wgmma m64n64k16 (q and k are both K-major, D contiguous),
// DP/16 steps, each 128-byte box of a row reached through the descriptor's
// start address.  A row of D columns arrives as ceil(D/64) boxes of 64: the
// tensor maps' width is D, so the columns of the last box past D (all but
// 8 of them at D 8) are filled with zeros by TMA.  The f32 S fragment
// holds, per thread, two rows' values at the columns of the next product's
// register A fragment, so a row's max and sum are two shuffles across a
// quad, and P goes to O += P V straight from registers; V [keys, D] is the
// MN-major B operand (wgmma's transpose bit).  O stays in f32 registers, 32
// per thread for each 64 columns of DP; the store skips the columns past D.
// Tiles wholly inside the visible band skip the per-element mask.  Blocks
// start with the last query tiles, which under the causal mask see the most
// keys.
//
// Precision.  chip_smoke.py holds a bf16 output within 2e-5 + 2^-8 |y| of
// the plain version run in f32, and rounding the output to bf16 alone takes
// up to 2^-8 |y|, so the f32 result before that rounding has to agree to
// about 2e-5.  Products of bf16 values are exact in the f32 accumulator, so
// q is not pre-scaled in bf16 (1/sqrt(128) is no power of two): the f32
// logits are scaled after the product, which differs from the plain
// version's (q * scale) . k by f32 rounding only.  P is not rounded to bf16
// alone (2^-9 relative per element, the order of the bound): it is split as
// p_hi = bf16(p), p_lo = bf16(p - p_hi), and O += p_hi V + p_lo V holds p to
// about 2^-17, at 1.5 times the products of a single-P kernel, still on the
// tensor cores.  Max, sum and accumulator stay f32; expf with no fast math.
//
// float32: the CUDA-core kernel (flash_attention_kernel).  TF32
// tensor cores keep about 10 bits and cannot meet the f32 bound of 2e-5.  One
// block of 128 threads per (query tile, head, batch) loops over the visible
// kv tiles; tiles are loaded with 16-byte vector loads into f32 shared memory
// (rows padded by one float); threads form 16 row groups of 8 lanes, so a
// row's max and sum are three shuffles inside one warp; the accumulator
// stays in registers, and DP over 128 halves the tile height to fit it.  The
// loops over D stop at the true width.

#include <cuda.h>  // CUtensorMap and its enums; cuTensorMapEncodeTiled is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "hopper.cuh"
#include "rows.cuh"

namespace {

constexpr float kNeg = -1e30f;

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kThreads = 128;  // 16 row groups x 8 lanes

template <int DP>
struct Tile {
  static constexpr int BQ = DP > 128 ? 32 : 64;  // query rows per block
  static constexpr int BK = BQ;                  // kv rows per tile
  static constexpr int RM = BQ / 16;             // rows per thread
  static constexpr int CN = BK / 8;              // score columns per thread
  static constexpr int DN = DP / 8;              // output columns per thread, the first D / 8 real
  static constexpr int QS = DP + 1;              // padded row stride of q and k
  static constexpr int PS = BK + 1;              // padded row stride of p
  static constexpr size_t smem = sizeof(float) * (BQ * QS + BK * QS + BK * DP + BQ * PS);
};

__device__ __forceinline__ float group_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
}

__device__ __forceinline__ float group_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 4);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const T* __restrict__ q,  // [B, H, Sq, D]
    const T* __restrict__ k,  // [B, Hkv, Skv, D]
    const T* __restrict__ v,  // [B, Hkv, Skv, D]
    T* __restrict__ o,        // [B, H, Sq, D]
    int H, int Hkv, int Sq, int Skv, int D, int causal, int window, float softcap, float scale) {
  using C = Tile<DP>;
  extern __shared__ float smem[];
  float* qs = smem;                 // [BQ][QS]
  float* ks = qs + C::BQ * C::QS;   // [BK][QS]
  float* vs = ks + C::BK * C::QS;   // [BK][DP]
  float* ps = vs + C::BK * DP;      // [BQ][PS]

  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.x * C::BQ;
  const int rg = threadIdx.x >> 3, cg = threadIdx.x & 7;
  const int dn = (D - cg + 7) / 8;  // this thread's real output columns: cg + 8 j < D
  const int off = Skv - Sq;  // kv position of query row 0
  const T* qb = q + (static_cast<size_t>(b) * H + h) * Sq * D;
  const T* kb = k + (static_cast<size_t>(b) * Hkv + hk) * Skv * D;
  const T* vb = v + (static_cast<size_t>(b) * Hkv + hk) * Skv * D;
  T* ob = o + (static_cast<size_t>(b) * H + h) * Sq * D;

  load_rows(qs, C::QS, qb + static_cast<size_t>(q0) * D, C::BQ, D, Sq - q0, scale);

  // the kv columns any real row of this tile can see
  const int row_first = q0 + off;
  const int row_last = min(q0 + C::BQ, Sq) - 1 + off;
  const int col_begin = window > 0 ? max(0, row_first - window + 1) : 0;
  const int col_end = causal ? min(Skv, row_last + 1) : Skv;
  const int kt_begin = col_begin / C::BK;
  const int kt_end = col_end > col_begin ? (col_end + C::BK - 1) / C::BK : kt_begin;

  float m[C::RM], l[C::RM], acc[C::RM][C::DN];
#pragma unroll
  for (int i = 0; i < C::RM; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < C::DN; ++j) acc[i][j] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int c0 = kt * C::BK;
    __syncthreads();  // the previous tile is consumed (and q is loaded)
    load_rows(ks, C::QS, kb + static_cast<size_t>(c0) * D, C::BK, D, Skv - c0, 1.f);
    load_rows(vs, DP, vb + static_cast<size_t>(c0) * D, C::BK, D, Skv - c0, 1.f);
    __syncthreads();

    float s[C::RM][C::CN];
#pragma unroll
    for (int i = 0; i < C::RM; ++i)
#pragma unroll
      for (int j = 0; j < C::CN; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[C::RM], kv[C::CN];
#pragma unroll
      for (int i = 0; i < C::RM; ++i) qv[i] = qs[(rg * C::RM + i) * C::QS + d];
#pragma unroll
      for (int j = 0; j < C::CN; ++j) kv[j] = ks[(cg + 8 * j) * C::QS + d];
#pragma unroll
      for (int i = 0; i < C::RM; ++i)
#pragma unroll
        for (int j = 0; j < C::CN; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < C::RM; ++i) {
      const int r = rg * C::RM + i;
      const int rk = q0 + r + off;  // this row's position in kv coordinates
      unsigned vis = 0;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < C::CN; ++j) {
        const int col = c0 + cg + 8 * j;
        bool ok = col < Skv && q0 + r < Sq;
        if (causal) ok = ok && col <= rk;
        if (window > 0) ok = ok && col > rk - window;
        float x = s[i][j];
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        s[i][j] = ok ? x : kNeg;
        vis |= static_cast<unsigned>(ok) << j;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(mx));
      const float corr = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < C::CN; ++j) {
        const float p = (vis >> j) & 1u ? expf(s[i][j] - m_new) : 0.f;
        ps[r * C::PS + cg + 8 * j] = p;
        psum += p;
      }
      l[i] = corr * l[i] + group_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < C::DN; ++j) acc[i][j] *= corr;
    }
    __syncwarp();  // a row's probabilities come from the 8 lanes of its own warp

#pragma unroll 4
    for (int c = 0; c < C::BK; ++c) {
      float pv[C::RM];
#pragma unroll
      for (int i = 0; i < C::RM; ++i) pv[i] = ps[(rg * C::RM + i) * C::PS + c];
#pragma unroll
      for (int j = 0; j < C::DN; ++j) {
        if (j >= dn) break;
        const float vv = vs[c * DP + cg + 8 * j];
#pragma unroll
        for (int i = 0; i < C::RM; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < C::RM; ++i) {
    const int row = q0 + rg * C::RM + i;
    if (row >= Sq) continue;
    const float li = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int j = 0; j < C::DN; ++j)
      if (j < dn) store(ob + static_cast<size_t>(row) * D + cg + 8 * j, acc[i][j] / li);
  }
}

// ---------------------------------------------------------------------------
// bfloat16: wgmma fed by TMA
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;              // query rows per block: one warpgroup's wgmma M
constexpr int kBK = 64;              // keys per tile
constexpr int kStages = 2;           // k/v tiles in flight
constexpr int kBox = 64;             // bf16 columns per 128-byte TMA box
constexpr int kTcThreads = 128 + 32;  // the consumer warpgroup, then the producer warp

template <int DP>
struct TcTile {
  static constexpr int kBoxes = DP / kBox;
  static constexpr int kQBytes = kBQ * DP * 2;
  static constexpr int kKVBytes = kBK * DP * 2;  // one k or v tile
  // [q][k0][v0][k1][v1] from a 1024-byte boundary (the swizzle's period),
  // then the mbarriers
  static constexpr int kBars = kQBytes + 2 * kStages * kKVBytes;
  static constexpr size_t smem = 1024 + kBars + 8 * (1 + 2 * kStages);
};

template <int DP>
__global__ void __launch_bounds__(kTcThreads, 1) flash_attention_kernel_bf16_wgmma(
    const __grid_constant__ CUtensorMap q_map,  // [B*H, Sq, D]
    const __grid_constant__ CUtensorMap k_map,  // [B*Hkv, Skv, D]
    const __grid_constant__ CUtensorMap v_map,  // [B*Hkv, Skv, D]
    __nv_bfloat16* __restrict__ o,              // [B, H, Sq, D]
    int H, int Hkv, int Sq, int Skv, int D, int causal, int window, float softcap, float scale) {
  using C = TcTile<DP>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base;
  auto sk = [&](int s) { return base + C::kQBytes + 2u * s * C::kKVBytes; };
  auto sv = [&](int s) { return sk(s) + C::kKVBytes; };
  const uint32_t q_full = base + C::kBars;
  auto full = [&](int s) { return q_full + 8u * (1 + s); };
  auto empty = [&](int s) { return q_full + 8u * (1 + kStages + s); };

  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // the longest rows first
  const int off = Skv - Sq;  // kv position of query row 0

  // the kv columns any real row of this tile can see
  const int row_first = q0 + off;
  const int row_last = min(q0 + kBQ, Sq) - 1 + off;
  const int col_begin = window > 0 ? max(0, row_first - window + 1) : 0;
  const int col_end = causal ? min(Skv, row_last + 1) : Skv;
  const int kt_begin = col_begin / kBK;
  const int n_tiles = col_end > col_begin ? (col_end + kBK - 1) / kBK - kt_begin : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128) {  // the producer warp: one lane issues every load
    if (threadIdx.x == 128) {
      mbar_expect_tx(q_full, C::kQBytes);
      for (int x = 0; x < C::kBoxes; ++x)
        tma_load(sq + x * kBQ * 128, &q_map, q_full, x * kBox, q0, b * H + h);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        mbar_wait(empty(s), ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * C::kKVBytes);
        const int c0 = (kt_begin + it) * kBK;
        for (int x = 0; x < C::kBoxes; ++x) {
          tma_load(sk(s) + x * kBK * 128, &k_map, full(s), x * kBox, c0, b * Hkv + hk);
          tma_load(sv(s) + x * kBK * 128, &v_map, full(s), x * kBox, c0, b * Hkv + hk);
        }
      }
    }
    return;
  }

  // the consumer warpgroup: thread t holds rows r and r + 8 of the tile
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = 16 * warp + lane / 4;
  const int quad = 2 * (lane % 4);  // first of this thread's two columns in each 8
  const int pos0 = q0 + r + off, pos1 = pos0 + 8;

  float acc[C::kBoxes][32];
#pragma unroll
  for (int x = 0; x < C::kBoxes; ++x)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[x][i] = 0.f;
  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;

  mbar_wait(q_full, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages;
    const int c0 = (kt_begin + it) * kBK;
    mbar_wait(full(s), (it / kStages) & 1);

    // S = Q K^T over DP / 16 steps: those past D multiply zeros
    float sc[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t step = (kk % 4) * 32u;  // 16 columns into the 128-byte box
      wgmma_ss(sc, smem_desc(sq + (kk / 4) * kBQ * 128 + step),
               smem_desc(sk(s) + (kk / 4) * kBK * 128 + step), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // scale after the product, softcap, then the mask where the tile needs it
    const bool inside = c0 + kBK <= Skv && (!causal || c0 + kBK - 1 <= row_first) &&
                        (window <= 0 || c0 > row_last - window);
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = sc[i] * scale;
      if (softcap > 0.f) x = softcap * tanhf(x / softcap);
      if (!inside) {
        const int col = c0 + 8 * (i / 4) + quad + (i & 1);
        const int pos = (i & 2) ? pos1 : pos0;
        bool ok = col < Skv;
        if (causal) ok = ok && col <= pos;
        if (window > 0) ok = ok && col > pos - window;
        if (!ok) x = -INFINITY;
      }
      sc[i] = x;
      if (i & 2)
        mx1 = fmaxf(mx1, x);
      else
        mx0 = fmaxf(mx0, x);
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);  // finite: m starts at kNeg
    const float corr0 = expf(m0 - mn0), corr1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;

    // p = exp(s - m) (0 where masked), its row sums, and P as two bf16
    // register fragments: p_hi + p_lo
    float ps0 = 0.f, ps1 = 0.f;
    uint32_t p_hi[kBK / 16][4], p_lo[kBK / 16][4];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const float a = expf(sc[i] - ((i & 2) ? mn1 : mn0));
      const float c = expf(sc[i + 1] - ((i & 2) ? mn1 : mn0));
      if (i & 2)
        ps1 += a + c;
      else
        ps0 += a + c;
      const __nv_bfloat162 hi = __floats2bfloat162_rn(a, c);
      const float2 hf = __bfloat1622float2(hi);
      p_hi[i / 8][(i % 8) / 2] = bf16x2_bits(hi);
      p_lo[i / 8][(i % 8) / 2] = bf16x2_bits(__floats2bfloat162_rn(a - hf.x, c - hf.y));
    }
    ps0 += __shfl_xor_sync(0xffffffffu, ps0, 1);
    ps0 += __shfl_xor_sync(0xffffffffu, ps0, 2);
    ps1 += __shfl_xor_sync(0xffffffffu, ps1, 1);
    ps1 += __shfl_xor_sync(0xffffffffu, ps1, 2);
    l0 = corr0 * l0 + ps0;
    l1 = corr1 * l1 + ps1;

    // O = corr O + p_hi V + p_lo V, 64 columns of DP at a time
#pragma unroll
    for (int x = 0; x < C::kBoxes; ++x) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[x][i] *= (i & 2) ? corr1 : corr0;
      fence_regs(acc[x]);
    }
    wgmma_fence();
#pragma unroll
    for (int x = 0; x < C::kBoxes; ++x) {
#pragma unroll
      for (int kc = 0; kc < kBK / 16; ++kc) {
        const uint64_t vd = smem_desc(sv(s) + x * kBK * 128 + kc * 16 * 128);
        wgmma_rs(acc[x], p_hi[kc], vd);
        wgmma_rs(acc[x], p_lo[kc], vd);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int x = 0; x < C::kBoxes; ++x) fence_regs(acc[x]);
    mbar_arrive(empty(s));  // this thread's products have read the stage
  }

  const float inv0 = 1.f / (l0 == 0.f ? 1.f : l0), inv1 = 1.f / (l1 == 0.f ? 1.f : l1);
  __nv_bfloat16* ob = o + (static_cast<size_t>(b) * H + h) * Sq * D;
  const int row0 = q0 + r, row1 = row0 + 8;
#pragma unroll
  for (int x = 0; x < C::kBoxes; ++x) {
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int row = (i & 2) ? row1 : row0;
      const float inv = (i & 2) ? inv1 : inv0;
      const int col = x * kBox + 8 * (i / 4) + quad;  // even, as D is: a pair is in or out
      if (row < Sq && col < D) {
        *reinterpret_cast<__nv_bfloat162*>(ob + static_cast<size_t>(row) * D + col) =
            __floats2bfloat162_rn(acc[x][i] * inv, acc[x][i + 1] * inv);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, found through the CUDA runtime's entry-point
// query, so the library needs no -lcuda.  Null where CUDA lacks it.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                                                    : nullptr;
  }();
  return fn;
}

// A map of the bf16 tensor [planes, rows, D] in boxes of 64 rows x 64
// columns, 128-byte swizzled; rows and columns past the end read as zeros
// (a box is wider than D at D < 64).
bool bf16_map(CUtensorMap* map, const void* base, int D, int rows, int planes) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(planes)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(rows) * D * 2};
  const cuuint32_t box[3] = {kBox, 64, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DP>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, int B, int H,
                        int Hkv, int Sq, int Skv, int D, int causal, int window, float softcap,
                        float scale, cudaStream_t stream) {
  using C = TcTile<DP>;
  if (Skv == 0)  // no row sees a key
    return cudaMemsetAsync(o, 0, static_cast<size_t>(B) * H * Sq * D * 2, stream);
  if (encode_tiled() == nullptr) return cudaErrorNotSupported;
  CUtensorMap qm, km, vm;
  if (!bf16_map(&qm, q, D, Sq, B * H) || !bf16_map(&km, k, D, Skv, B * Hkv) ||
      !bf16_map(&vm, v, D, Skv, B * Hkv))
    return cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(flash_attention_kernel_bf16_wgmma<DP>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(C::smem));
  if (e != cudaSuccess) return e;
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel_bf16_wgmma<DP><<<grid, kTcThreads, C::smem, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), H, Hkv, Sq, Skv, D, causal, window, softcap,
      scale);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int B, int H, int Hkv,
                       int Sq, int Skv, int D, int causal, int window, float softcap,
                       float scale, cudaStream_t stream) {
  using C = Tile<DP>;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_attention_kernel<float, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::smem));
  if (e != cudaSuccess) return e;
  const dim3 grid((Sq + C::BQ - 1) / C::BQ, H, B);
  flash_attention_kernel<float, DP><<<grid, kThreads, C::smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), H, Hkv, Sq, Skv, D, causal, window, softcap, scale);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch(int bf16, const void* q, const void* k, const void* v, void* o, int B, int H,
                   int Hkv, int Sq, int Skv, int D, int causal, int window, float softcap,
                   float scale, cudaStream_t stream) {
  return bf16 ? launch_bf16<DP>(q, k, v, o, B, H, Hkv, Sq, Skv, D, causal, window, softcap, scale, stream)
              : launch_f32<DP>(q, k, v, o, B, H, Hkv, Sq, Skv, D, causal, window, softcap, scale, stream);
}

}  // namespace

// Head widths the kernel takes: multiples of 8 from 8 to 256.
extern "C" int flash_attention_supports(int D) { return takes_head_dim(D); }

// Dynamic shared memory of one block at head width D, for bf16 (wgmma) or
// f32 (CUDA cores) tensors; 0 for a width the kernel does not take.
extern "C" long long flash_attention_smem(int D, int bf16) {
  if (!flash_attention_supports(D)) return 0;
  switch (padded_width(D)) {
    case 64: return bf16 ? TcTile<64>::smem : Tile<64>::smem;
    case 128: return bf16 ? TcTile<128>::smem : Tile<128>::smem;
    case 192: return bf16 ? TcTile<192>::smem : Tile<192>::smem;
    default: return bf16 ? TcTile<256>::smem : Tile<256>::smem;
  }
}

// Launches on `stream` and returns cudaGetLastError(); 0 means launched.
// bf16 != 0: bfloat16 tensors (the wgmma kernel), else float32 (the
// CUDA-core kernel).  window <= 0: no window; softcap <= 0: no softcap;
// scale multiplies the logits (the wrapper passes D^-0.5 unless asked).
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* o, int B, int H,
                               int Hkv, int Sq, int Skv, int D, int bf16, int causal, int window,
                               float softcap, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!flash_attention_supports(D)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  switch (padded_width(D)) {
    case 64: e = launch<64>(bf16, q, k, v, o, B, H, Hkv, Sq, Skv, D, causal, window, softcap, scale, s); break;
    case 128: e = launch<128>(bf16, q, k, v, o, B, H, Hkv, Sq, Skv, D, causal, window, softcap, scale, s); break;
    case 192: e = launch<192>(bf16, q, k, v, o, B, H, Hkv, Sq, Skv, D, causal, window, softcap, scale, s); break;
    default: e = launch<256>(bf16, q, k, v, o, B, H, Hkv, Sq, Skv, D, causal, window, softcap, scale, s);
  }
  return static_cast<int>(e);
}

extern "C" const char* cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
