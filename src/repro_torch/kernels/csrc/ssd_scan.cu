// Mamba2 SSD (state-space duality) chunked scan: y and the final state of
//
//   S_t = exp(dt_t A_h) S_{t-1} + dt_t x_t B_tᵀ ;   y_t = S_t C_t
//
// from a zero state, for x [B, L, H, P], dt [B, L, H] f32, A [H] f32 and
// B, C [B, L, G, N], head h reading group g = h / (H / G) of B and C; y is
// [B, L, H, P] in x's type, the final state [B, H, P, N] f32.
//
// Replaces the TPU kernel ssd_scan_pallas (_ssd_kernel) in
// src/repro/kernels/ssd_scan.py.  Its plain PyTorch version is ssd_scan_ref
// in src/repro_torch/kernels/ssd_scan.py; the two agree to f32 rounding in
// f32, and within the bounds below in bf16.
//
// What it computes per chunk of Q steps, as the TPU kernel does: acs,
// the inclusive cumulative sum of dt * A; M[i][j] = (C_i . B_j)
// exp(acs_i - acs_j) dt_j for j <= i, else 0; y_i = sum_j M[i][j] x_j +
// exp(acs_i) C_i Sᵀ with S the state entering the chunk; then S <-
// exp(acs_Q) S + sum_j x_jᵀ B_j exp(acs_Q - acs_j) dt_j.  The exponent
// acs_i - acs_j is taken only where j <= i, where it is <= 0 (it would
// overflow above the diagonal).  Unlike the TPU kernel it takes any L: past
// L it loads x = B = C = 0 and dt = 0, so a padded step decays by exp(0) = 1
// and adds nothing, and the final state is exact.
//
// What bounds it on an H100.  The function needs about 4 P N operations per
// (batch, step, head) and reads x, B, C and dt once, writes y and the state
// once: at a mamba2-780m prefill (H 48, P 64, N 128, G 1) in bf16 the bytes
// (about 15 B per step and head) outweigh the operations at the bf16 tensor
// rate, so the bound is bytes, a few microseconds.  The chunked form does
// about Q / 4 times more arithmetic than that need (C . Bᵀ, M x, the chunk's
// state and C Sᵀ), so only the tensor cores come near the bound.
//
// bfloat16: the state-passing form on wgmma, three device kernels per call.
//   1. ssd_chunk_state, one block per (chunk, head, batch): 7 x 48 = 336
//      blocks at L 891, batch 1, where the chunk-serial form has 96.  It
//      loads the chunk's B and x with 16-byte cp.async into the
//      128-byte-swizzled layout of hopper.cuh (rows past L and columns past
//      P zero-filled), takes acs by a warp scan, and computes the chunk's
//      own state from zero, dsᵀ [N, P] = (B o w)ᵀ x with w_j = exp(acs_Q -
//      acs_j) dt_j, by wgmma m64n64k16: (B o w)ᵀ is the register A operand, x
//      the MN-major B operand.  It writes dsᵀ (f32) and a_tot = acs_Q to a
//      scratch buffer.
//   2. ssd_state_pass, over (state elements, head, batch): S_c = exp(a_tot_c)
//      S_{c-1} + ds_c in f32, in chunk order, overwriting each ds_c with the
//      state that enters chunk c, and writing the final state.
//   3. ssd_chunk_output, one block per (chunk, head, batch), two consumer
//      warpgroups of 64 rows: C . Bᵀ by wgmma from shared memory (both
//      K-major; a warpgroup skips the 64 columns above its rows), then M in
//      f32 in the accumulator's registers, then y = M x with M as the register
//      A operand, then C S_enterᵀ by wgmma from shared memory, scaled by
//      exp(acs_i) in f32 after the product, added, and rounded once to bf16.
//   Kernels 2 and 3 launch as programmatic dependents of the kernel before:
//   their blocks start while it runs and wait (griddepcontrol.wait) only
//   where they read its results, so kernel 3's loads, acs, C . Bᵀ and M
//   overlap kernels 1 and 2.
//   The per-chunk states (f32, 1.57 MB per chunk at H 48, P 64, N 128) round
//   trip through the 50 MB L2 between the launches.  Separate launches, not
//   one kernel whose blocks wait on the previous chunk's flag: no block ever
//   waits on another, so no scheduling order is assumed, and the pass that is
//   sequential over chunks is elementwise (H P N independent chains of
//   n_chunks multiply-adds), a few microseconds.  One wrapper call counts one
//   launch.
//
//   Precision.  chip_smoke.py holds bf16 y within 3e-4 + 2^-8 |y| of the plain
//   version run in f32 and the state within 3e-4.  Products of bf16 values
//   are exact in the f32 accumulators, so C . Bᵀ and every product with x
//   or C are exact up to f32 summation; the three f32 operands, M, B o w and
//   S_enter, each go in as hi = bf16(v), lo = bf16(v - hi), two wgmma each,
//   which holds them to about 2^-17 relative (tests/test_torch_ssd_design.py
//   shows that one bf16 rounding of them misses both bounds and the split
//   meets them).  No fast math: expf.  P need only be a multiple of 32: x and
//   the state go through the products in 64-column tiles, zero-padded.
//
// Every other shape: the chunk-serial CUDA-core kernel (ssd_scan_kernel).
// It takes float32, where TF32 keeps about 10 bits and cannot meet the f32
// bound of 3e-4, and bfloat16 outside the wgmma kernels' shapes: any chunk
// Q = min(chunk, L) from 1 to 128 (the TPU kernel's chunk = min(chunk, L),
// so the reduced ssm and hybrid configs' chunk of 16 is kept), N of 16, 32,
// 64 or 128 and P a multiple of 16.  Loads convert to f32 and the math and
// the state stay f32; y is rounded once to its type.  One block of 256
// threads owns (32 columns of P, head, batch) and loops over the chunks
// itself, with its [32, N] slice of the state in shared memory; a head
// narrower than 32 columns (P = 16) loads zeros past P, and its rows past P
// are neither stored nor written to the final state.  The Q x Q matrix M is
// walked in strips of 32 rows, each seeing only the columns at or below its
// rows; a chunk under 32 steps is one strip.  Shared memory is f32 with rows
// padded by one float, sized for 128-step chunks (131 KB at N = 128); each
// product keeps a small register tile per thread.  The wrapper, not a
// failure, chooses between the two designs: a shape the wgmma kernels take
// goes to them, every other shape here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"
#include "rows.cuh"

namespace {

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;  // 16 row groups x 16 lanes
constexpr int kQ = 128;        // steps per chunk
constexpr int kR = 32;         // rows per strip of the chunk
constexpr int kPB = 32;        // columns of P (rows of the state) per block
constexpr int kMS = kQ + 1;    // padded row stride of the strip of M

template <int N>
struct Layout {
  static constexpr int NS = N + 1;  // padded row stride of B, C and the state
  static constexpr int floats = kQ * NS + kR * NS + kQ * kPB + kPB * NS + kR * kMS + 4 * kQ;
  static constexpr size_t bytes = sizeof(float) * floats;
};

// M for the strip's rows r0 .. r0+31 and columns j < JT * 32 (the columns
// these rows can see): thread (grp, lane) owns rows 2 grp, 2 grp + 1 and
// columns lane + 16 k.
template <int N, int JT>
__device__ __forceinline__ void strip_scores(float* ms, const float* cs, const float* bs,
                                             const float* acs, const float* dts, int r0, int grp,
                                             int lane) {
  constexpr int NS = N + 1, KC = 2 * JT;
  float s[2][KC];
#pragma unroll
  for (int k = 0; k < KC; ++k) s[0][k] = s[1][k] = 0.f;
#pragma unroll 4
  for (int n = 0; n < N; ++n) {
    const float c0 = cs[(2 * grp) * NS + n], c1 = cs[(2 * grp + 1) * NS + n];
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      const float b = bs[(lane + 16 * k) * NS + n];
      s[0][k] = fmaf(c0, b, s[0][k]);
      s[1][k] = fmaf(c1, b, s[1][k]);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 2 * grp + i, ti = r0 + r;  // the row's step in the chunk
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      const int j = lane + 16 * k;
      const bool seen = j <= ti;
      const float decay = expf(seen ? acs[ti] - acs[j] : 0.f);
      ms[r * kMS + j] = seen ? s[i][k] * decay * dts[j] : 0.f;
    }
  }
}

// y for the strip's rows: M x + exp(acs) C Sᵀ, stored where the step is
// below L; thread (grp, lane) owns rows 2 grp, 2 grp + 1 and columns
// lane, lane + 16.
template <typename T, int N, int JT>
__device__ __forceinline__ void strip_output(T* yb, size_t ystride, int rows_left, int cols,
                                             const float* ms, const float* xs, const float* cs,
                                             const float* ss, const float* eacs, int r0, int grp,
                                             int lane) {
  constexpr int NS = N + 1;
  float intra[2][2] = {{0.f, 0.f}, {0.f, 0.f}}, inter[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll 8
  for (int j = 0; j < JT * kR; ++j) {
    const float m0 = ms[(2 * grp) * kMS + j], m1 = ms[(2 * grp + 1) * kMS + j];
    const float x0 = xs[j * kPB + lane], x1 = xs[j * kPB + lane + 16];
    intra[0][0] = fmaf(m0, x0, intra[0][0]);
    intra[0][1] = fmaf(m0, x1, intra[0][1]);
    intra[1][0] = fmaf(m1, x0, intra[1][0]);
    intra[1][1] = fmaf(m1, x1, intra[1][1]);
  }
#pragma unroll 8
  for (int n = 0; n < N; ++n) {
    const float c0 = cs[(2 * grp) * NS + n], c1 = cs[(2 * grp + 1) * NS + n];
    const float s0 = ss[lane * NS + n], s1 = ss[(lane + 16) * NS + n];
    inter[0][0] = fmaf(c0, s0, inter[0][0]);
    inter[0][1] = fmaf(c0, s1, inter[0][1]);
    inter[1][0] = fmaf(c1, s0, inter[1][0]);
    inter[1][1] = fmaf(c1, s1, inter[1][1]);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 2 * grp + i;
    if (r >= rows_left) continue;
    const float e = eacs[r0 + r];
    T* row = yb + static_cast<size_t>(r) * ystride;
    if (lane < cols) store(row + lane, intra[i][0] + e * inter[i][0]);
    if (lane + 16 < cols) store(row + lane + 16, intra[i][1] + e * inter[i][1]);
  }
}

template <typename T, int N, int JT>
__device__ __forceinline__ void strip(T* yb, size_t ystride, int rows_left, int cols, float* ms,
                                      const float* xs, const float* cs, const float* bs,
                                      const float* ss, const float* acs, const float* eacs,
                                      const float* dts, int r0, int grp, int lane) {
  strip_scores<N, JT>(ms, cs, bs, acs, dts, r0, grp, lane);
  __syncthreads();
  strip_output<T, N, JT>(yb, ystride, rows_left, cols, ms, xs, cs, ss, eacs, r0, grp, lane);
}

// `rows` rows of D elements into dst as f32 with row stride `stride`, as
// load_rows_strided, but only the first `cols` columns of each row are read
// (a multiple of 16 bytes' worth): columns at or past `cols`, and rows at or
// past `valid`, are zero.  For the last column tile of a head narrower
// than the tile, whose columns past P belong to the next head.
template <typename T>
__device__ __forceinline__ void load_cols_strided(float* dst, int stride, const T* src,
                                                  size_t src_stride, int rows, int D, int cols,
                                                  int valid) {
  constexpr int kVec = 16 / sizeof(T);
  const int per_row = D / kVec;
  for (int i = threadIdx.x; i < rows * per_row; i += blockDim.x) {
    const int r = i / per_row, c = (i % per_row) * kVec;
    float v[kVec];
    if (r < valid && c < cols) {
      const uint4 raw = *reinterpret_cast<const uint4*>(src + r * src_stride + c);
      unpack(raw, v, src);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) v[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e) dst[r * stride + c + e] = v[e];
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads) ssd_scan_kernel(
    const T* __restrict__ x,       // [B, L, H, P]
    const float* __restrict__ dt,  // [B, L, H]
    const float* __restrict__ A,   // [H]
    const T* __restrict__ Bm,      // [B, L, G, N]
    const T* __restrict__ Cm,      // [B, L, G, N]
    T* __restrict__ y,             // [B, L, H, P]
    float* __restrict__ fin,       // [B, H, P, N]
    int L, int H, int G, int P, int Q) {
  using Lay = Layout<N>;
  constexpr int NS = Lay::NS;
  extern __shared__ float smem[];
  float* bs = smem;              // [kQ][NS]   B of the chunk
  float* cs = bs + kQ * NS;      // [kR][NS]   C of the strip
  float* xs = cs + kR * NS;      // [kQ][kPB]  x of the chunk, this block's columns
  float* ss = xs + kQ * kPB;     // [kPB][NS]  the state, this block's rows
  float* ms = ss + kPB * NS;     // [kR][kMS]  M of the strip
  float* acs = ms + kR * kMS;    // [kQ] inclusive cumulative sum of dt * A
  float* eacs = acs + kQ;        // [kQ] exp(acs)
  float* dts = eacs + kQ;        // [kQ] dt
  float* ws = dts + kQ;          // [kQ] exp(acs_Q - acs) * dt

  const int p0 = blockIdx.x * kPB, h = blockIdx.y, b = blockIdx.z;
  const int cols = min(kPB, P - p0);  // this block's columns of P
  const int rows = (Q + kR - 1) / kR * kR;  // the chunk's steps, whole strips
  const int g = h / (H / G);
  const float a = A[h];
  const int grp = threadIdx.x >> 4, lane = threadIdx.x & 15;
  const size_t xstride = static_cast<size_t>(H) * P, bstride = static_cast<size_t>(G) * N;
  const T* xb = x + static_cast<size_t>(b) * L * xstride + static_cast<size_t>(h) * P + p0;
  const T* bb = Bm + static_cast<size_t>(b) * L * bstride + static_cast<size_t>(g) * N;
  const T* cb = Cm + static_cast<size_t>(b) * L * bstride + static_cast<size_t>(g) * N;
  const float* dtb = dt + static_cast<size_t>(b) * L * H + h;
  T* yb = y + static_cast<size_t>(b) * L * xstride + static_cast<size_t>(h) * P + p0;

  for (int i = threadIdx.x; i < kPB * NS; i += kThreads) ss[i] = 0.f;

  for (int t0 = 0; t0 < L; t0 += Q) {
    const int valid = min(Q, L - t0);
    __syncthreads();  // the previous chunk's tiles are consumed
    load_rows_strided(bs, NS, bb + t0 * bstride, bstride, rows, N, valid, 1.f);
    load_cols_strided(xs, kPB, xb + t0 * xstride, xstride, rows, kPB, cols, valid);
    for (int i = threadIdx.x; i < rows; i += kThreads)
      dts[i] = i < valid ? dtb[static_cast<size_t>(t0 + i) * H] : 0.f;
    __syncthreads();
    if (threadIdx.x == 0) {
      float sum = 0.f;
      for (int i = 0; i < rows; ++i) {
        sum += dts[i] * a;
        acs[i] = sum;
      }
    }
    __syncthreads();
    const float a_tot = acs[Q - 1];
    for (int i = threadIdx.x; i < rows; i += kThreads) {
      eacs[i] = expf(acs[i]);
      ws[i] = expf(a_tot - acs[i]) * dts[i];
    }

    for (int r0 = 0; r0 < valid; r0 += kR) {
      __syncthreads();  // the previous strip's C and M are consumed; eacs, ws written
      load_rows_strided(cs, NS, cb + (t0 + r0) * bstride, bstride, kR, N, valid - r0, 1.f);
      __syncthreads();
      T* yrow = yb + (t0 + r0) * xstride;
      const int left = valid - r0;
      switch (r0 / kR) {
        case 0: strip<T, N, 1>(yrow, xstride, left, cols, ms, xs, cs, bs, ss, acs, eacs, dts, r0, grp, lane); break;
        case 1: strip<T, N, 2>(yrow, xstride, left, cols, ms, xs, cs, bs, ss, acs, eacs, dts, r0, grp, lane); break;
        case 2: strip<T, N, 3>(yrow, xstride, left, cols, ms, xs, cs, bs, ss, acs, eacs, dts, r0, grp, lane); break;
        default: strip<T, N, 4>(yrow, xstride, left, cols, ms, xs, cs, bs, ss, acs, eacs, dts, r0, grp, lane); break;
      }
    }
    __syncthreads();  // every strip has read the old state

    // S <- exp(acs_Q) S + xᵀ (B w): thread (grp, lane) owns state rows
    // 2 grp, 2 grp + 1 and columns lane + 16 k; padded steps add nothing
    constexpr int KN = N / 16;
    float ds[2][KN];
#pragma unroll
    for (int k = 0; k < KN; ++k) ds[0][k] = ds[1][k] = 0.f;
#pragma unroll 4
    for (int j = 0; j < valid; ++j) {
      const float w = ws[j];
      const float x0 = xs[j * kPB + 2 * grp] * w, x1 = xs[j * kPB + 2 * grp + 1] * w;
#pragma unroll
      for (int k = 0; k < KN; ++k) {
        const float bv = bs[j * NS + lane + 16 * k];
        ds[0][k] = fmaf(x0, bv, ds[0][k]);
        ds[1][k] = fmaf(x1, bv, ds[1][k]);
      }
    }
    const float decay = expf(a_tot);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int k = 0; k < KN; ++k) {
        float* s = ss + (2 * grp + i) * NS + lane + 16 * k;
        *s = *s * decay + ds[i][k];
      }
  }
  __syncthreads();

  float* fb = fin + ((static_cast<size_t>(b) * H + h) * P + p0) * N;
  for (int i = threadIdx.x; i < cols * N; i += kThreads) fb[i] = ss[(i / N) * NS + i % N];
}


// ---------------------------------------------------------------------------
// bfloat16: state passing on wgmma
// ---------------------------------------------------------------------------

constexpr int kTileCols = 64;        // bf16 columns of one 128-byte swizzled box
constexpr int kWg = 128;             // threads of a warpgroup
constexpr int kOutThreads = 2 * kWg;  // ssd_chunk_output: rows 0-63 and 64-127
constexpr int kPassThreads = 256;

// Bytes of a [rows x cols] bf16 tile in boxes of 64 columns.
__host__ __device__ constexpr int tile_bytes(int rows, int cols) { return rows * cols * 2; }

// Shared-memory address of element (r, c) of a tile of `rows` rows stored in
// 64-column boxes, 128-byte swizzled.
__device__ __forceinline__ uint32_t tile_at(uint32_t tile, int rows, int r, int c) {
  return tile + (c / kTileCols) * rows * 128 + r * 128 + ((((c % kTileCols) / 8) ^ (r & 7)) * 16) +
         (c % 8) * 2;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Makes this thread's ordinary and cp.async writes to shared memory visible
// to wgmma, which reads through the async proxy.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Rows [0, rows) x columns [0, cols) of a bf16 matrix (row r at src + r *
// stride, columns contiguous) into a swizzled tile; rows at or past `valid`
// and columns at or past `valid_cols` are zero.  Every thread of the block
// issues its share; the caller waits (cp_async_wait_all) and synchronises.
__device__ __forceinline__ void load_tile(uint32_t tile, const __nv_bfloat16* src, size_t stride,
                                          int rows, int cols, int valid, int valid_cols) {
  const int chunks = cols / 8;
  for (int u = threadIdx.x; u < rows * chunks; u += blockDim.x) {
    const int r = u / chunks, c = (u % chunks) * 8;
    const bool in = r < valid && c < valid_cols;
    cp_async16(tile_at(tile, rows, r, c), in ? src + r * stride + c : src, in ? 16 : 0);
  }
}

__device__ __forceinline__ float bf16_at(uint32_t addr) {
  unsigned short v;
  asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(v) : "r"(addr));
  return __bfloat162float(__ushort_as_bfloat16(v));
}

// hi = bf16(a), bf16(b); lo = bf16 of what hi leaves out.
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(a - hf.x, b - hf.y));
}

// The chunk's dt (0 past L) and acs, the inclusive cumulative sum of dt * a,
// by warp 0 (four steps a lane, then a shuffle scan over the lanes).  The
// caller synchronises before reading them.
__device__ __forceinline__ void chunk_cumsum(float* dts, float* acs, const float* dtb, int H,
                                             int valid, float a) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float s[4];
    float run = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = 4 * lane + k;
      const float d = i < valid ? dtb[static_cast<size_t>(i) * H] : 0.f;
      dts[i] = d;
      run += d * a;
      s[k] = run;
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += v;
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) acs[4 * lane + k] = excl + s[k];
  }
}

template <int N>
struct StateTile {
  static constexpr int kThreads = (N / 64) * kWg;  // a warpgroup per 64 rows of dsᵀ
  static constexpr int kB = 0;                      // B [Q][N]
  static constexpr int kX = kB + tile_bytes(kQ, N);  // x [Q][64], one column tile
  static constexpr int kF = kX + tile_bytes(kQ, kTileCols);  // dt, acs, w
  static constexpr size_t smem = 1024 + kF + 3 * kQ * sizeof(float);
};

// Kernel 1: each chunk's own state from zero, dsᵀ [N, P] = (B o w)ᵀ x, into
// states [B, chunks, H, N, P] (f32), and a_tot [B, chunks, H].
template <int N>
__global__ void __launch_bounds__(StateTile<N>::kThreads, 1) ssd_chunk_state(
    const __nv_bfloat16* __restrict__ x,  // [B, L, H, P]
    const float* __restrict__ dt,         // [B, L, H]
    const float* __restrict__ A,          // [H]
    const __nv_bfloat16* __restrict__ Bm,  // [B, L, G, N]
    float* __restrict__ states,           // [B, chunks, H, N, P]
    float* __restrict__ atot,             // [B, chunks, H]
    int L, int H, int G, int P) {
  using T = StateTile<N>;
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");  // the state pass may start
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  float* fl = reinterpret_cast<float*>(smem_raw + (base - smem_u32(smem_raw)) + T::kF);
  float *dts = fl, *acs = fl + kQ, *ws = fl + 2 * kQ;

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, chunks = gridDim.x;
  const int g = h / (H / G);
  const int t0 = c * kQ, valid = min(kQ, L - t0);
  const size_t xstride = static_cast<size_t>(H) * P, bstride = static_cast<size_t>(G) * N;
  const __nv_bfloat16* xb = x + (static_cast<size_t>(b) * L + t0) * xstride + static_cast<size_t>(h) * P;

  load_tile(base + T::kB, Bm + (static_cast<size_t>(b) * L + t0) * bstride + static_cast<size_t>(g) * N,
            bstride, kQ, N, valid, N);
  load_tile(base + T::kX, xb, xstride, kQ, kTileCols, valid, P);
  chunk_cumsum(dts, acs, dt + (static_cast<size_t>(b) * L + t0) * H + h, H, valid, A[h]);
  __syncthreads();
  const float a_tot = acs[kQ - 1];
  for (int i = threadIdx.x; i < kQ; i += blockDim.x) ws[i] = expf(a_tot - acs[i]) * dts[i];
  if (threadIdx.x == 0) atot[(static_cast<size_t>(b) * chunks + c) * H + h] = a_tot;
  cp_async_wait_all();
  __syncthreads();

  // (B o w)ᵀ as register A fragments: this thread's rows n0, n0 + 8 of the
  // warpgroup's 64 rows of n, columns j of each k16 step
  const int wg = threadIdx.x / kWg, t = threadIdx.x % kWg;
  const int warp = t / 32, lane = t % 32;
  const int r = 16 * warp + lane / 4, quad = 2 * (lane % 4);
  const int n0 = 64 * wg + r, n1 = n0 + 8;
  uint32_t a_hi[kQ / 16][4], a_lo[kQ / 16][4];
#pragma unroll
  for (int kc = 0; kc < kQ / 16; ++kc) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = (e & 1) ? n1 : n0;
      const int j = 16 * kc + quad + ((e & 2) ? 8 : 0);
      split2(bf16_at(tile_at(base + T::kB, kQ, j, n)) * ws[j],
             bf16_at(tile_at(base + T::kB, kQ, j + 1, n)) * ws[j + 1], a_hi[kc][e], a_lo[kc][e]);
    }
  }

  float* sb = states + ((static_cast<size_t>(b) * chunks + c) * H + h) * N * P;
  for (int p0 = 0; p0 < P; p0 += kTileCols) {
    if (p0 > 0) {  // the next column tile of x, once the previous one is consumed
      __syncthreads();
      load_tile(base + T::kX, xb + p0, xstride, kQ, kTileCols, valid, P - p0);
      cp_async_wait_all();
    }
    fence_async_smem();
    __syncthreads();
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < kQ / 16; ++kc) {
      const uint64_t xd = smem_desc(base + T::kX + kc * 16 * 128);
      wgmma_rs(acc, a_hi[kc], xd);
      wgmma_rs(acc, a_lo[kc], xd);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int n = (i & 2) ? n1 : n0;
      const int p = p0 + 8 * (i / 4) + quad;
      if (p < P)
        *reinterpret_cast<float2*>(sb + static_cast<size_t>(n) * P + p) = make_float2(acc[i], acc[i + 1]);
    }
  }
}

// Kernel 2: over the chunks in order, S_c = exp(a_tot_c) S_{c-1} + ds_c; each
// ds_c is overwritten by the state entering chunk c, and the final state is
// written as [B, H, P, N].  A thread owns 4 consecutive elements of [N, P].
__global__ void __launch_bounds__(kPassThreads) ssd_state_pass(float* __restrict__ states,
                                                             const float* __restrict__ atot,
                                                             float* __restrict__ fin, int chunks,
                                                             int H, int P, int N) {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");  // the output may start
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // the chunk states are written
  const int h = blockIdx.y, b = blockIdx.z;
  const int e = 4 * (blockIdx.x * kPassThreads + threadIdx.x);
  if (e >= N * P) return;
  const size_t head = static_cast<size_t>(N) * P, per_chunk = static_cast<size_t>(H) * head;
  float* s0 = states + (static_cast<size_t>(b) * chunks * H + h) * head + e;
  const float* a0 = atot + static_cast<size_t>(b) * chunks * H + h;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  constexpr int kAhead = 4;  // chunks whose loads are in flight together
  for (int c0 = 0; c0 < chunks; c0 += kAhead) {
    float4 ds[kAhead];
    float decay[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      if (c0 + k < chunks) {
        ds[k] = *reinterpret_cast<const float4*>(s0 + (c0 + k) * per_chunk);
        decay[k] = a0[static_cast<size_t>(c0 + k) * H];
      }
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      if (c0 + k < chunks) {
        const float e = expf(decay[k]);
        *reinterpret_cast<float4*>(s0 + (c0 + k) * per_chunk) = s;
        s = make_float4(s.x * e + ds[k].x, s.y * e + ds[k].y, s.z * e + ds[k].z, s.w * e + ds[k].w);
      }
    }
  }
  const int n = e / P, p = e % P;  // 4 | P, so the four share n
  float* fb = fin + (static_cast<size_t>(b) * H + h) * P * N;
  fb[static_cast<size_t>(p) * N + n] = s.x;
  fb[static_cast<size_t>(p + 1) * N + n] = s.y;
  fb[static_cast<size_t>(p + 2) * N + n] = s.z;
  fb[static_cast<size_t>(p + 3) * N + n] = s.w;
}

template <int N>
struct OutTile {
  static constexpr int kC = 0;                               // C [Q][N]
  static constexpr int kB = kC + tile_bytes(kQ, N);          // B [Q][N]
  static constexpr int kX = kB + tile_bytes(kQ, N);          // x [Q][64]
  static constexpr int kSh = kX + tile_bytes(kQ, kTileCols);  // S_enter hi [N][64]
  static constexpr int kSl = kSh + tile_bytes(N, kTileCols);  // S_enter lo [N][64]
  static constexpr int kF = kSl + tile_bytes(N, kTileCols);   // dt, acs
  static constexpr size_t smem = 1024 + kF + 2 * kQ * sizeof(float);
};

// Kernel 3: y = M x + exp(acs) C S_enterᵀ for one chunk, rounded to bf16.
template <int N>
__global__ void __launch_bounds__(kOutThreads, 1) ssd_chunk_output(
    const __nv_bfloat16* __restrict__ x,   // [B, L, H, P]
    const float* __restrict__ dt,          // [B, L, H]
    const float* __restrict__ A,           // [H]
    const __nv_bfloat16* __restrict__ Bm,  // [B, L, G, N]
    const __nv_bfloat16* __restrict__ Cm,  // [B, L, G, N]
    const float* __restrict__ states,      // [B, chunks, H, N, P]: the state entering each chunk
    __nv_bfloat16* __restrict__ y,         // [B, L, H, P]
    int L, int H, int G, int P) {
  using T = OutTile<N>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  float* fl = reinterpret_cast<float*>(smem_raw + (base - smem_u32(smem_raw)) + T::kF);
  float *dts = fl, *acs = fl + kQ;

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, chunks = gridDim.x;
  const int g = h / (H / G);
  const int t0 = c * kQ, valid = min(kQ, L - t0);
  const size_t xstride = static_cast<size_t>(H) * P, bstride = static_cast<size_t>(G) * N;
  const size_t row0 = static_cast<size_t>(b) * L + t0;
  const __nv_bfloat16* xb = x + row0 * xstride + static_cast<size_t>(h) * P;
  __nv_bfloat16* yb = y + row0 * xstride + static_cast<size_t>(h) * P;
  const float* sb = states + ((static_cast<size_t>(b) * chunks + c) * H + h) * N * P;

  // the entering state of columns [p0, p0 + 64) of P into shared memory
  // as bf16 hi + lo, 8 columns a unit
  auto stage_state = [&](int p0) {
    for (int u = threadIdx.x; u < N * (kTileCols / 8); u += blockDim.x) {
      const int n = u / (kTileCols / 8), pc = (u % (kTileCols / 8)) * 8;
      uint32_t hi[4] = {0, 0, 0, 0}, lo[4] = {0, 0, 0, 0};
      if (p0 + pc < P) {
        const float4* src = reinterpret_cast<const float4*>(sb + static_cast<size_t>(n) * P + p0 + pc);
        const float4 a = src[0], q = src[1];
        split2(a.x, a.y, hi[0], lo[0]);
        split2(a.z, a.w, hi[1], lo[1]);
        split2(q.x, q.y, hi[2], lo[2]);
        split2(q.z, q.w, hi[3], lo[3]);
      }
      asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(tile_at(base + T::kSh, N, n, pc)),
                   "r"(hi[0]), "r"(hi[1]), "r"(hi[2]), "r"(hi[3]) : "memory");
      asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(tile_at(base + T::kSl, N, n, pc)),
                   "r"(lo[0]), "r"(lo[1]), "r"(lo[2]), "r"(lo[3]) : "memory");
    }
  };

  // what needs no state first (C, B, x, acs, then M below), so that it
  // overlaps the two kernels before this one
  load_tile(base + T::kC, Cm + row0 * bstride + static_cast<size_t>(g) * N, bstride, kQ, N, valid, N);
  load_tile(base + T::kB, Bm + row0 * bstride + static_cast<size_t>(g) * N, bstride, kQ, N, valid, N);
  load_tile(base + T::kX, xb, xstride, kQ, kTileCols, valid, P);
  chunk_cumsum(dts, acs, dt + row0 * H + h, H, valid, A[h]);
  cp_async_wait_all();
  fence_async_smem();
  __syncthreads();

  const int wg = threadIdx.x / kWg, t = threadIdx.x % kWg;
  const int warp = t / 32, lane = t % 32;
  const int r = 16 * warp + lane / 4, quad = 2 * (lane % 4);
  const int i0 = 64 * wg + r, i1 = i0 + 8;  // this thread's two rows of the chunk
  const uint32_t c_rows = base + T::kC + 64 * wg * 128;  // the warpgroup's 64 rows of C

  // M = (C . Bᵀ) o exp(acs_i - acs_j) o dt_j, j <= i, as register A
  // fragments hi + lo; columns j >= 64 exist only for the second warpgroup
  uint32_t m_hi[kQ / 16][4], m_lo[kQ / 16][4];
#pragma unroll
  for (int jb = 0; jb < 2; ++jb) {
    if (jb > wg) continue;
    float s[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      const uint32_t step = (kk / 4) * kQ * 128 + (kk % 4) * 32;
      wgmma_ss(s, smem_desc(c_rows + step), smem_desc(base + T::kB + jb * 64 * 128 + step), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    const float acs0 = acs[i0], acs1 = acs[i1];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int row = (i & 2) ? i1 : i0;
      const float arow = (i & 2) ? acs1 : acs0;
      const int j = 64 * jb + 8 * (i / 4) + quad;
      const float v0 = j <= row ? s[i] * expf(arow - acs[j]) * dts[j] : 0.f;
      const float v1 = j + 1 <= row ? s[i + 1] * expf(arow - acs[j + 1]) * dts[j + 1] : 0.f;
      split2(v0, v1, m_hi[4 * jb + i / 8][(i % 8) / 2], m_lo[4 * jb + i / 8][(i % 8) / 2]);
    }
  }
  const float e0 = expf(acs[i0]), e1 = expf(acs[i1]);

  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // the state pass is done and visible
  if (c > 0) {  // no state enters the first chunk
    stage_state(0);
    fence_async_smem();
    __syncthreads();
  }

  for (int p0 = 0; p0 < P; p0 += kTileCols) {
    if (p0 > 0) {  // the next column tile, once the previous one is consumed
      __syncthreads();
      load_tile(base + T::kX, xb + p0, xstride, kQ, kTileCols, valid, P - p0);
      if (c > 0) stage_state(p0);
      cp_async_wait_all();
      fence_async_smem();
      __syncthreads();
    }

    float acc[32], inter[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = inter[i] = 0.f;
    fence_regs(acc);
    fence_regs(inter);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < kQ / 16; ++kc) {
      if (kc >= 4 * (wg + 1)) continue;  // M is zero above the diagonal block
      const uint64_t xd = smem_desc(base + T::kX + kc * 16 * 128);
      wgmma_rs(acc, m_hi[kc], xd);
      wgmma_rs(acc, m_lo[kc], xd);
    }
    if (c > 0) {
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
        const uint64_t cd = smem_desc(c_rows + (kk / 4) * kQ * 128 + (kk % 4) * 32);
        wgmma_ss_bt(inter, cd, smem_desc(base + T::kSh + kk * 16 * 128), 1);
        wgmma_ss_bt(inter, cd, smem_desc(base + T::kSl + kk * 16 * 128), 1);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    fence_regs(inter);
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int row = (i & 2) ? i1 : i0;
      const float e = (i & 2) ? e1 : e0;
      const int p = p0 + 8 * (i / 4) + quad;
      if (row < valid && p < P)
        *reinterpret_cast<__nv_bfloat162*>(yb + row * xstride + p) =
            __floats2bfloat162_rn(acc[i] + e * inter[i], acc[i + 1] + e * inter[i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// The chunk-serial CUDA-core kernel, in f32 or bf16, chunks of Q steps.
template <typename T>
cudaError_t launch_serial(int N, const void* x, const void* dt, const void* A, const void* Bm,
                          const void* Cm, void* y, void* fin, int B, int L, int H, int G, int P,
                          int Q, cudaStream_t stream) {
  const dim3 grid((P + kPB - 1) / kPB, H, B);
  auto go = [&](auto kernel, size_t smem) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
        static_cast<const T*>(Bm), static_cast<const T*>(Cm), static_cast<T*>(y),
        static_cast<float*>(fin), L, H, G, P, Q);
    return cudaGetLastError();
  };
  switch (N) {
    case 16: return go(ssd_scan_kernel<T, 16>, Layout<16>::bytes);
    case 32: return go(ssd_scan_kernel<T, 32>, Layout<32>::bytes);
    case 64: return go(ssd_scan_kernel<T, 64>, Layout<64>::bytes);
    case 128: return go(ssd_scan_kernel<T, 128>, Layout<128>::bytes);
    default: return cudaErrorInvalidValue;
  }
}

template <int N>
cudaError_t launch_bf16(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
                        void* y, void* fin, void* states, void* atot, int B, int L, int H, int G,
                        int P, cudaStream_t stream) {
  if (L == 0) return cudaMemsetAsync(fin, 0, sizeof(float) * B * H * P * N, stream);
  cudaError_t e = cudaFuncSetAttribute(ssd_chunk_state<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(StateTile<N>::smem));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(ssd_chunk_output<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(OutTile<N>::smem));
  if (e != cudaSuccess) return e;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* dtf = static_cast<const float*>(dt);
  const auto* Af = static_cast<const float*>(A);
  const auto* Bb = static_cast<const __nv_bfloat16*>(Bm);
  auto* st = static_cast<float*>(states);
  auto* at = static_cast<float*>(atot);
  const dim3 grid((L + kQ - 1) / kQ, H, B);
  ssd_chunk_state<N><<<grid, StateTile<N>::kThreads, StateTile<N>::smem, stream>>>(
      xb, dtf, Af, Bb, st, at, L, H, G, P);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  // the next two launch as programmatic dependents: their blocks start while
  // the kernel before runs and wait (griddepcontrol.wait) for its results
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N * P / 4 + kPassThreads - 1) / kPassThreads, H, B);
  cfg.blockDim = dim3(kPassThreads);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, ssd_state_pass, st, static_cast<const float*>(at), static_cast<float*>(fin),
                         static_cast<int>(grid.x), H, P, N);
  if (e != cudaSuccess) return e;
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kOutThreads);
  cfg.dynamicSmemBytes = OutTile<N>::smem;
  e = cudaLaunchKernelEx(&cfg, ssd_chunk_output<N>, xb, dtf, Af, Bb, static_cast<const __nv_bfloat16*>(Cm),
                         static_cast<const float*>(st), static_cast<__nv_bfloat16*>(y), L, H, G, P);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(); 0 means launched.
// The caller picks the kernels by shape (ssd_plan in kernels/ssd_scan.py):
// wgmma != 0 runs the three wgmma kernels, which take bfloat16 (bf16 != 0),
// chunk 128, N 64 or 128 and P a multiple of 32, and need the scratch
// `states` [B, ceil(L / 128), H, N, P] and `atot` [B, ceil(L / 128), H],
// both f32; wgmma == 0 runs the chunk-serial CUDA-core kernel in chunks of
// `chunk` steps (the caller passes min(chunk, L)), on float32 or bfloat16
// (bf16), for N 16, 32, 64 or 128 and P a multiple of 16 (the scratch may
// be null).  Every shape needs 1 <= chunk <= 128 and H a multiple of G.
extern "C" int ssd_scan(const void* x, const void* dt, const void* A, const void* Bm,
                        const void* Cm, void* y, void* fin, void* states, void* atot, int B, int L,
                        int H, int G, int P, int N, int chunk, int bf16, int wgmma, void* stream) {
  if (P % 16 != 0 || G <= 0 || H % G != 0 || chunk < 1 || chunk > kQ)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (!wgmma)
    e = bf16 ? launch_serial<__nv_bfloat16>(N, x, dt, A, Bm, Cm, y, fin, B, L, H, G, P, chunk, s)
             : launch_serial<float>(N, x, dt, A, Bm, Cm, y, fin, B, L, H, G, P, chunk, s);
  else if (!bf16 || chunk != kQ || P % kPB != 0)
    e = cudaErrorInvalidValue;
  else if (N == 64)
    e = launch_bf16<64>(x, dt, A, Bm, Cm, y, fin, states, atot, B, L, H, G, P, s);
  else if (N == 128)
    e = launch_bf16<128>(x, dt, A, Bm, Cm, y, fin, states, atot, B, L, H, G, P, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

extern "C" const char* cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
