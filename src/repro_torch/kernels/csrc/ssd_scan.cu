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
// in src/repro_torch/kernels/ssd_scan.py; the two agree to f32 rounding (the
// products are summed in another order, and the in-chunk cumulative sum of
// dt * A runs left to right in one thread).
//
// What it computes per chunk of Q = 128 steps, as the TPU kernel does: acs,
// the inclusive cumulative sum of dt * A; M[i][j] = (C_i . B_j)
// exp(acs_i - acs_j) dt_j for j <= i, else 0; y_i = sum_j M[i][j] x_j +
// exp(acs_i) C_i Sᵀ; then S <- exp(acs_Q) S + sum_j x_jᵀ B_j exp(acs_Q -
// acs_j) dt_j.  The exponent acs_i - acs_j is taken only where j <= i, where
// it is <= 0 (it would overflow above the diagonal).  Unlike the TPU kernel
// it takes any L: past L it loads x = B = C = 0 and dt = 0, so a padded step
// decays by exp(0) = 1 and adds nothing, and the final state is exact.
//
// What bounds it on an H100.  The function needs about 4 P N operations per
// (batch, step, head) and reads x, B, C and dt once, writes y and the state
// once: at a mamba2-780m prefill (H 48, P 64, N 128, G 1) in bf16 the bytes
// (about 15 B per step and head) outweigh the operations at the bf16 tensor
// rate, so the bound is bytes, a few microseconds.  The chunked form does
// Q times more arithmetic than that need (about 10 MFLOP per chunk and head,
// in four products), which this first kernel runs on the f32 CUDA cores from
// shared memory: it stays far above the bound.  wgmma tiles fed by TMA are
// later work.
//
// What the design does about it.  The TPU grid (B, H, chunks) runs its chunk
// axis in order and carries the [P, N] state in VMEM; here one block of 256
// threads owns (32 columns of P, head, batch) and loops over the chunks
// itself, with its [32, N] slice of the state in shared memory.  Splitting P
// in two at P = 64 doubles the blocks (96 at batch 1 and 48 heads, on 132
// SMs) at the price of computing C . Bᵀ twice.  The Q x Q matrix M is never
// whole: the chunk is walked in strips of 32 rows, and a strip's row i only
// needs the columns j < (strip + 1) * 32, so C . Bᵀ skips the tiles above the
// diagonal.  Shared memory (f32, rows padded by one float so the lanes of a
// warp hit distinct banks): B of the chunk [128][N], x of the chunk and this
// block's columns [128][32], the state [32][N], and per strip C [32][N] and
// M [32][128]: 131 KB at N = 128, set with cudaFuncSetAttribute.  Each
// product keeps a small register tile per thread (2 x 8, 2 x 2, 2 x 8).  No
// fast math: expf, not __expf.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "rows.cuh"

namespace {

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
__device__ __forceinline__ void strip_output(T* yb, size_t ystride, int rows_left,
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
    store(row + lane, intra[i][0] + e * inter[i][0]);
    store(row + lane + 16, intra[i][1] + e * inter[i][1]);
  }
}

template <typename T, int N, int JT>
__device__ __forceinline__ void strip(T* yb, size_t ystride, int rows_left, float* ms,
                                      const float* xs, const float* cs, const float* bs,
                                      const float* ss, const float* acs, const float* eacs,
                                      const float* dts, int r0, int grp, int lane) {
  strip_scores<N, JT>(ms, cs, bs, acs, dts, r0, grp, lane);
  __syncthreads();
  strip_output<T, N, JT>(yb, ystride, rows_left, ms, xs, cs, ss, eacs, r0, grp, lane);
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
    int L, int H, int G, int P) {
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

  for (int t0 = 0; t0 < L; t0 += kQ) {
    const int valid = min(kQ, L - t0);
    __syncthreads();  // the previous chunk's tiles are consumed
    load_rows_strided(bs, NS, bb + t0 * bstride, bstride, kQ, N, valid, 1.f);
    load_rows_strided(xs, kPB, xb + t0 * xstride, xstride, kQ, kPB, valid, 1.f);
    for (int i = threadIdx.x; i < kQ; i += kThreads)
      dts[i] = i < valid ? dtb[static_cast<size_t>(t0 + i) * H] : 0.f;
    __syncthreads();
    if (threadIdx.x == 0) {
      float sum = 0.f;
      for (int i = 0; i < kQ; ++i) {
        sum += dts[i] * a;
        acs[i] = sum;
      }
    }
    __syncthreads();
    const float a_tot = acs[kQ - 1];
    for (int i = threadIdx.x; i < kQ; i += kThreads) {
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
        case 0: strip<T, N, 1>(yrow, xstride, left, ms, xs, cs, bs, ss, acs, eacs, dts, r0, grp, lane); break;
        case 1: strip<T, N, 2>(yrow, xstride, left, ms, xs, cs, bs, ss, acs, eacs, dts, r0, grp, lane); break;
        case 2: strip<T, N, 3>(yrow, xstride, left, ms, xs, cs, bs, ss, acs, eacs, dts, r0, grp, lane); break;
        default: strip<T, N, 4>(yrow, xstride, left, ms, xs, cs, bs, ss, acs, eacs, dts, r0, grp, lane); break;
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
  for (int i = threadIdx.x; i < kPB * N; i += kThreads) fb[i] = ss[(i / N) * NS + i % N];
}

template <typename T, int N>
cudaError_t launch(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
                   void* y, void* fin, int B, int L, int H, int G, int P, cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      ssd_scan_kernel<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Layout<N>::bytes));
  if (e != cudaSuccess) return e;
  const dim3 grid(P / kPB, H, B);
  ssd_scan_kernel<T, N><<<grid, kThreads, Layout<N>::bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), static_cast<T*>(y),
      static_cast<float*>(fin), L, H, G, P);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_n(int N, const void* x, const void* dt, const void* A, const void* Bm,
                     const void* Cm, void* y, void* fin, int B, int L, int H, int G, int P,
                     cudaStream_t stream) {
  switch (N) {
    case 64:
      return launch<T, 64>(x, dt, A, Bm, Cm, y, fin, B, L, H, G, P, stream);
    case 128:
      return launch<T, 128>(x, dt, A, Bm, Cm, y, fin, B, L, H, G, P, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(); 0 means launched.
// bf16 != 0: x, B, C and y are bfloat16, else float32.  Needs N 64 or 128,
// P a multiple of 32 and H a multiple of G.
extern "C" int ssd_scan(const void* x, const void* dt, const void* A, const void* Bm,
                        const void* Cm, void* y, void* fin, int B, int L, int H, int G, int P,
                        int N, int bf16, void* stream) {
  if (P % kPB != 0 || G <= 0 || H % G != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      bf16 ? launch_n<__nv_bfloat16>(N, x, dt, A, Bm, Cm, y, fin, B, L, H, G, P, s)
           : launch_n<float>(N, x, dt, A, Bm, Cm, y, fin, B, L, H, G, P, s);
  return static_cast<int>(e);
}

extern "C" const char* cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
