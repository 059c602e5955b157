// Flash attention for prefill: blockwise online-softmax attention with GQA,
// causal masking at an offset, a sliding window and a logit softcap.
//
// Replaces the TPU kernel flash_attention_pallas (_flash_kernel) in
// src/repro/kernels/flash_attention.py.  Its plain PyTorch version is
// flash_attention_ref in src/repro_torch/kernels/flash_attention.py; the two
// agree to f32 rounding (the sums run in another order).
//
// What it computes, for q [B, H, Sq, D] and k, v [B, Hkv, Skv, D]: query row
// r sits at kv position r + (Skv - Sq); it sees column c when c <= r + off
// (causal) and c > r + off - window (window); logits are q.k / sqrt(D), then
// softcap * tanh(s / softcap); the running max, sum and accumulator are f32;
// a row that sees nothing (l == 0) gives zeros.  Unlike the TPU kernel it
// takes any Sq and Skv: the ragged last tiles are masked here.
//
// What bounds it on an H100.  The function needs 4 * D operations per
// visible (query, key) pair and each head, and reads q, k, v once and writes
// o once.  At a prefill of qwen2.5-3b (H 16, Hkv 2, D 128) the operations at
// the bf16 tensor-core rate outweigh the bytes from about 600 tokens up, so
// the bound is operations.  This first kernel runs its products on the f32
// CUDA cores (67 TFLOP/s peak, a fifteenth of the tensor cores' bf16 rate),
// so it stays well above the bound; wgmma tiles fed by TMA are later work.
//
// What the design does about it.  One block of 128 threads per (query tile,
// head, batch): the TPU's sequential kv grid axis becomes a loop inside the
// block, over only the kv tiles that the causal and window masks leave
// visible (fully masked tiles are skipped, as the TPU kernel's pl.when
// does).  The query tile is loaded once, scaled, into shared memory as f32;
// each kv tile is loaded with 16-byte vector loads and converted to f32.
// Threads form 16 row groups of 8 lanes: each thread owns RM rows, BK/8
// score columns and D/8 output columns, so a row's max and sum are three
// shuffles inside one warp and the probabilities only need a warp barrier.
// The f32 accumulator stays in registers (64 per thread at D 128 and 256);
// D 256 halves the tile height to fit them.  Rows of q and k in shared
// memory are padded by one float so the lanes of a warp hit distinct banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

#include "rows.cuh"

namespace {

constexpr float kNeg = -1e30f;
constexpr int kThreads = 128;  // 16 row groups x 8 lanes

template <int D>
struct Tile {
  static constexpr int BQ = D > 128 ? 32 : 64;  // query rows per block
  static constexpr int BK = BQ;                 // kv rows per tile
  static constexpr int RM = BQ / 16;            // rows per thread
  static constexpr int CN = BK / 8;             // score columns per thread
  static constexpr int DN = D / 8;              // output columns per thread
  static constexpr int QS = D + 1;              // padded row stride of q and k
  static constexpr int PS = BK + 1;             // padded row stride of p
  static constexpr size_t smem = sizeof(float) * (BQ * QS + BK * QS + BK * D + BQ * PS);
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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const T* __restrict__ q,  // [B, H, Sq, D]
    const T* __restrict__ k,  // [B, Hkv, Skv, D]
    const T* __restrict__ v,  // [B, Hkv, Skv, D]
    T* __restrict__ o,        // [B, H, Sq, D]
    int H, int Hkv, int Sq, int Skv, int causal, int window, float softcap, float scale) {
  using C = Tile<D>;
  extern __shared__ float smem[];
  float* qs = smem;                 // [BQ][QS]
  float* ks = qs + C::BQ * C::QS;   // [BK][QS]
  float* vs = ks + C::BK * C::QS;   // [BK][D]
  float* ps = vs + C::BK * D;       // [BQ][PS]

  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.x * C::BQ;
  const int rg = threadIdx.x >> 3, cg = threadIdx.x & 7;
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
    load_rows(vs, D, vb + static_cast<size_t>(c0) * D, C::BK, D, Skv - c0, 1.f);
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
        const float vv = vs[c * D + cg + 8 * j];
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
      store(ob + static_cast<size_t>(row) * D + cg + 8 * j, acc[i][j] / li);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int H, int Hkv,
                   int Sq, int Skv, int causal, int window, float softcap, cudaStream_t stream) {
  using C = Tile<D>;
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)));
  const cudaError_t e = cudaFuncSetAttribute(
      flash_attention_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::smem));
  if (e != cudaSuccess) return e;
  const dim3 grid((Sq + C::BQ - 1) / C::BQ, H, B);
  flash_attention_kernel<T, D><<<grid, kThreads, C::smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H, Hkv, Sq, Skv, causal, window, softcap, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v, void* o, int B, int H,
                     int Hkv, int Sq, int Skv, int causal, int window, float softcap,
                     cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch<T, 64>(q, k, v, o, B, H, Hkv, Sq, Skv, causal, window, softcap, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, H, Hkv, Sq, Skv, causal, window, softcap, stream);
    case 256:
      return launch<T, 256>(q, k, v, o, B, H, Hkv, Sq, Skv, causal, window, softcap, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Head widths the kernel is built for.
extern "C" int flash_attention_supports(int D) { return D == 64 || D == 128 || D == 256; }

// Launches on `stream` and returns cudaGetLastError(); 0 means launched.
// bf16 != 0: bfloat16 tensors, else float32.  window <= 0: no window;
// softcap <= 0: no softcap.
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* o, int B, int H,
                               int Hkv, int Sq, int Skv, int D, int bf16, int causal, int window,
                               float softcap, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      bf16 ? launch_d<__nv_bfloat16>(D, q, k, v, o, B, H, Hkv, Sq, Skv, causal, window, softcap, s)
           : launch_d<float>(D, q, k, v, o, B, H, Hkv, Sq, Skv, causal, window, softcap, s);
  return static_cast<int>(e);
}

extern "C" const char* cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
