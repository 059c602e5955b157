// Decode attention: one query token per sequence against its KV cache, with
// a valid length per sequence, GQA and a logit softcap.
//
// Replaces the TPU kernel decode_attention_pallas (_decode_kernel) in
// src/repro/kernels/decode_attention.py.  Its plain PyTorch version is
// decode_attention_ref in src/repro_torch/kernels/decode_attention.py; the
// two agree to f32 rounding.  Like the TPU kernel, and unlike the
// reference's jnp oracle, the probabilities stay f32 in the product with v.
//
// What it computes, for q [B, H, D], caches [B, Hkv, S, D] and lengths [B]:
// head h reads kv head h / (H / Hkv); key c is visible when c < lengths[b]
// (clamped to [0, S]); logits are q.k / sqrt(D), then softcap * tanh(s /
// softcap); f32 running max, sum and accumulator; no visible key gives 0.
// The order of the keys does not matter, so a ring-buffered window cache
// needs only its length.
//
// What bounds it on an H100.  Bytes: each step must read the valid prefix
// of k and v once, 4 * D * length bytes per kv head in bf16, against 4 * D
// operations per (head, key), far below the card's 295 operations per byte.
//
// What the design does about it.  One block of 256 threads per (kv head,
// sequence): the query heads of the GQA group share each k and v row that
// the block loads, so the cache is read once.  The block walks the valid
// prefix in tiles of 64 keys (tiles past the length are never read, as the
// TPU kernel skips them), loads each with 16-byte vector loads into shared
// memory as f32, forms the group's [G, 64] logits, updates each row's
// online softmax with one warp per row and folds p v into an f32
// accumulator in shared memory.  B * Hkv blocks fill few of the 132 SMs at
// serving batch sizes (8 at qwen2.5-3b with 4 slots): splitting the keys
// over more blocks with a combine step is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

#include "rows.cuh"

namespace {

constexpr float kNeg = -1e30f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBK = 64;  // keys per tile

template <typename T>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(
    const T* __restrict__ q,          // [B, H, D]
    const T* __restrict__ k,          // [B, Hkv, S, D]
    const T* __restrict__ v,          // [B, Hkv, S, D]
    const int* __restrict__ lengths,  // [B]
    T* __restrict__ o,                // [B, H, D]
    int H, int Hkv, int S, int D, float softcap, float scale) {
  const int G = H / Hkv;
  const int hk = blockIdx.x, b = blockIdx.y;
  const int DS = D + 1;  // padded row stride of q and k
  extern __shared__ float smem[];
  float* qs = smem;             // [G][DS]
  float* ks = qs + G * DS;      // [kBK][DS]
  float* vs = ks + kBK * DS;    // [kBK][D]
  float* acc = vs + kBK * D;    // [G][D]
  float* sp = acc + G * D;      // [G][kBK] logits, then probabilities
  float* m = sp + G * kBK;      // [G]
  float* l = m + G;             // [G]
  float* corr = l + G;          // [G]

  const int len = min(max(lengths[b], 0), S);
  const T* qb = q + (static_cast<size_t>(b) * H + hk * G) * D;
  const T* kb = k + (static_cast<size_t>(b) * Hkv + hk) * S * D;
  const T* vb = v + (static_cast<size_t>(b) * Hkv + hk) * S * D;
  T* ob = o + (static_cast<size_t>(b) * H + hk * G) * D;

  load_rows(qs, DS, qb, G, D, G, scale);
  for (int i = threadIdx.x; i < G * D; i += kThreads) acc[i] = 0.f;
  for (int g = threadIdx.x; g < G; g += kThreads) {
    m[g] = kNeg;
    l[g] = 0.f;
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int c0 = 0; c0 < len; c0 += kBK) {
    const int valid = min(kBK, len - c0);
    __syncthreads();  // the previous tile is consumed (and q, m, l are set)
    load_rows(ks, DS, kb + static_cast<size_t>(c0) * D, kBK, D, valid, 1.f);
    load_rows(vs, D, vb + static_cast<size_t>(c0) * D, kBK, D, valid, 1.f);
    __syncthreads();

    for (int i = threadIdx.x; i < G * kBK; i += kThreads) {
      const int g = i / kBK, j = i % kBK;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(qs[g * DS + d], ks[j * DS + d], s);
      if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      sp[i] = j < valid ? s : kNeg;
    }
    __syncthreads();

    for (int g = warp; g < G; g += kWarps) {
      float mx = kNeg;
      for (int j = lane; j < kBK; j += 32) mx = fmaxf(mx, sp[g * kBK + j]);
#pragma unroll
      for (int w = 16; w > 0; w >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m[g], mx);
      float psum = 0.f;
      for (int j = lane; j < kBK; j += 32) {
        const float p = j < valid ? expf(sp[g * kBK + j] - m_new) : 0.f;
        sp[g * kBK + j] = p;
        psum += p;
      }
#pragma unroll
      for (int w = 16; w > 0; w >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, w);
      if (lane == 0) {
        const float cr = expf(m[g] - m_new);
        corr[g] = cr;
        l[g] = cr * l[g] + psum;
        m[g] = m_new;
      }
    }
    __syncthreads();

    for (int i = threadIdx.x; i < G * D; i += kThreads) {
      const int g = i / D, d = i % D;
      float pv = 0.f;
      for (int j = 0; j < valid; ++j) pv = fmaf(sp[g * kBK + j], vs[j * D + d], pv);
      acc[i] = acc[i] * corr[g] + pv;
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    const int g = i / D;
    const float lg = l[g] == 0.f ? 1.f : l[g];
    store(ob + i, acc[i] / lg);
  }
}

}  // namespace

// Dynamic shared memory of one block for a GQA group of G heads of width D.
extern "C" long long decode_attention_smem(int G, int D) {
  return static_cast<long long>(sizeof(float)) *
         (static_cast<long long>(G) * (D + 1) + kBK * (D + 1) + kBK * D + G * D + G * kBK + 3 * G);
}

// Most dynamic shared memory a block may ask for on the current device.  A
// CUDA error comes back negated.
extern "C" long long decode_attention_max_smem() {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return -static_cast<long long>(e);
  return optin;
}

// Launches on `stream` and returns cudaGetLastError(); 0 means launched.
// bf16 != 0: bfloat16 tensors, else float32.  softcap <= 0: no softcap.
extern "C" int decode_attention(const void* q, const void* k, const void* v, const void* lengths,
                                void* o, int B, int H, int Hkv, int S, int D, int bf16,
                                float softcap, void* stream) {
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)));
  const size_t smem = static_cast<size_t>(decode_attention_smem(H / Hkv, D));
  const dim3 grid(Hkv, B);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (bf16) {
    e = cudaFuncSetAttribute(decode_attention_kernel<__nv_bfloat16>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    decode_attention_kernel<__nv_bfloat16><<<grid, kThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(lengths),
        static_cast<__nv_bfloat16*>(o), H, Hkv, S, D, softcap, scale);
  } else {
    e = cudaFuncSetAttribute(decode_attention_kernel<float>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    decode_attention_kernel<float><<<grid, kThreads, smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const int*>(lengths), static_cast<float*>(o), H, Hkv, S, D, softcap, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
