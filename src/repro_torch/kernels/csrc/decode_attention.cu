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
// (clamped to [0, S]); logits are (q * scale).k (the caller's scale, D^-0.5
// by default), then softcap * tanh(s / softcap); f32 softmax state; no visible key gives 0.  The order of the
// keys does not matter, so a ring-buffered window cache needs only its
// length.
//
// What bounds it on an H100.  Bytes: each step must read the valid prefix
// of k and v once, 4 * D * length bytes per kv head in bf16, against 4 * D
// operations per (head, key), far below the card's 295 operations per byte.
// To pull those bytes at the card's rate the loads have to come from most
// of the 132 SMs at once, which one block per (kv head, sequence), 8 blocks
// at qwen2.5-3b's 4 slots, cannot do.
//
// What the design does about it: split-KV (flash-decoding), two kernels.
// decode_attention_kernel runs a grid of (splits, Hkv, B) blocks of 256
// threads; the wrapper chooses `splits` and the keys per split (`chunk`, a
// multiple of 64) from B, Hkv, the cache size S and the SM count alone
// (decode_split_plan), never from the lengths, which stay on the device.
// Each block walks one contiguous range of keys for the whole GQA group, so
// each k and v row is still read once, and writes its partial softmax state
// (m, l, acc [G, D]) in f32 to scratch; a block whose range starts at or
// past its sequence's length exits at once.  The range is walked in tiles
// of 16 KB of k (64 keys of bf16 at D 128), copied with 16-byte cp.async
// into a double buffer, so the next tile's loads overlap the current
// tile's arithmetic.  The arithmetic is warp-parallel, lanes on
// consecutive shared-memory words:
// - logits: a warp takes two keys, its lanes across each row and each
//   head's query, and five shuffle steps sum the dots of four heads of both
//   keys at once, eight chains interleaved;
// - the product with v: a thread takes two columns of D for four heads, so
//   a key costs it one load of v and one 16-byte load of the four
//   probabilities, which are stored heads fastest.
// decode_attention_kernel_combine is launched while the split pass runs
// (programmatic dependent launch) and waits for it on the device; it gives
// each (head, sequence) sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s over
// the splits that hold keys, the first ceil(length / chunk), from the
// lengths on the device (none: zeros).  All on the CUDA cores: the function
// is bound by bytes.
//
// Head widths: every D that is a multiple of 8 from 8 to 256 (a bf16 row is
// whole 16-byte cp.async units), as the TPU kernel takes any D.  The split kernel is built for a padded width DP of
// 64, 128, 192 or 256, the true D a runtime argument: its shared-memory
// rows of q and k are DP wide, the pad zeroed once, so each lane reads an
// even number of columns (DP / 32) of every row; cp.async copies only the D
// columns of a row, and the product with v walks only D / 2 column pairs.
// The combine runs D threads rounded up to whole warps.
//
// The state variant (decode_attention_state) runs the same two kernels and
// also writes each row's softmax state lse = M + log(sum_s e^(m_s - M) l_s)
// [B, H] f32 from the combine, the log of the row's softmax denominator:
// a caller whose keys are split over devices combines the devices' outputs
// by it (flash-decoding across devices).  A row with no visible key gets
// kNeg (-1e30), so that it weighs nothing beside a device that has keys,
// and an output of 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "rows.cuh"

namespace {

constexpr float kNeg = -1e30f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T, int DP>
struct DecTile {
  static constexpr int BK = 16384 / (DP * static_cast<int>(sizeof(T))) < 64
                                ? 16384 / (DP * static_cast<int>(sizeof(T)))
                                : 64;  // keys per tile
  static constexpr int kTileBytes = BK * DP * static_cast<int>(sizeof(T));
  static constexpr int V = DP / 32;  // elements of a padded row per lane: 2, 4, 6 or 8
};

// Heads rounded up to a multiple of 4: the probabilities' row length.
__host__ __device__ __forceinline__ int heads_padded(int G) { return (G + 3) / 4 * 4; }

template <typename T, int DP>
size_t smem_bytes(int G) {
  using C = DecTile<T, DP>;
  return 4 * static_cast<size_t>(C::kTileBytes) +
         sizeof(float) * (2 * static_cast<size_t>(G) * DP + heads_padded(G) * C::BK + 3 * G);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// The first `rows` rows of a tile of k and of v (rows of D elements) into
// shared memory rows of DP elements.
template <typename T, int DP>
__device__ __forceinline__ void load_tile(T* ks, T* vs, const T* kg, const T* vg, int rows, int D) {
  constexpr int kVec = 16 / sizeof(T);
  const int per_row = D / kVec;  // 16-byte chunks of a row
  for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
    const int r = i / per_row, c = (i - r * per_row) * kVec;
    cp_async16(ks + r * DP + c, kg + static_cast<size_t>(r) * D + c);
    cp_async16(vs + r * DP + c, vg + static_cast<size_t>(r) * D + c);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void to_float(const float* src, float (&x)[N]) {
#pragma unroll
  for (int e = 0; e < N; ++e) x[e] = src[e];
}

template <int N>
__device__ __forceinline__ void to_float(const __nv_bfloat16* src, float (&x)[N]) {
#pragma unroll
  for (int e = 0; e < N; e += 2) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(src + e));
    x[e] = f.x;
    x[e + 1] = f.y;
  }
}

__device__ __forceinline__ float2 to_float2(const float* src) {
  return *reinterpret_cast<const float2*>(src);
}
__device__ __forceinline__ float2 to_float2(const __nv_bfloat16* src) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(src));
}

// Three blocks an SM, as many as their shared memory lets share one at the
// serving shapes (75 KB at bf16, G 8, DP 128).  Without a block count ptxas
// settled at 48 or 64 registers a thread and spilled at some widths.
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, 3) decode_attention_kernel(
    const T* __restrict__ q,          // [B, H, D]
    const T* __restrict__ k,          // [B, Hkv, S, D]
    const T* __restrict__ v,          // [B, Hkv, S, D]
    const int* __restrict__ lengths,  // [B]
    float* __restrict__ part_acc,     // [B, Hkv, splits, G, D]
    float* __restrict__ part_ml,      // [B, Hkv, splits, G, 2]: m, l
    int H, int Hkv, int S, int D, int chunk, float softcap, float scale) {
  using C = DecTile<T, DP>;
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");  // the combine may start
  const int G = H / Hkv, Gp = heads_padded(G);
  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);                      // [2][BK][DP]
  T* vs = ks + 2 * C::BK * DP;                                 // [2][BK][DP]
  float* qs = reinterpret_cast<float*>(vs + 2 * C::BK * DP);  // [G][DP], scaled
  float* acc = qs + G * DP;                                    // [G][D] (room for DP)
  float* sp = acc + G * DP;  // [BK][Gp] logits, then probabilities, heads fastest
  float* m = sp + Gp * C::BK;  // [G]
  float* l = m + G;            // [G]
  float* corr = l + G;         // [G]

  const int len_raw = lengths[b];  // in flight while q loads
  load_rows(qs, DP, q + (static_cast<size_t>(b) * H + hk * G) * D, G, D, G, scale);
  const int len = min(max(len_raw, 0), S);
  const int begin = split * chunk, end = min(begin + chunk, len);
  if (begin >= end) return;  // nothing of this sequence in the range: the combine skips it
  const int pad = DP - D;  // the columns of a row past D: zeros in q and k
  for (int i = threadIdx.x; i < 2 * C::BK * pad; i += kThreads) ks[(i / pad) * DP + D + i % pad] = T{};
  for (int i = threadIdx.x; i < G * pad; i += kThreads) qs[(i / pad) * DP + D + i % pad] = 0.f;

  const size_t kv_base = (static_cast<size_t>(b) * Hkv + hk) * S * D;
  const T* kb = k + kv_base + static_cast<size_t>(begin) * D;
  const T* vb = v + kv_base + static_cast<size_t>(begin) * D;
  const int n_tiles = (end - begin + C::BK - 1) / C::BK;
  load_tile<T, DP>(ks, vs, kb, vb, min(C::BK, end - begin), D);
  for (int i = threadIdx.x; i < G * D; i += kThreads) acc[i] = 0.f;
  for (int g = threadIdx.x; g < G; g += kThreads) {
    m[g] = kNeg;
    l[g] = 0.f;
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int t = 0; t < n_tiles; ++t) {
    const int c0 = begin + t * C::BK;
    const int valid = min(C::BK, end - c0);
    const T* kt = ks + (t & 1) * C::BK * DP;
    const T* vt = vs + (t & 1) * C::BK * DP;
    if (t + 1 < n_tiles) {  // the next tile's copies run while this one is used
      const int next = c0 + C::BK;
      load_tile<T, DP>(ks + ((t + 1) & 1) * C::BK * DP, vs + ((t + 1) & 1) * C::BK * DP,
                       kb + static_cast<size_t>(next - begin) * D,
                       vb + static_cast<size_t>(next - begin) * D, min(C::BK, end - next), D);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();  // the tile (and, at t = 0, q, acc, m, l) is in place

    // logits: a warp takes two keys, its lanes across each row, and four
    // heads at a time, so eight shuffle sums interleave
    for (int j = warp; j < valid; j += 2 * kWarps) {
      const bool two = j + kWarps < valid;  // the tile has a second key for this warp
      float k0[C::V], k1[C::V];
      to_float(kt + j * DP + lane * C::V, k0);
      to_float(kt + (two ? j + kWarps : j) * DP + lane * C::V, k1);
      for (int g0 = 0; g0 < G; g0 += 4) {
        float d0[4], d1[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          d0[u] = d1[u] = 0.f;
          if (g0 + u < G) {
            float qx[C::V];
            to_float(qs + (g0 + u) * DP + lane * C::V, qx);
#pragma unroll
            for (int e = 0; e < C::V; ++e) {
              d0[u] = fmaf(qx[e], k0[e], d0[u]);
              d1[u] = fmaf(qx[e], k1[e], d1[u]);
            }
          }
        }
#pragma unroll
        for (int w = 16; w > 0; w >>= 1) {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            d0[u] += __shfl_xor_sync(0xffffffffu, d0[u], w);
            d1[u] += __shfl_xor_sync(0xffffffffu, d1[u], w);
          }
        }
        // lane 4 r + u keeps head g0 + u of key r (0: j, 1: j + kWarps)
        const int r = lane / 4, u = lane % 4;
        if (lane < 8 && g0 + u < G && (r == 0 || two)) {
          float x = d0[0];
#pragma unroll
          for (int z = 1; z < 8; ++z)
            if (lane == z) x = z < 4 ? d0[z % 4] : d1[z % 4];
          if (softcap > 0.f) x = softcap * tanhf(x / softcap);
          sp[(j + r * kWarps) * Gp + g0 + u] = x;
        }
      }
    }
    __syncthreads();

    // each head's online softmax: one warp per head, lanes across the keys
    for (int g = warp; g < G; g += kWarps) {
      float mx = kNeg;
      for (int j = lane; j < valid; j += 32) mx = fmaxf(mx, sp[j * Gp + g]);
#pragma unroll
      for (int w = 16; w > 0; w >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m[g], mx);
      float psum = 0.f;
      for (int j = lane; j < valid; j += 32) {
        const float p = expf(sp[j * Gp + g] - m_new);
        sp[j * Gp + g] = p;
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

    // acc = corr acc + p v: a thread takes two columns for four heads, so a
    // key costs it one load of v and one 16-byte load of the four p's
    for (int i = threadIdx.x; i < (D / 2) * (Gp / 4); i += kThreads) {
      const int c = 2 * (i % (D / 2)), g0 = 4 * (i / (D / 2));
      float a[4][2] = {};
      for (int j = 0; j < valid; ++j) {
        const float4 p = *reinterpret_cast<const float4*>(sp + j * Gp + g0);
        const float2 x = to_float2(vt + j * DP + c);
        const float pp[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          a[u][0] = fmaf(pp[u], x.x, a[u][0]);
          a[u][1] = fmaf(pp[u], x.y, a[u][1]);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int g = g0 + u;
        if (g < G) {
          acc[g * D + c] = acc[g * D + c] * corr[g] + a[u][0];
          acc[g * D + c + 1] = acc[g * D + c + 1] * corr[g] + a[u][1];
        }
      }
    }
    __syncthreads();  // the buffer and sp are free for the next tile
  }

  const size_t slot = (static_cast<size_t>(b) * Hkv + hk) * gridDim.x + split;
  float* pa = part_acc + slot * G * D;
  for (int i = threadIdx.x; i < G * D; i += kThreads) pa[i] = acc[i];
  float* ml = part_ml + slot * G * 2;
  for (int g = threadIdx.x; g < G; g += kThreads) {
    ml[2 * g] = m[g];
    ml[2 * g + 1] = l[g];
  }
}

// One block of D threads, rounded up to whole warps, per (head, sequence):
// the partial states of the splits that hold keys, a prefix of
// ceil(length / chunk), folded into the output.  Their (m, l) are read in
// parallel into shared memory and turned into weights e^(m_s - M) there;
// each of the first D threads then sums its column.
template <typename T>
__global__ void decode_attention_kernel_combine(const float* __restrict__ part_acc,
                                                const float* __restrict__ part_ml,
                                                const int* __restrict__ lengths,
                                                T* __restrict__ o,  // [B, H, D]
                                                float* __restrict__ lse,  // [B, H] or null
                                                int H, int Hkv, int S, int D, int splits,
                                                int chunk) {
  extern __shared__ float w[];  // [splits] weights, then [splits] l
  float* ls = w + splits;
  __shared__ float red[32];
  const int G = H / Hkv;
  const int h = blockIdx.x, b = blockIdx.y;
  const int hk = h / G, g = h % G;
  const size_t slot0 = (static_cast<size_t>(b) * Hkv + hk) * splits;
  const int live = (min(max(lengths[b], 0), S) + chunk - 1) / chunk;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // the split pass is done and visible

  float mx = kNeg;
  for (int s = threadIdx.x; s < live; s += blockDim.x) {
    const float2 ml = *reinterpret_cast<const float2*>(part_ml + ((slot0 + s) * G + g) * 2);
    w[s] = ml.x;
    ls[s] = ml.y;
    mx = fmaxf(mx, ml.x);
  }
#pragma unroll
  for (int x = 16; x > 0; x >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, x));
  if (lane == 0) red[warp] = mx;
  __syncthreads();
  float M = kNeg;
  for (int i = 0; i < (blockDim.x + 31) / 32; ++i) M = fmaxf(M, red[i]);
  for (int s = threadIdx.x; s < live; s += blockDim.x) w[s] = expf(w[s] - M);
  __syncthreads();
  if (lse != nullptr && threadIdx.x == 0) {
    float den = 0.f;
    for (int s = 0; s < live; ++s) den = fmaf(w[s], ls[s], den);
    lse[static_cast<size_t>(b) * H + h] = den > 0.f ? M + logf(den) : kNeg;
  }
  if (threadIdx.x >= D) return;

  const float* acc = part_acc + (slot0 * G + g) * D + threadIdx.x;
  float num = 0.f, den = 0.f;
#pragma unroll 8
  for (int s = 0; s < live; ++s) {
    den = fmaf(w[s], ls[s], den);
    num = fmaf(w[s], acc[static_cast<size_t>(s) * G * D], num);
  }
  store(o + (static_cast<size_t>(b) * H + h) * D + threadIdx.x, num / (den == 0.f ? 1.f : den));
}

template <typename T, int DP>
cudaError_t launch(const void* q, const void* k, const void* v, const int* lengths, void* o,
                   float* lse, float* scratch, int B, int H, int Hkv, int S, int D, int splits,
                   int chunk, float softcap, float scale, cudaStream_t stream) {
  const int G = H / Hkv;
  const size_t smem = smem_bytes<T, DP>(G);
  cudaError_t e = cudaFuncSetAttribute(decode_attention_kernel<T, DP>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  float* part_acc = scratch;
  float* part_ml = scratch + static_cast<size_t>(B) * H * splits * D;
  decode_attention_kernel<T, DP><<<dim3(splits, Hkv, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), lengths,
      part_acc, part_ml, H, Hkv, S, D, chunk, softcap, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  // launched while the split pass runs (programmatic dependent launch): its
  // blocks wait at griddepcontrol.wait, so its launch latency is hidden
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(H, B);
  cfg.blockDim = dim3((D + 31) / 32 * 32);
  cfg.dynamicSmemBytes = 2 * sizeof(float) * splits;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, decode_attention_kernel_combine<T>, static_cast<const float*>(part_acc),
                         static_cast<const float*>(part_ml), lengths, static_cast<T*>(o), lse, H, Hkv,
                         S, D, splits, chunk);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v, const int* lengths,
                     void* o, float* lse, float* scratch, int B, int H, int Hkv, int S, int splits,
                     int chunk, float softcap, float scale, cudaStream_t stream) {
  if (!takes_head_dim(D)) return cudaErrorInvalidValue;
  switch (padded_width(D)) {
    case 64:
      return launch<T, 64>(q, k, v, lengths, o, lse, scratch, B, H, Hkv, S, D, splits, chunk, softcap, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, lengths, o, lse, scratch, B, H, Hkv, S, D, splits, chunk, softcap, scale, stream);
    case 192:
      return launch<T, 192>(q, k, v, lengths, o, lse, scratch, B, H, Hkv, S, D, splits, chunk, softcap, scale, stream);
    default:
      return launch<T, 256>(q, k, v, lengths, o, lse, scratch, B, H, Hkv, S, D, splits, chunk, softcap, scale, stream);
  }
}

int launch_any(const void* q, const void* k, const void* v, const void* lengths, void* o, float* lse,
               void* scratch, int B, int H, int Hkv, int S, int D, int splits, int chunk, int bf16,
               float softcap, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  float* sc = static_cast<float*>(scratch);
  const cudaError_t e =
      bf16 ? launch_d<__nv_bfloat16>(D, q, k, v, len, o, lse, sc, B, H, Hkv, S, splits, chunk, softcap, scale, s)
           : launch_d<float>(D, q, k, v, len, o, lse, sc, B, H, Hkv, S, splits, chunk, softcap, scale, s);
  return static_cast<int>(e);
}

}  // namespace

// Dynamic shared memory of one block of the split kernel for a GQA group of
// G heads of width D; 0 for a width the kernel does not take.
extern "C" long long decode_attention_smem(int G, int D, int bf16) {
  if (!takes_head_dim(D)) return 0;
  switch (padded_width(D)) {
    case 64: return bf16 ? smem_bytes<__nv_bfloat16, 64>(G) : smem_bytes<float, 64>(G);
    case 128: return bf16 ? smem_bytes<__nv_bfloat16, 128>(G) : smem_bytes<float, 128>(G);
    case 192: return bf16 ? smem_bytes<__nv_bfloat16, 192>(G) : smem_bytes<float, 192>(G);
    default: return bf16 ? smem_bytes<__nv_bfloat16, 256>(G) : smem_bytes<float, 256>(G);
  }
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

// Launches both kernels on `stream` and returns cudaGetLastError(); 0 means
// launched.  scratch: B * H * splits * (D + 2) floats; chunk: keys per split,
// splits * chunk >= S.  bf16 != 0:
// bfloat16 tensors, else float32.  softcap <= 0: no softcap; scale
// multiplies the logits (the wrapper passes D^-0.5 unless asked).
extern "C" int decode_attention(const void* q, const void* k, const void* v, const void* lengths,
                                void* o, void* scratch, int B, int H, int Hkv, int S, int D,
                                int splits, int chunk, int bf16, float softcap, float scale,
                                void* stream) {
  return launch_any(q, k, v, lengths, o, nullptr, scratch, B, H, Hkv, S, D, splits, chunk, bf16, softcap,
                    scale, stream);
}

// The same, and each row's softmax state into lse [B, H] f32.
extern "C" int decode_attention_state(const void* q, const void* k, const void* v, const void* lengths,
                                      void* o, void* lse, void* scratch, int B, int H, int Hkv, int S,
                                      int D, int splits, int chunk, int bf16, float softcap, float scale,
                                      void* stream) {
  return launch_any(q, k, v, lengths, o, static_cast<float*>(lse), scratch, B, H, Hkv, S, D, splits, chunk,
                    bf16, softcap, scale, stream);
}

extern "C" const char* cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
