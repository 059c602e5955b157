// Row loads and stores shared by the kernels, and the head widths the
// attention kernels take: rows of float32 or bfloat16 read with 16-byte
// vector loads into float32 shared memory, and float32 results stored as
// either type (bf16 rounded to nearest even).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// Head widths the attention kernels take: multiples of 8 from 8 to 256,
// so a bf16 row is whole 16-byte units (TMA's row stride, the 16-byte
// loads), each held in a padded width of 64, 128, 192 or 256 columns whose
// columns past D are zeros.
__host__ __device__ constexpr bool takes_head_dim(int D) { return D >= 8 && D <= 256 && D % 8 == 0; }
__host__ __device__ constexpr int padded_width(int D) { return (D + 63) / 64 * 64; }

__device__ __forceinline__ void unpack(const uint4& raw, float* x, const float*) {
  const float* f = reinterpret_cast<const float*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) x[e] = f[e];
}

__device__ __forceinline__ void unpack(const uint4& raw, float* x, const __nv_bfloat16*) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    x[2 * e] = f.x;
    x[2 * e + 1] = f.y;
  }
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// `rows` rows of D elements, row r at src + r * src_stride (each row starting
// on a 16-byte boundary), into dst as f32 times `mul`, with row stride
// `stride`; rows at or past `valid` are zero.  Every thread of the block
// takes part.
template <typename T>
__device__ __forceinline__ void load_rows_strided(float* dst, int stride, const T* src,
                                                  size_t src_stride, int rows, int D, int valid,
                                                  float mul) {
  constexpr int kVec = 16 / sizeof(T);
  const int per_row = D / kVec;
  for (int i = threadIdx.x; i < rows * per_row; i += blockDim.x) {
    const int r = i / per_row, c = (i % per_row) * kVec;
    float x[kVec];
    if (r < valid) {
      const uint4 raw = *reinterpret_cast<const uint4*>(src + r * src_stride + c);
      unpack(raw, x, src);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) x[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e) dst[r * stride + c + e] = x[e] * mul;
  }
}

// The same for rows that follow each other in src (row stride D).
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int stride, const T* src, int rows, int D,
                                          int valid, float mul) {
  load_rows_strided(dst, stride, src, static_cast<size_t>(D), rows, D, valid, mul);
}

}  // namespace
