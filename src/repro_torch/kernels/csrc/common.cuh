// Helpers shared by the attention kernels: element conversion and tile loads.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float softcap_f(float x, float cap) {
  return cap > 0.f ? cap * tanhf(x / cap) : x;
}

// Sum over the 32 lanes of a warp; every lane gets the total.
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Copy `rows` rows of D elements (row r at src + (row0 + r) * stride) into a
// float tile with row pitch LD, 16 bytes per thread per load.  Rows at or past
// `valid` are zero-filled.  Needs src and stride 16-byte aligned (checked by
// the Python wrapper).
template <typename T, int D, int LD, int NTHREADS>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int64_t stride,
                                          int row0, int rows, int valid) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CPR = D / VEC;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < rows * CPR; i += NTHREADS) {
    const int r = i / CPR, c = (i % CPR) * VEC;
    float* d = dst + r * LD + c;
    if (row0 + r < valid) {
      const uint4 raw = *reinterpret_cast<const uint4*>(src + (int64_t)(row0 + r) * stride + c);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int u = 0; u < VEC; ++u) d[u] = to_f(e[u]);
    } else {
#pragma unroll
      for (int u = 0; u < VEC; ++u) d[u] = 0.f;
    }
  }
}

}  // namespace repro_torch
