// RG-LRU scan backward on Hopper (sm_90a): the gradient of the recurrence
// s_t = a_t * s_{t-1} + b_t (csrc/rglru_scan.cu), computed in fp32.
//
// Replaces no TPU kernel: the reference differentiates its RG-LRU with
// XLA (jax.lax.associative_scan in src/repro/models/rglru.py:73-87).  Same
// function as the gradient of rglru_scan_fwd: given g (B, S, R), the
// gradient of the states, in the type of a, and g_last (B, R) fp32, that of
// the last state, the reversed scan
//   ds_{S-1} = g_{S-1} + g_last,  ds_t = g_t + a_{t+1} ds_{t+1},
//   da_t = ds_t s_{t-1},  db_t = ds_t,  ds0 = a_0 ds_0,
// with da, db in the type of a and ds0 in fp32.
//
// The states.  da_t needs the fp32 state s_{t-1}.  With bf16 a and b the
// forward's stored states are rounded to bf16, so this kernel does not read
// them: it recomputes the fp32 states from a, b and s0, for both types.  A
// first walk along the sequence stores the state entering each chunk of CH
// steps (B x ceil(S / CH) x R fp32 of scratch, 8 MB at B = 4, S = 2048,
// R = 4096); the backward walk then takes the chunks last to first,
// recomputes the chunk's CH states in registers from its stored start, and
// walks them downwards.  Each state is recomputed as the forward computes
// it, round(round(a * s) + b), so the states are bitwise the forward's.
//
// What bounds it on this card: bytes.  The function reads a, b and g and
// writes da and db once (5 x 134 MB at B = 4, S = 2048, R = 4096 in fp32,
// 0.20 ms at 3.35 TB/s) for five operations an element; this kernel reads a
// and b twice.  One thread a (b, r) channel walks t, consecutive threads on
// consecutive r, so every load and store is coalesced; the CH steps of a
// chunk are loaded into registers before its chain is walked.  A first,
// simple kernel: B x R threads (16384 at recurrentgemma-9b's training
// shape) keep too few bytes in flight to reach the bound.
//
// Every step is rounded as written (no contraction into fused multiply-adds):
// ds = round(g + carry), carry = round(a * ds), da = round(ds * s).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int THREADS = 128;
// steps between stored states, walked in registers: at 32 the fp32
// instantiation spilled (128 registers, three arrays of CH)
constexpr int CH = 16;

__device__ __forceinline__ float step(float a, float s, float b) {
  return __fadd_rn(__fmul_rn(a, s), b);
}

// Channel r = blockIdx.x * THREADS + threadIdx.x of batch row blockIdx.y.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    rglru_bwd_kernel(const T* __restrict__ a, const T* __restrict__ b,
                     const float* __restrict__ s0, const T* __restrict__ g,
                     const float* __restrict__ g_last, T* __restrict__ da,
                     T* __restrict__ db, float* __restrict__ ds0,
                     float* __restrict__ starts, int S, int R) {
  const int r = blockIdx.x * THREADS + threadIdx.x;
  if (r >= R) return;
  const int64_t base = (int64_t)blockIdx.y * S * R + r;
  const int64_t chan = (int64_t)blockIdx.y * R + r;
  const int nch = (S + CH - 1) / CH;
  float* start = starts + (int64_t)blockIdx.y * nch * R + r;

  // the state entering each chunk
  float s = s0[chan];
  for (int c = 0; c < nch; ++c) {
    start[(int64_t)c * R] = s;
    const int t0 = c * CH, n = min(CH, S - t0);
    float av[CH], bv[CH];
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      if (i < n) {
        av[i] = to_f(a[base + (int64_t)(t0 + i) * R]);
        bv[i] = to_f(b[base + (int64_t)(t0 + i) * R]);
      }
    }
#pragma unroll
    for (int i = 0; i < CH; ++i)
      if (i < n) s = step(av[i], s, bv[i]);
  }

  // the chunks last to first: their states again, then the reversed scan
  float carry = g_last[chan];
  for (int c = nch - 1; c >= 0; --c) {
    const int t0 = c * CH, n = min(CH, S - t0);
    float av[CH], prev[CH], gv[CH];
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      if (i < n) {
        const int64_t at = base + (int64_t)(t0 + i) * R;
        av[i] = to_f(a[at]);
        prev[i] = to_f(b[at]);  // b_t for now; s_{t-1} after the walk below
        gv[i] = to_f(g[at]);
      }
    }
    float st = start[(int64_t)c * R];
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      if (i < n) {
        const float bi = prev[i];
        prev[i] = st;
        st = step(av[i], st, bi);
      }
    }
#pragma unroll
    for (int i = CH - 1; i >= 0; --i) {
      if (i < n) {
        const int64_t at = base + (int64_t)(t0 + i) * R;
        const float ds = __fadd_rn(gv[i], carry);
        da[at] = from_f<T>(__fmul_rn(ds, prev[i]));
        db[at] = from_f<T>(ds);
        carry = __fmul_rn(av[i], ds);
      }
    }
  }
  ds0[chan] = carry;
}

template <typename T>
cudaError_t launch(const void* a, const void* b, const float* s0, const void* g,
                   const float* g_last, void* da, void* db, float* ds0, float* starts, int B,
                   int S, int R, cudaStream_t stream) {
  const dim3 grid((R + THREADS - 1) / THREADS, B);
  rglru_bwd_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), s0, static_cast<const T*>(g), g_last,
      static_cast<T*>(da), static_cast<T*>(db), ds0, starts, S, R);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// a, b, g, da, db: (B, S, R) contiguous, dtype 0 = fp32, 1 = bf16; s0,
// g_last, ds0: (B, R) contiguous fp32; starts: (B, ceil(S / 16), R) fp32
// scratch.
extern "C" int rglru_scan_bwd(const void* a, const void* b, const float* s0, const void* g,
                              const float* g_last, void* da, void* db, float* ds0,
                              float* starts, int B, int S, int R, int dtype, void* stream) {
  using namespace repro_torch;
  if (B < 0 || S < 0 || R < 0 || B > 65535 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || R == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 0
                   ? launch<float>(a, b, s0, g, g_last, da, db, ds0, starts, B, S, R, st)
                   : launch<__nv_bfloat16>(a, b, s0, g, g_last, da, db, ds0, starts, B, S, R,
                                           st));
}
