// RG-LRU scan on Hopper (sm_90a): the gated linear recurrence
// s_t = a_t * s_{t-1} + b_t along the sequence, computed in fp32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rglru_scan.py ::
// rglru_scan (_rglru_kernel).  Same function: a, b (B, S, R) in fp32 or
// bf16 and s0 (B, R) in fp32; every state (B, S, R) out in the type of a,
// the last one (B, R) in fp32.  As there, a and b are widened to fp32 and
// the carried state stays fp32; only the stored states are rounded to the
// type of a.  Not its block structure: any B, S and R, with no S % chunk or
// R % block_r condition.
//
// What bounds it on this card: bytes.  Each element of a and b is read once
// and each state written once, for two operations per element, against the
// H100's 67 fp32 TFLOP/s / 3.35 TB/s = 20 operations per byte.  The TPU
// kernel walked S-chunks in grid order with the state in VMEM scratch.  Here
// the sequence is a loop inside one thread: one thread owns one (b, r)
// channel, consecutive r on consecutive lanes, so each step's loads and
// stores are coalesced 128-byte rows; the loads of U steps do not depend on
// the state and are issued together before the U dependent steps, to keep
// bytes in flight.  At B = 4, R = 4096 that is only 16,384 threads, about
// 1/8 of what the card holds, so latency rather than bandwidth sets the
// pace; a chunked two-pass scan (per-chunk products and offsets, then a
// carry pass) is the later speed-up.
//
// Each step is rounded as round(round(a * s) + b), not fused into one
// multiply-add, so the states are bitwise those of the plain version
// (two rounded PyTorch operations per step, then one rounding to the type
// of a for the stored state).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int THREADS = 128;
constexpr int U = 16;  // steps whose loads are in flight together

template <typename T>
__global__ void __launch_bounds__(THREADS)
    rglru_kernel(const T* __restrict__ a, const T* __restrict__ b,
                 const float* __restrict__ s0, T* __restrict__ seq,
                 float* __restrict__ last, int S, int R) {
  const int r = blockIdx.x * THREADS + threadIdx.x;
  if (r >= R) return;
  const int64_t base = (int64_t)blockIdx.y * S * R + r;
  const T* A = a + base;
  const T* Bv = b + base;
  T* O = seq + base;
  float s = s0[(int64_t)blockIdx.y * R + r];
  int t = 0;
  for (; t + U <= S; t += U) {
    float av[U], bv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      av[u] = to_f(A[(int64_t)(t + u) * R]);
      bv[u] = to_f(Bv[(int64_t)(t + u) * R]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      s = __fadd_rn(__fmul_rn(av[u], s), bv[u]);
      O[(int64_t)(t + u) * R] = from_f<T>(s);
    }
  }
  for (; t < S; ++t) {
    s = __fadd_rn(__fmul_rn(to_f(A[(int64_t)t * R]), s), to_f(Bv[(int64_t)t * R]));
    O[(int64_t)t * R] = from_f<T>(s);
  }
  last[(int64_t)blockIdx.y * R + r] = s;
}

template <typename T>
cudaError_t launch(const void* a, const void* b, const float* s0, void* seq, float* last,
                   int B, int S, int R, cudaStream_t stream) {
  const dim3 grid((R + THREADS - 1) / THREADS, B);
  rglru_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), s0, static_cast<T*>(seq), last,
      S, R);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// a, b, seq: (B, S, R) contiguous, dtype 0 = fp32, 1 = bf16; s0, last:
// (B, R) contiguous fp32.
extern "C" int rglru_scan_fwd(const void* a, const void* b, const float* s0, void* seq,
                              float* last, int B, int S, int R, int dtype, void* stream) {
  using namespace repro_torch;
  if (B < 0 || S < 0 || R < 0 || B > 65535 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || R == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 0 ? launch<float>(a, b, s0, seq, last, B, S, R, st)
                          : launch<__nv_bfloat16>(a, b, s0, seq, last, B, S, R, st));
}
