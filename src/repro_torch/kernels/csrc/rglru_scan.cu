// RG-LRU scan on Hopper (sm_90a): the gated linear recurrence
// s_t = a_t * s_{t-1} + b_t along the sequence, fp32 throughout.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rglru_scan.py ::
// rglru_scan (_rglru_kernel).  Same function: a, b (B, S, R) and s0 (B, R)
// in; every state (B, S, R) and the last one (B, R) out.  Not its block
// structure: any B, S and R, with no S % chunk or R % block_r condition.
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
// (two rounded PyTorch operations per step).
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {
namespace {

constexpr int THREADS = 128;
constexpr int U = 16;  // steps whose loads are in flight together

__global__ void __launch_bounds__(THREADS)
    rglru_kernel(const float* __restrict__ a, const float* __restrict__ b,
                 const float* __restrict__ s0, float* __restrict__ seq,
                 float* __restrict__ last, int S, int R) {
  const int r = blockIdx.x * THREADS + threadIdx.x;
  if (r >= R) return;
  const int64_t base = (int64_t)blockIdx.y * S * R + r;
  const float* A = a + base;
  const float* Bv = b + base;
  float* O = seq + base;
  float s = s0[(int64_t)blockIdx.y * R + r];
  int t = 0;
  for (; t + U <= S; t += U) {
    float av[U], bv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      av[u] = A[(int64_t)(t + u) * R];
      bv[u] = Bv[(int64_t)(t + u) * R];
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      s = __fadd_rn(__fmul_rn(av[u], s), bv[u]);
      O[(int64_t)(t + u) * R] = s;
    }
  }
  for (; t < S; ++t) {
    s = __fadd_rn(__fmul_rn(A[(int64_t)t * R], s), Bv[(int64_t)t * R]);
    O[(int64_t)t * R] = s;
  }
  last[(int64_t)blockIdx.y * R + r] = s;
}

}  // namespace
}  // namespace repro_torch

// a, b, seq: (B, S, R) contiguous fp32; s0, last: (B, R) contiguous fp32.
extern "C" int rglru_scan_fwd(const float* a, const float* b, const float* s0, float* seq,
                              float* last, int B, int S, int R, void* stream) {
  using namespace repro_torch;
  if (B < 0 || S < 0 || R < 0 || B > 65535) return (int)cudaErrorInvalidValue;
  if (B == 0 || R == 0) return (int)cudaSuccess;
  const dim3 grid((R + THREADS - 1) / THREADS, B);
  rglru_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a, b, s0, seq, last, S, R);
  return (int)cudaGetLastError();
}
