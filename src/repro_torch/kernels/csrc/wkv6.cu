// RWKV6 WKV recurrence on Hopper (sm_90a), per (batch, head) with head size
// N = 64 or 32 and an N x N fp32 state:
//
//   o_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
//   S_t = diag(e^{w_t}) S_{t-1} + k_t v_t^T
//
// Replaces the Pallas TPU kernel src/repro/kernels/wkv6.py :: wkv6
// (_wkv_kernel).  Same function: r, k, v (B, S, H, N) in bf16 or fp32, logw
// (B, S, H, N), u (H, N) and s0 (B, H, N, N) in fp32; out (B, S, H, N) in the
// type of r and the final state (B, H, N, N) in fp32.  Not its block
// structure: any S, with no S % chunk condition.
//
// What bounds it on this card: operations.  A step of one head does 5N^2 +
// 4N fp32 operations on 4N inputs, about 80 operations per byte read, four
// times the H100's 67 fp32 TFLOP/s / 3.35 TB/s.  The TPU kernel walked
// 32-step chunks of one head in grid order, carrying the state in VMEM
// scratch and doing each chunk's work as two MXU products.  Hopper blocks
// run in no order, so here the sequence is a loop inside one block: one
// block owns one (b, h) and its whole state, in registers: 4N threads, one
// warp per row group and 32 columns (256 threads at N = 64, 128 at N = 32).
// Warp w holds rows ROWS g .. ROWS g + ROWS - 1 of the state (ROWS = N / 4),
// g = w % 4, and lane l column e = 32 (w / 4) + l, so all lanes of a warp
// read the same r, k and e^w entries from shared memory (one broadcast
// each) and their own v_t[e].
// Every step's state update is elementwise, and each warp writes its part
// of o_t[e] (its ROWS rows' sum) to shared memory, so no step waits on
// another warp: the block meets at a barrier once per chunk of TC steps.
// There the next chunk's r, k, e^w and v, loaded from device memory while
// the current chunk ran, land in the other half of a double buffer, and
// after it the four row groups' parts of the chunk's outputs are summed
// and written, one coalesced row of the head per step.  The ROWS state
// entries, ROWS entries of u and the prefetched chunk stay in registers.
//
// The state update is rounded as round(round(e^w * s) + round(k * v)), not
// fused, the arithmetic of the plain version's PyTorch operations; the
// output's sum runs in another order than the plain version's product.  The
// chunked tensor-core form (the TPU kernel's algorithm on wgmma) is the later
// speed-up.  At N = 32 (the calibration's heads) the block is 128 threads
// and the state 8 rows a thread.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int TC = 8;          // steps per staged chunk

// N: head size; 4 row groups x N / 32 column groups, one warp each
template <typename T, int N, int THREADS = 4 * N, int ROWS = N / 4>
__global__ void __launch_bounds__(THREADS)
    wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                const float* __restrict__ logw, const float* __restrict__ u,
                const float* __restrict__ s0, T* __restrict__ out, float* __restrict__ sf,
                int S, int H) {
  __shared__ __align__(16) float stage[2][TC][4][N];  // [buf][step][r, k, e^w, v][n]
  __shared__ float part[2][TC][4][N];                 // [buf][step][row group][e]
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int g = warp & 3, e = (warp >> 2) * 32 + (tid & 31);
  const int64_t row = (int64_t)H * N;                       // one step of (H, N)
  const int64_t head = ((int64_t)b * S * H + h) * N;        // [b, 0, h, 0]
  const int64_t st = ((int64_t)b * H + h) * N * N;          // [b, h, 0, 0]

  float s[ROWS], uu[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    s[i] = s0[st + (int64_t)(g * ROWS + i) * N + e];
    uu[i] = u[(int64_t)h * N + g * ROWS + i];
  }

  // staging: thread tid loads array a = tid / N, element n = tid % N, of
  // each of a chunk's TC steps (one coalesced row of the head per step)
  const int a = tid / N, n = tid % N;
  float pre[TC];
  auto load = [&](int t0) {
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      const int t = t0 + j;
      const int64_t off = head + (int64_t)t * row + n;
      float x = 0.f;
      if (t < S) {
        if (a == 0) x = to_f(r[off]);
        else if (a == 1) x = to_f(k[off]);
        else if (a == 2) x = logw[off];
        else x = to_f(v[off]);
      }
      pre[j] = x;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int j = 0; j < TC; ++j) stage[buf][j][a][n] = a == 2 ? expf(pre[j]) : pre[j];
  };

  load(0);
  store(0);
  __syncthreads();
  for (int t0 = 0, cur = 0; t0 < S; t0 += TC, cur ^= 1) {
    const bool more = t0 + TC < S;
    if (more) load(t0 + TC);       // in flight while this chunk runs
    const int steps = min(TC, S - t0);
    for (int j = 0; j < steps; ++j) {
      const float4* r4 = reinterpret_cast<const float4*>(&stage[cur][j][0][g * ROWS]);
      const float4* k4 = reinterpret_cast<const float4*>(&stage[cur][j][1][g * ROWS]);
      const float4* w4 = reinterpret_cast<const float4*>(&stage[cur][j][2][g * ROWS]);
      float rr[ROWS], kk[ROWS], ww[ROWS];
#pragma unroll
      for (int q = 0; q < ROWS / 4; ++q) {
        const float4 x = r4[q], y = k4[q], z = w4[q];
        rr[4 * q] = x.x; rr[4 * q + 1] = x.y; rr[4 * q + 2] = x.z; rr[4 * q + 3] = x.w;
        kk[4 * q] = y.x; kk[4 * q + 1] = y.y; kk[4 * q + 2] = y.z; kk[4 * q + 3] = y.w;
        ww[4 * q] = z.x; ww[4 * q + 1] = z.y; ww[4 * q + 2] = z.z; ww[4 * q + 3] = z.w;
      }
      const float ve = stage[cur][j][3][e];
      float acc = 0.f, bonus = 0.f;
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        acc = fmaf(rr[i], s[i], acc);                        // r^T S_{t-1}
        bonus = fmaf(rr[i] * uu[i], kk[i], bonus);           // r^T diag(u) k
        s[i] = __fadd_rn(__fmul_rn(ww[i], s[i]), __fmul_rn(kk[i], ve));
      }
      part[cur][j][g][e] = fmaf(bonus, ve, acc);
    }
    if (more) store(cur ^ 1);      // that half was last read before the previous barrier
    __syncthreads();
    // o_t[c] = the four row groups' parts; part[cur] is next written two
    // barriers from here
    for (int idx = tid; idx < steps * N; idx += THREADS) {
      const int j = idx / N, c = idx % N;
      const float o = ((part[cur][j][0][c] + part[cur][j][1][c]) + part[cur][j][2][c])
                      + part[cur][j][3][c];
      out[head + (int64_t)(t0 + j) * row + c] = from_f<T>(o);
    }
  }
#pragma unroll
  for (int i = 0; i < ROWS; ++i) sf[st + (int64_t)(g * ROWS + i) * N + e] = s[i];
}

template <typename T, int N>
cudaError_t launch(const void* r, const void* k, const void* v, const float* logw,
                   const float* u, const float* s0, void* out, float* sf, int B, int S,
                   int H, cudaStream_t stream) {
  wkv6_kernel<T, N><<<dim3(H, B), 4 * N, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v), logw,
      u, s0, static_cast<T*>(out), sf, S, H);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// r, k, v, out: (B, S, H, N) contiguous, dtype 0 = fp32, 1 = bf16; logw:
// (B, S, H, N) fp32; u: (H, N) fp32; s0, sf: (B, H, N, N) fp32; N = 32 or 64.
extern "C" int wkv6_fwd(const void* r, const void* k, const void* v, const float* logw,
                        const float* u, const float* s0, void* out, float* sf, int B,
                        int S, int H, int N, int dtype, void* stream) {
  using namespace repro_torch;
  if (B < 0 || S < 0 || H < 0 || B > 65535 || (dtype != 0 && dtype != 1) ||
      (N != 32 && N != 64))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0) return (int)cudaSuccess;
  using Launch = cudaError_t (*)(const void*, const void*, const void*, const float*,
                                 const float*, const float*, void*, float*, int, int, int,
                                 cudaStream_t);
  const Launch fn = dtype == 0
                        ? (N == 64 ? &launch<float, 64> : &launch<float, 32>)
                        : (N == 64 ? &launch<__nv_bfloat16, 64> : &launch<__nv_bfloat16, 32>);
  return (int)fn(r, k, v, logw, u, s0, out, sf, B, S, H, static_cast<cudaStream_t>(stream));
}
