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
// H100's 67 fp32 TFLOP/s / 3.35 TB/s = 20 operations per byte.  The chain of
// dependent steps is cheap (a rounded multiply, then a rounded add: ~8
// cycles a step, ~20 us over 4700 steps); what the card needs is bytes in
// flight, a few MB across its SMs to cover ~1 us of loaded latency.
//
// The TPU kernel stays sequential over S and streams chunks of the sequence
// through VMEM.  Its counterpart here is the ring variant: one block takes C
// channels of one batch row (rglru_scan.plan chooses C = 32 or 128, T steps
// a stage and P stages):
// - PRODUCERS warps fill stage p of a P-stage ring in dynamic shared
//   memory: for each of a and b, T one-dimensional bulk copies
//   (cp.async.bulk), one a step, each a row of C elements at stride R, all
//   completing on the stage's "full" mbarrier, which each producer warp arms
//   with the bytes of its own copies;
// - the consumers are one thread a channel: each waits on the stage, reads
//   its own column (consecutive lanes on consecutive words: no bank
//   conflicts), walks the T steps, stores each state with a coalesced
//   st.global, and releases the stage through its "empty" mbarrier (one
//   arrival a consumer warp); the producers refill it P stages ahead.
// So the bytes in flight are the ring's, not the registers of the threads
// that walk the chain (the register variant below, one thread a channel with
// 16 steps of loads in registers, holds at most 16 KB an SM in fp32 at
// B = 4, R = 4096, and 8 KB in bf16).
// What was measured and kept (PERF.md, PR 17):
// - Eight producer warps.  A warp's bulk copies issue one lane after
//   another, so one producer warp held a block to its copy rate whatever
//   the ring's depth; the rate grew with the warps up to eight.
// - The consumers load U steps of their column into registers, then walk
//   them, and store without a predicate where the block has all C channels:
//   a store under `if (live)` compiled to a branch and a 64-bit address
//   computation each, and that, not the data, set a consumer warp's pace.
// - States stored by each thread with st.global.  Staging them in shared
//   memory for bulk stores (cp.async.bulk.global.shared) was slower in both
//   types: the issuing warp's stores and barrier sat on the chain's path.
// - Bulk copies rather than a TMA tensor map: pointers change every call,
//   and a tensor map would cost a host-side encode each time.  Ampere-style
//   16-byte cp.async from the producer warps, and one full barrier per
//   producer warp, measured no faster.
//
// The register variant is the kernel this file held before the ring: it
// takes the shapes bulk copies cannot (R * itemsize % 16 != 0, or a base
// that is not 16-byte aligned), and problems too small to repay the ring
// (the calibration grid: rglru_scan.SMALL).  Which one runs is decided
// before the launch, from shape and alignment; neither falls back to the
// other.
//
// Each step is rounded as round(round(a * s) + b), not fused into one
// multiply-add, so in both variants the states are bitwise those of the
// plain version (two rounded PyTorch operations per step, then one rounding
// to nearest even to the type of a for the stored state).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace {

__device__ __forceinline__ float step(float a, float s, float b) {
  return __fadd_rn(__fmul_rn(a, s), b);
}

// ---- the register variant ----

constexpr int THREADS = 128;
constexpr int U = 16;  // steps whose loads are in flight together

template <typename T>
__global__ void __launch_bounds__(THREADS)
    rglru_regs_kernel(const T* __restrict__ a, const T* __restrict__ b,
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
      s = step(av[u], s, bv[u]);
      O[(int64_t)(t + u) * R] = from_f<T>(s);
    }
  }
  for (; t < S; ++t) {
    s = step(to_f(A[(int64_t)t * R]), s, to_f(Bv[(int64_t)t * R]));
    O[(int64_t)t * R] = from_f<T>(s);
  }
  last[(int64_t)blockIdx.y * R + r] = s;
}

// ---- the ring variant ----

constexpr int MAX_STAGES = 32;
constexpr int PRODUCERS = 8;  // producer warps a block (see the header)
constexpr int BAR_BYTES = 2 * MAX_STAGES * 8;  // full[], empty[]; the tiles follow
constexpr int MAX_SMEM = 232448;  // 227 KB, a block's most

// The consumers' walk: thread c (C of them) takes channel r0 + c through
// the stages of the ring, U steps of its column into registers at a time
// (the loads do not wait on the chain), then the U dependent steps, each
// state stored as it comes through a pointer that moves by a row a step.
// FULL: every thread's channel exists (nr == C), so no store is predicated:
// predicated stores cost a branch and a 64-bit address each, which at one
// consumer warp an SM set the pace.  Returns the last state.
template <typename E, int C, bool FULL>
__device__ __forceinline__ float consume(const E* tiles, uint64_t* full, uint64_t* empty,
                                        E* out, float s, bool live, int S, int R, int T,
                                        int P) {
  const int c = threadIdx.x % C, lane = threadIdx.x % 32;
  const int stages = (S + T - 1) / T;
  for (int k = 0; k < stages; ++k) {
    const int p = k % P, t0 = k * T, n = min(T, S - t0);
    mbar_wait(&full[p], (k / P) & 1);
    const E* ta = tiles + (int64_t)2 * p * T * C + c;
    const E* tb = ta + T * C;
    E* o = out + (int64_t)t0 * R;
    int u = 0;
    for (; u + U <= n; u += U) {
      float av[U], bv[U];
#pragma unroll
      for (int j = 0; j < U; ++j) {
        av[j] = to_f(ta[(u + j) * C]);
        bv[j] = to_f(tb[(u + j) * C]);
      }
#pragma unroll
      for (int j = 0; j < U; ++j) {
        s = step(av[j], s, bv[j]);
        if (FULL || live) *o = from_f<E>(s);
        o += R;
      }
    }
    for (; u < n; ++u) {
      s = step(to_f(ta[u * C]), s, to_f(tb[u * C]));
      if (FULL || live) *o = from_f<E>(s);
      o += R;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[p]);
  }
  return s;
}

// Stage p of the ring holds a's T x C tile, then b's, at tiles + 2pTC; row
// u of a tile is step t0 + u of the block's C channels.  The block is C
// consumer threads, then PRODUCERS warps.
template <typename E, int C>
__global__ void __launch_bounds__(C + 32 * PRODUCERS)
    rglru_ring_kernel(const E* __restrict__ a, const E* __restrict__ b,
                      const float* __restrict__ s0, E* __restrict__ seq,
                      float* __restrict__ last, int S, int R, int T, int P) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + MAX_STAGES;
  E* tiles = reinterpret_cast<E*>(smem + BAR_BYTES);
  const int r0 = blockIdx.x * C;
  const int nr = min(C, R - r0);
  const uint32_t row = nr * sizeof(E);  // bytes of one step's row
  const int64_t base = (int64_t)blockIdx.y * S * R + r0;
  const int stages = (S + T - 1) / T;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int p = 0; p < P; ++p) {
      mbar_init(&full[p], PRODUCERS);  // one arming arrival a producer warp
      mbar_init(&empty[p], C / 32);    // one release a consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= C / 32) {
    // Producer warp w copies rows i = 32w + lane + 32·PRODUCERS·j of the
    // stage's 2n (a's n rows, then b's), after arming the stage's barrier
    // with their bytes.
    const int w = warp - C / 32, span = 32 * PRODUCERS;
    for (int k = 0; k < stages; ++k) {
      const int p = k % P, t0 = k * T, n = min(T, S - t0), rows = 2 * n;
      if (lane == 0) {
        if (k >= P) mbar_wait(&empty[p], ((k / P) + 1) & 1);  // stage k - P released
        const int mine = rows / span * 32 + min(32, max(0, rows % span - 32 * w));
        mbar_expect_tx(&full[p], mine * row);
      }
      __syncwarp();
      E* tile = tiles + (int64_t)2 * p * T * C;
      for (int i = w * 32 + lane; i < rows; i += span) {
        const int u = i < n ? i : i - n;
        bulk_load(tile + (i < n ? u : T + u) * C, (i < n ? a : b) + base + (int64_t)(t0 + u) * R,
                  row, &full[p]);
      }
    }
    return;
  }

  const int c = threadIdx.x;
  const bool live = c < nr;
  float s = live ? s0[(int64_t)blockIdx.y * R + r0 + c] : 0.f;
  E* out = seq + base + c;
  s = nr == C ? consume<E, C, true>(tiles, full, empty, out, s, live, S, R, T, P)
              : consume<E, C, false>(tiles, full, empty, out, s, live, S, R, T, P);
  if (live) last[(int64_t)blockIdx.y * R + r0 + c] = s;
}

template <typename T>
cudaError_t launch_regs(const void* a, const void* b, const float* s0, void* seq, float* last,
                        int B, int S, int R, cudaStream_t stream) {
  const dim3 grid((R + THREADS - 1) / THREADS, B);
  rglru_regs_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), s0, static_cast<T*>(seq), last,
      S, R);
  return cudaGetLastError();
}

template <typename E, int C>
cudaError_t launch_ring(const void* a, const void* b, const float* s0, void* seq, float* last,
                        int B, int S, int R, int T, int P, int smem, cudaStream_t stream) {
  static int allowed = 48 * 1024;  // dynamic shared memory this kernel may take
  auto kernel = rglru_ring_kernel<E, C>;
  if (smem > allowed) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  const dim3 grid((R + C - 1) / C, B);
  kernel<<<grid, C + 32 * PRODUCERS, smem, stream>>>(static_cast<const E*>(a),
                                                     static_cast<const E*>(b), s0,
                                                     static_cast<E*>(seq), last, S, R, T, P);
  return cudaGetLastError();
}

template <typename E>
cudaError_t launch_ring_c(const void* a, const void* b, const float* s0, void* seq,
                          float* last, int B, int S, int R, int C, int T, int P, int smem,
                          cudaStream_t st) {
  return C == 32 ? launch_ring<E, 32>(a, b, s0, seq, last, B, S, R, T, P, smem, st)
                 : launch_ring<E, 128>(a, b, s0, seq, last, B, S, R, T, P, smem, st);
}

}  // namespace
}  // namespace repro_torch

// a, b, seq: (B, S, R) contiguous, dtype 0 = fp32, 1 = bf16; s0, last:
// (B, R) contiguous fp32.  variant 0 = register (C, T, P unread), 1 = ring
// of P stages of T steps, C = 32 or 128 channels a block.  The ring needs
// R * itemsize, a and b 16-byte aligned; a shape or plan it cannot take
// returns cudaErrorInvalidValue.
extern "C" int rglru_scan_fwd(const void* a, const void* b, const float* s0, void* seq,
                              float* last, int B, int S, int R, int dtype, int variant, int C,
                              int T, int P, void* stream) {
  using namespace repro_torch;
  if (B < 0 || S < 0 || R < 0 || B > 65535 || (dtype != 0 && dtype != 1) ||
      (variant != 0 && variant != 1))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || R == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (variant == 0)
    return (int)(dtype == 0 ? launch_regs<float>(a, b, s0, seq, last, B, S, R, st)
                            : launch_regs<__nv_bfloat16>(a, b, s0, seq, last, B, S, R, st));
  const int64_t item = dtype == 0 ? 4 : 2;
  const int64_t smem = BAR_BYTES + 2 * (int64_t)P * T * C * item;
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if ((C != 32 && C != 128) || T < 1 || P < 1 || P > MAX_STAGES || smem > MAX_SMEM ||
      R * item % 16 != 0 || misaligned(a) || misaligned(b))
    return (int)cudaErrorInvalidValue;
  return (int)(dtype == 0
                   ? launch_ring_c<float>(a, b, s0, seq, last, B, S, R, C, T, P, (int)smem, st)
                   : launch_ring_c<__nv_bfloat16>(a, b, s0, seq, last, B, S, R, C, T, P,
                                                  (int)smem, st));
}
