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
// first walk along the sequence stores the state entering each stage of T
// steps (B x ceil(S / T) x R fp32 of scratch, 1 MB a batch row at S =
// 2048, R = 4096, T = 32); the backward walk then takes the stages last to
// first, recomputes the stage's states from its stored start, and walks
// them downwards.  Each state is recomputed as the forward computes it,
// round(round(a * s) + b), so the states are bitwise the forward's.
//
// What bounds it on this card: bytes.  The function reads a, b and g and
// writes da and db once (5 x 134 MB at B = 4, S = 2048, R = 4096 in fp32,
// 0.20 ms at 3.35 TB/s) for five operations an element; this kernel reads a
// and b twice (7 passes, 0.28 ms).  The chain of dependent steps is cheap;
// what the card needs is bytes in flight.  So K3's ring (rglru_scan.cu):
// one block takes C channels of one batch row (rglru_scan.plan_bwd: C and T
// as K3's plan, P stages of a, b and g); PRODUCERS warps fill each stage with
// one-dimensional bulk copies, a row of C elements a step, on the stage's
// "full" mbarrier; one consumer thread a channel walks its column and
// releases the stage through its "empty" mbarrier.  The ring is filled
// 2 x ceil(S / T) times: a and b of the stages first to last (the states),
// then a, b and g of the stages last to first (the gradient), the
// recomputed states of a stage going to an fp32 area of T x C beside the
// ring, each thread's own column.
//
// The register variant is the kernel this file held before the ring: one
// thread a (b, r) channel walking t, consecutive threads on consecutive r,
// a state stored every CH = 16 steps, the CH steps of a chunk loaded into
// registers before its chain is walked.  It takes the shapes bulk copies
// cannot (R * itemsize % 16 != 0, or a base that is not 16-byte aligned)
// and problems too small to repay the ring, as K3 decides (rglru_scan.SMALL);
// which one runs is decided before the launch, and neither falls back to
// the other.  Both give the same bits: every step is rounded as written (no
// contraction into fused multiply-adds): ds = round(g + carry), carry =
// round(a * ds), da = round(ds * s).
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
cudaError_t launch_regs(const void* a, const void* b, const float* s0, const void* g,
                        const float* g_last, void* da, void* db, float* ds0, float* starts,
                        int B, int S, int R, cudaStream_t stream) {
  const dim3 grid((R + THREADS - 1) / THREADS, B);
  rglru_bwd_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), s0, static_cast<const T*>(g), g_last,
      static_cast<T*>(da), static_cast<T*>(db), ds0, starts, S, R);
  return cudaGetLastError();
}

// ---- the ring variant ----

constexpr int MAX_STAGES = 32;
constexpr int PRODUCERS = 8;                   // producer warps a block, as K3's ring
constexpr int BAR_BYTES = 2 * MAX_STAGES * 8;  // full[], empty[]; the tiles follow
constexpr int MAX_SMEM = 232448;               // 227 KB, a block's most
constexpr int U = 16;   // steps a consumer loads at once on the way up
constexpr int UD = 8;   // and on the way down (three arrays: at 16 the fp32 build spilled)

// Fill k of the ring: stage k of the sequence, a and b (k < stages), or
// stage 2·stages - 1 - k, a, b and g.  Stage p's tiles, T x C each, at
// tiles + 3pTC in that order.
struct Fill {
  int stage, ntiles;
  __device__ __forceinline__ Fill(int k, int stages)
      : stage(k < stages ? k : 2 * stages - 1 - k), ntiles(k < stages ? 2 : 3) {}
};

// The consumers' two walks (see the header): thread c (C of them) takes
// channel r0 + c.  FULL: every thread's channel exists (nr == C), so no
// store is predicated (K3's ring says why).
template <typename E, int C, bool FULL>
__device__ __forceinline__ void consume_bwd(const E* tiles, float* states, uint64_t* full,
                                            uint64_t* empty, float s, float carry, bool live,
                                            float* start, E* da, E* db, float* ds0, int S,
                                            int R, int T, int P) {
  const int c = threadIdx.x % C, lane = threadIdx.x % 32;
  const int stages = (S + T - 1) / T;
  float* sv = states + c;  // this thread's column of the stage's states
  for (int k = 0; k < 2 * stages; ++k) {
    const Fill f(k, stages);
    const int p = k % P, t0 = f.stage * T, n = min(T, S - t0);
    mbar_wait(&full[p], (k / P) & 1);
    const E* ta = tiles + (int64_t)3 * p * T * C + c;
    const E* tb = ta + T * C;
    const E* tg = tb + T * C;
    float* st = start + (int64_t)f.stage * R;
    if (k < stages) {  // the states: store the stage's start, walk it
      if (FULL || live) *st = s;
      int u = 0;
      for (; u + U <= n; u += U) {
        float av[U], bv[U];
#pragma unroll
        for (int j = 0; j < U; ++j) {
          av[j] = to_f(ta[(u + j) * C]);
          bv[j] = to_f(tb[(u + j) * C]);
        }
#pragma unroll
        for (int j = 0; j < U; ++j) s = step(av[j], s, bv[j]);
      }
      for (; u < n; ++u) s = step(to_f(ta[u * C]), s, to_f(tb[u * C]));
    } else {  // the gradient: the stage's states again, then down
      s = FULL || live ? *st : 0.f;
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
          sv[(u + j) * C] = s;  // s_{t-1} of step t0 + u + j
          s = step(av[j], s, bv[j]);
        }
      }
      for (; u < n; ++u) {
        sv[u * C] = s;
        s = step(to_f(ta[u * C]), s, to_f(tb[u * C]));
      }
      const int64_t at = (int64_t)t0 * R;
      int hi = n;
      for (; hi >= UD; hi -= UD) {
        float av[UD], gv[UD], pv[UD];
#pragma unroll
        for (int j = 0; j < UD; ++j) {
          const int uu = hi - UD + j;
          av[j] = to_f(ta[uu * C]);
          gv[j] = to_f(tg[uu * C]);
          pv[j] = sv[uu * C];
        }
#pragma unroll
        for (int j = UD - 1; j >= 0; --j) {
          const int64_t o = at + (int64_t)(hi - UD + j) * R;
          const float ds = __fadd_rn(gv[j], carry);
          if (FULL || live) {
            da[o] = from_f<E>(__fmul_rn(ds, pv[j]));
            db[o] = from_f<E>(ds);
          }
          carry = __fmul_rn(av[j], ds);
        }
      }
      for (int uu = hi - 1; uu >= 0; --uu) {
        const int64_t o = at + (int64_t)uu * R;
        const float ds = __fadd_rn(to_f(tg[uu * C]), carry);
        if (FULL || live) {
          da[o] = from_f<E>(__fmul_rn(ds, sv[uu * C]));
          db[o] = from_f<E>(ds);
        }
        carry = __fmul_rn(to_f(ta[uu * C]), ds);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[p]);
  }
  if (FULL || live) *ds0 = carry;
}

// The block is C consumer threads, then PRODUCERS warps; channels
// r0 = blockIdx.x · C .. of batch row blockIdx.y.
template <typename E, int C>
__global__ void __launch_bounds__(C + 32 * PRODUCERS)
    rglru_bwd_ring_kernel(const E* __restrict__ a, const E* __restrict__ b,
                          const float* __restrict__ s0, const E* __restrict__ g,
                          const float* __restrict__ g_last, E* __restrict__ da,
                          E* __restrict__ db, float* __restrict__ ds0,
                          float* __restrict__ starts, int S, int R, int T, int P) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + MAX_STAGES;
  E* tiles = reinterpret_cast<E*>(smem + BAR_BYTES);
  float* states = reinterpret_cast<float*>(tiles + (int64_t)3 * P * T * C);
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
    // fill's rows (a's n, then b's, then g's), after arming the stage's
    // barrier with their bytes.
    const int w = warp - C / 32, span = 32 * PRODUCERS;
    for (int k = 0; k < 2 * stages; ++k) {
      const Fill f(k, stages);
      const int p = k % P, t0 = f.stage * T, n = min(T, S - t0), rows = f.ntiles * n;
      if (lane == 0) {
        if (k >= P) mbar_wait(&empty[p], ((k / P) + 1) & 1);  // fill k - P released
        const int mine = rows / span * 32 + min(32, max(0, rows % span - 32 * w));
        mbar_expect_tx(&full[p], mine * row);
      }
      __syncwarp();
      E* tile = tiles + (int64_t)3 * p * T * C;
      for (int i = w * 32 + lane; i < rows; i += span) {
        const int j = i / n, u = i - j * n;
        const E* src = j == 0 ? a : j == 1 ? b : g;
        bulk_load(tile + (j * T + u) * C, src + base + (int64_t)(t0 + u) * R, row, &full[p]);
      }
    }
    return;
  }

  const int c = threadIdx.x;
  const bool live = c < nr;
  const int64_t chan = (int64_t)blockIdx.y * R + r0 + c;
  const float s = live ? s0[chan] : 0.f, carry = live ? g_last[chan] : 0.f;
  float* start = starts + (int64_t)blockIdx.y * stages * R + r0 + c;
  if (nr == C)
    consume_bwd<E, C, true>(tiles, states, full, empty, s, carry, live, start, da + base + c,
                            db + base + c, ds0 + chan, S, R, T, P);
  else
    consume_bwd<E, C, false>(tiles, states, full, empty, s, carry, live, start, da + base + c,
                             db + base + c, ds0 + chan, S, R, T, P);
}

template <typename E, int C>
cudaError_t launch_ring(const void* a, const void* b, const float* s0, const void* g,
                        const float* g_last, void* da, void* db, float* ds0, float* starts,
                        int B, int S, int R, int T, int P, int smem, cudaStream_t stream) {
  static int allowed = 48 * 1024;  // dynamic shared memory this kernel may take
  auto kernel = rglru_bwd_ring_kernel<E, C>;
  if (smem > allowed) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  const dim3 grid((R + C - 1) / C, B);
  kernel<<<grid, C + 32 * PRODUCERS, smem, stream>>>(
      static_cast<const E*>(a), static_cast<const E*>(b), s0, static_cast<const E*>(g), g_last,
      static_cast<E*>(da), static_cast<E*>(db), ds0, starts, S, R, T, P);
  return cudaGetLastError();
}

template <typename E>
cudaError_t launch_ring_c(const void* a, const void* b, const float* s0, const void* g,
                          const float* g_last, void* da, void* db, float* ds0, float* starts,
                          int B, int S, int R, int C, int T, int P, int smem, cudaStream_t st) {
  return C == 32 ? launch_ring<E, 32>(a, b, s0, g, g_last, da, db, ds0, starts, B, S, R, T, P,
                                      smem, st)
                 : launch_ring<E, 128>(a, b, s0, g, g_last, da, db, ds0, starts, B, S, R, T, P,
                                       smem, st);
}

}  // namespace
}  // namespace repro_torch

// a, b, g, da, db: (B, S, R) contiguous, dtype 0 = fp32, 1 = bf16; s0,
// g_last, ds0: (B, R) contiguous fp32.  variant 0 = register (C, T, P
// unread), starts (B, ceil(S / 16), R) fp32 scratch; 1 = ring of P stages
// of T steps, C = 32 or 128 channels a block, starts (B, ceil(S / T), R).
// The ring needs R * itemsize, a, b and g 16-byte aligned; a shape or plan
// it cannot take returns cudaErrorInvalidValue.
extern "C" int rglru_scan_bwd(const void* a, const void* b, const float* s0, const void* g,
                              const float* g_last, void* da, void* db, float* ds0,
                              float* starts, int B, int S, int R, int dtype, int variant, int C,
                              int T, int P, void* stream) {
  using namespace repro_torch;
  if (B < 0 || S < 0 || R < 0 || B > 65535 || (dtype != 0 && dtype != 1) ||
      (variant != 0 && variant != 1))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || R == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (variant == 0)
    return (int)(dtype == 0 ? launch_regs<float>(a, b, s0, g, g_last, da, db, ds0, starts, B, S,
                                                 R, st)
                            : launch_regs<__nv_bfloat16>(a, b, s0, g, g_last, da, db, ds0,
                                                         starts, B, S, R, st));
  const int64_t item = dtype == 0 ? 4 : 2;
  const int64_t smem = BAR_BYTES + 3 * (int64_t)P * T * C * item + 4 * (int64_t)T * C;
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if ((C != 32 && C != 128) || T < 1 || P < 1 || P > MAX_STAGES || smem > MAX_SMEM ||
      R * item % 16 != 0 || misaligned(a) || misaligned(b) || misaligned(g))
    return (int)cudaErrorInvalidValue;
  return (int)(dtype == 0 ? launch_ring_c<float>(a, b, s0, g, g_last, da, db, ds0, starts, B, S,
                                                 R, C, T, P, (int)smem, st)
                          : launch_ring_c<__nv_bfloat16>(a, b, s0, g, g_last, da, db, ds0,
                                                         starts, B, S, R, C, T, P, (int)smem,
                                                         st));
}
