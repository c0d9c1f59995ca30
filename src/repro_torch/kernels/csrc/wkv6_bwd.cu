// RWKV6 WKV backward on Hopper (sm_90a): the gradient of the recurrence of
// csrc/wkv6.cu, per (batch, head) with head size N = 64 or 32:
//
//   o_t = r_t^T S_{t-1} + (r_t ⊙ u ⊙ k_t)·1 v_t,   S_t = diag(e^{w_t}) S_{t-1} + k_t v_t^T
//
// Replaces no TPU kernel: the reference differentiates its chunked WKV with
// XLA (src/repro/models/rwkv6.py:29-91).  Same function as the gradient of
// wkv6_fwd: given do (B, S, H, N) in the type of r and dS (B, H, N, N) fp32,
// the gradient of the final state, it returns dr, dk, dv in the type of r,
// dlogw (B, S, H, N), du (H, N) and dstate0 (B, H, N, N) in fp32.
//
// Sequentially, with G_t the gradient of S_t (G_{S-1} = dS):
//   G_{t-1} = diag(w_t) G_t + r_t do_t^T,      dr_t = S_{t-1} do_t + (u ⊙ k_t)(v_t·do_t)
//   dk_t = G_t v_t + (r_t ⊙ u)(v_t·do_t),      dv_t = G_t^T k_t + (r_t·(u ⊙ k_t)) do_t
//   du = Σ_t (r_t ⊙ k_t)(v_t·do_t),            dlogw_t = w_t ⊙ rowsum(G_t ⊙ S_{t-1})
// (ref.wkv6_backward_reference).  Here in the chunked form of the forward,
// chunks of T = 32 steps, the tail padded with r = k = v = do = 0, logw = 0
// as the forward pads it (wkv6_backward_chunked_reference in
// tests/test_torch_recurrent_grad.py states every term).  Four launches:
// - chain (states): per (b, h), the state entering every chunk, S_{c+1} =
//   D ⊙ S_c + (k ⊙ sd)^T V from state0 (D = e^{Σ w} of the chunk from a
//   double sum rounded once, sd_s = Π_{j>s} e^{w_j} a running product), into
//   scratch: recomputed, not saved by the forward, so that inference writes
//   nothing more; 268 MB at rwkv6-7b's B 4, H 64, S 2048, freed after the
//   call;
// - chain (gradient): per (b, h), chunks last to first, the gradient of the
//   state leaving every chunk, Go_{c-1} = D ⊙ Go_c + (r ⊙ pd)^T dO from dS
//   (pd_t = Π_{j<t} e^{w_j}), into scratch; what it ends with is dstate0;
// - grads: every chunk on its own block, in parallel, from S_c and Go_c:
//   dr, dk, dv, dlogw and the chunk's part of du (see grads_kernel);
// - du: the chunks' parts summed per head in a fixed order.
// No atomics anywhere: every output has one writer, and du's sum has one
// order, so the result is deterministic, as the trainer's bitwise restart
// needs.  The chains are sequential over chunks per (b, h), not cut into
// the forward's segments (plan_segments): B·H blocks (256 at rwkv6-7b's
// training shape) cover the card at training batch sizes.
//
// What bounds it on this card.  The sequential gradient takes about 14N^2
// fp32 operations a step (the state recomputed, G carried, and dr, dk, dv
// and dlogw each an N x N contraction), against reading r, k, v, do, logw
// and writing dr, dk, dv, dlogw once: at N = 64 with bf16 r/k/v about 190
// operations a byte, above the H100's 67 fp32 TFLOP/s / 3.35 TB/s = 20, so
// operations bound it (0.46 ms at rwkv6-7b's training shape, its bytes
// 0.22 ms).  This kernel does them on the CUDA cores in fp32 FMA, one
// block of 8 warps an SM (134 KB of shared memory at N = 64): a first,
// simple kernel.  Every decay is a running product of factors e^{w} <= 1, so
// none overflows; a product below fp32's range underflows to 0, as the true
// one does.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int T = 32;  // steps a chunk, the forward's
constexpr int WARPS = 8, THREADS = 32 * WARPS;

// Rows t0 .. t0 + T - 1 of one head (element (t, d) at head + t·row + d) as
// fp32 into dst[t][d], zeros past S.
template <typename Tin, int N, int P>
__device__ __forceinline__ void load_rows(float (*dst)[P], const Tin* __restrict__ src,
                                          int64_t head, int64_t row, int t0, int S) {
  for (int idx = threadIdx.x; idx < T * N; idx += THREADS) {
    const int t = idx / N, d = idx % N;
    dst[t][d] = t0 + t < S ? to_f(src[head + (int64_t)(t0 + t) * row + d]) : 0.f;
  }
}

// ---- the chains ----

template <int N>
struct ChainSmem {
  float x[T][N + 4];  // k or r, then decayed: k ⊙ sd (states) or r ⊙ pd (gradient)
  float y[T][N + 4];  // v or do
  float w[T][N + 4];  // logw
  float decay[N];     // the chunk's D
};

// M (N x N, per (b, h) = (blockIdx.y, blockIdx.x)) from m0 through the
// chunks, first to last (states) or last to first (REVERSE, the gradient):
// before each chunk's update M is stored in saved[b, h, c]; then
// M = D ⊙ M + X^T Y, rounded as D·M once and then T fused multiply-adds.
// Thread (ty, tx) of 16 x 16 holds rows ty·TD .. and columns tx·TD .. of M.
template <typename Tin, int N, bool REVERSE>
__global__ void __launch_bounds__(THREADS)
    chain_kernel(const Tin* __restrict__ xs, const Tin* __restrict__ ys,
                 const float* __restrict__ logw, const float* __restrict__ m0,
                 float* __restrict__ saved, float* __restrict__ m_end, int S, int H, int C) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ChainSmem<N>& sm = *reinterpret_cast<ChainSmem<N>*>(smem_raw);
  constexpr int TD = N / 16;
  const int h = blockIdx.x, b = blockIdx.y;
  const int64_t row = (int64_t)H * N, head = ((int64_t)b * S * H + h) * N;
  const int64_t bh = (int64_t)b * H + h;
  const int d0 = threadIdx.x / 16 * TD, e0 = threadIdx.x % 16 * TD;
  float m[TD][TD];
#pragma unroll
  for (int i = 0; i < TD; ++i)
#pragma unroll
    for (int j = 0; j < TD; ++j) m[i][j] = m0[bh * N * N + (d0 + i) * N + e0 + j];
  for (int step = 0; step < C; ++step) {
    const int c = REVERSE ? C - 1 - step : step;
    float* out = saved + (bh * C + c) * N * N;
#pragma unroll
    for (int i = 0; i < TD; ++i)
#pragma unroll
      for (int j = 0; j < TD; ++j) out[(d0 + i) * N + e0 + j] = m[i][j];
    load_rows<Tin, N>(sm.x, xs, head, row, c * T, S);
    load_rows<Tin, N>(sm.y, ys, head, row, c * T, S);
    load_rows<float, N>(sm.w, logw, head, row, c * T, S);
    __syncthreads();
    if (threadIdx.x < N) {  // column d: x ⊙ its running product of e^w
      const int d = threadIdx.x;
      float f = 1.f;
      if (REVERSE) {
        for (int t = 0; t < T; ++t) {  // pd_t = Π_{j<t}
          sm.x[t][d] *= f;
          f *= expf(sm.w[t][d]);
        }
      } else {
        for (int t = T - 1; t >= 0; --t) {  // sd_t = Π_{j>t}
          sm.x[t][d] *= f;
          f *= expf(sm.w[t][d]);
        }
      }
    } else if (threadIdx.x < 2 * N) {  // column d: D = e^{Σ w}, the sum in double
      const int d = threadIdx.x - N;
      double ls = 0.0;
      for (int t = 0; t < T; ++t) ls += (double)sm.w[t][d];
      sm.decay[d] = expf((float)ls);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < TD; ++i) {
      const float dt = sm.decay[d0 + i];
#pragma unroll
      for (int j = 0; j < TD; ++j) m[i][j] = __fmul_rn(dt, m[i][j]);
    }
    for (int t = 0; t < T; ++t) {
      float xv[TD], yv[TD];
#pragma unroll
      for (int i = 0; i < TD; ++i) xv[i] = sm.x[t][d0 + i];
#pragma unroll
      for (int j = 0; j < TD; ++j) yv[j] = sm.y[t][e0 + j];
#pragma unroll
      for (int i = 0; i < TD; ++i)
#pragma unroll
        for (int j = 0; j < TD; ++j) m[i][j] = fmaf(xv[i], yv[j], m[i][j]);
    }
    __syncthreads();  // every thread is done with this chunk's rows
  }
  if (m_end != nullptr) {
#pragma unroll
    for (int i = 0; i < TD; ++i)
#pragma unroll
      for (int j = 0; j < TD; ++j) m_end[bh * N * N + (d0 + i) * N + e0 + j] = m[i][j];
  }
}

// ---- every chunk's gradients ----

// Pitches of N + 1 and T + 1 floats: rows read by lanes of consecutive
// columns, and columns read by lanes of consecutive rows, are both free of
// bank conflicts.
template <int N>
struct GradSmem {
  static constexpr int NP = N + 1, TP = T + 1;
  float r[T][NP], k[T][NP], v[T][NP], o[T][NP];  // r, k, v, do
  float ew[T][NP];                               // e^{logw}
  float pd[T][NP];                               // Π_{j<t} e^{w_j}
  float sd[T][NP];                               // Π_{j>t} e^{w_j}; first logw
  float sc[N][NP];                               // S_c, the state entering the chunk
  float go[N][NP];                               // Go_c, the gradient of the one leaving it
  float p[T][TP];                                // P = dO V^T
  float a[T][TP];                                // A, the forward's intra-chunk matrix
  float part[WARPS][T][TP];  // A's per-warp partial sums; then r ⊙ dr′, k ⊙ dk′'s two parts
  float u[N];
  float decay[N];
};

// Chunk c = blockIdx.z of (b, h) = (blockIdx.y, blockIdx.x), from S_c and
// Go_c (wkv6_backward_chunked_reference in the tests):
//   dr′_t = pd_t ⊙ (S_c do_t) + Σ_{s<t} P[t,s] k_s ⊙ Π_{s<j<t} e_j,   dr = dr′ + P[t,t] u ⊙ k_t
//   dk′_s = sd_s ⊙ (Go_c v_s) + Σ_{τ>s} P[τ,s] r_τ ⊙ Π_{s<j<τ} e_j,   dk = dk′ + P[t,t] u ⊙ r_t
//   dv_t = Σ_d k_t sd_t Go_c[d, :] + Σ_{τ>=t} A[τ,t] do_τ
//   dlogw_t = D ⊙ rowsum(Go_c ⊙ S_c) + Σ_{s<t} k_s ⊙ sd_s ⊙ (Go_c v_s)
//             + Σ_{τ>t} r_τ ⊙ dr′_τ − Σ_{s>=t} k_s ⊙ (Σ_{τ>s} P[τ,s] r_τ Π e)
// the last the reverse-cumsum identity of the chunked form, with the bonus
// terms (u) out of it; du's part Σ_t P[t,t] r_t ⊙ k_t into du_part.
template <typename Tin, int N>
__global__ void __launch_bounds__(THREADS)
    grads_kernel(const Tin* __restrict__ r, const Tin* __restrict__ k,
                 const Tin* __restrict__ v, const float* __restrict__ logw,
                 const float* __restrict__ u, const Tin* __restrict__ dout,
                 const float* __restrict__ states, const float* __restrict__ gouts,
                 Tin* __restrict__ dr, Tin* __restrict__ dk, Tin* __restrict__ dv,
                 float* __restrict__ dlogw, float* __restrict__ du_part, int S, int H, int C) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  GradSmem<N>& sm = *reinterpret_cast<GradSmem<N>*>(smem_raw);
  constexpr int NP = GradSmem<N>::NP;
  const int h = blockIdx.x, b = blockIdx.y, c = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int64_t row = (int64_t)H * N, head = ((int64_t)b * S * H + h) * N;
  const int64_t bh = (int64_t)b * H + h;
  const int t0 = c * T;
  load_rows<Tin, N>(sm.r, r, head, row, t0, S);
  load_rows<Tin, N>(sm.k, k, head, row, t0, S);
  load_rows<Tin, N>(sm.v, v, head, row, t0, S);
  load_rows<Tin, N>(sm.o, dout, head, row, t0, S);
  load_rows<float, N>(sm.sd, logw, head, row, t0, S);
  const float* ms = states + (bh * C + c) * N * N;
  const float* mg = gouts + (bh * C + c) * N * N;
  for (int idx = tid; idx < N * N; idx += THREADS) {
    sm.sc[idx / N][idx % N] = ms[idx];
    sm.go[idx / N][idx % N] = mg[idx];
  }
  if (tid < N) sm.u[tid] = u[(int64_t)h * N + tid];
  __syncthreads();

  if (tid < N) {  // column d: e^w, D, and the running products both ways
    const int d = tid;
    double ls = 0.0;
    for (int t = 0; t < T; ++t) {
      const float lw = sm.sd[t][d];
      ls += (double)lw;
      sm.ew[t][d] = expf(lw);
    }
    sm.decay[d] = expf((float)ls);
    float f = 1.f;
    for (int t = 0; t < T; ++t) {
      sm.pd[t][d] = f;
      f *= sm.ew[t][d];
    }
    f = 1.f;
    for (int t = T - 1; t >= 0; --t) {
      sm.sd[t][d] = f;
      f *= sm.ew[t][d];
    }
  }
  for (int idx = tid; idx < T * T; idx += THREADS) {  // P[t, s] = do_t · v_s
    const int t = idx / T, s = idx % T;
    float acc = 0.f;
    for (int e = 0; e < N; ++e) acc = fmaf(sm.o[t][e], sm.v[s][e], acc);
    sm.p[t][s] = acc;
  }
  __syncthreads();

  {  // A: warp w sums columns d of [w DW, (w + 1) DW); lane t walks τ with
     // kD = k_t ⊙ Π_{t<j<τ} e_j (the bonus Σ r u k at τ = t, 0 above)
    constexpr int DW = N / WARPS;
    const int d0 = warp * DW, t = lane;
    float kD[DW], bonus = 0.f;
#pragma unroll
    for (int i = 0; i < DW; ++i) {
      kD[i] = sm.k[t][d0 + i];
      bonus = fmaf(sm.r[t][d0 + i], sm.u[d0 + i] * kD[i], bonus);
    }
    for (int tau = 0; tau < T; ++tau) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < DW; ++i) dot = fmaf(sm.r[tau][d0 + i], kD[i], dot);
      sm.part[warp][tau][t] = tau > t ? dot : tau == t ? bonus : 0.f;
      if (tau > t) {
#pragma unroll
        for (int i = 0; i < DW; ++i) kD[i] *= sm.ew[tau][d0 + i];
      }
    }
  }
  __syncthreads();
  for (int idx = tid; idx < T * T; idx += THREADS) {
    const int tau = idx / T, t = idx % T;
    float s = sm.part[0][tau][t];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) s += sm.part[w][tau][t];
    sm.a[tau][t] = s;
  }
  __syncthreads();

  // dr, dk, dv at (t, d), d also the value index of dv; the terms of dlogw
  float(*rdr)[NP] = reinterpret_cast<float(*)[NP]>(&sm.part[0][0][0]);  // r ⊙ dr′
  float(*ksd)[NP] = rdr + T;                                              // k ⊙ sd ⊙ (Go v)
  float(*kin)[NP] = rdr + 2 * T;  // k ⊙ Σ_{τ>s} P[τ,s] r_τ Π e
  const int d = tid % N;
  for (int t = tid / N; t < T; t += THREADS / N) {
    float srow = 0.f, grow = 0.f;
    for (int e = 0; e < N; ++e) {
      srow = fmaf(sm.sc[d][e], sm.o[t][e], srow);
      grow = fmaf(sm.go[d][e], sm.v[t][e], grow);
    }
    const float dr_state = sm.pd[t][d] * srow, dk_state = sm.sd[t][d] * grow;
    float dr_in = 0.f, f = 1.f;
    for (int s = t - 1; s >= 0; --s) {
      dr_in = fmaf(sm.p[t][s] * sm.k[s][d], f, dr_in);
      f *= sm.ew[s][d];
    }
    float dk_in = 0.f;
    f = 1.f;
    for (int tau = t + 1; tau < T; ++tau) {
      dk_in = fmaf(sm.p[tau][t] * sm.r[tau][d], f, dk_in);
      f *= sm.ew[tau][d];
    }
    float dv_t = 0.f;
    for (int dd = 0; dd < N; ++dd) dv_t = fmaf(sm.k[t][dd] * sm.sd[t][dd], sm.go[dd][d], dv_t);
    for (int tau = t; tau < T; ++tau) dv_t = fmaf(sm.a[tau][t], sm.o[tau][d], dv_t);
    const float dr_p = dr_state + dr_in, ptt = sm.p[t][t];
    rdr[t][d] = sm.r[t][d] * dr_p;
    ksd[t][d] = sm.k[t][d] * dk_state;
    kin[t][d] = sm.k[t][d] * dk_in;
    if (t0 + t < S) {
      const int64_t at = head + (int64_t)(t0 + t) * row + d;
      dr[at] = from_f<Tin>(dr_p + ptt * sm.u[d] * sm.k[t][d]);
      dk[at] = from_f<Tin>((dk_state + dk_in) + ptt * sm.u[d] * sm.r[t][d]);
      dv[at] = from_f<Tin>(dv_t);
    }
  }
  __syncthreads();

  if (tid < N) {  // column d: dlogw by the reverse-cumsum identity, and du's part
    float cst = 0.f, du_c = 0.f;
    for (int e = 0; e < N; ++e) cst = fmaf(sm.go[d][e], sm.sc[d][e], cst);
    cst *= sm.decay[d];
    float before[T];  // Σ_{s<t} k ⊙ sd ⊙ (Go v)
    float run = 0.f;
#pragma unroll
    for (int t = 0; t < T; ++t) {
      before[t] = run;
      run += ksd[t][d];
      du_c = fmaf(sm.p[t][t], sm.r[t][d] * sm.k[t][d], du_c);
    }
    float after_r = 0.f, from_i = 0.f;
#pragma unroll
    for (int t = T - 1; t >= 0; --t) {
      from_i += kin[t][d];
      if (t0 + t < S)
        dlogw[head + (int64_t)(t0 + t) * row + d] = ((cst + before[t]) + after_r) - from_i;
      after_r += rdr[t][d];
    }
    du_part[(bh * C + c) * N + d] = du_c;
  }
}

// du[h, d] = Σ_b Σ_c du_part[b, h, c, d], in that order.
template <int N>
__global__ void du_kernel(const float* __restrict__ du_part, float* __restrict__ du, int B,
                          int H, int C) {
  const int h = blockIdx.x, d = threadIdx.x;
  float acc = 0.f;
  for (int b = 0; b < B; ++b)
    for (int c = 0; c < C; ++c) acc += du_part[(((int64_t)b * H + h) * C + c) * N + d];
  du[(int64_t)h * N + d] = acc;
}

template <typename Tin, int N>
cudaError_t launch(const void* r, const void* k, const void* v, const float* logw,
                   const float* u, const float* s0, const void* dout, const float* dstate,
                   void* dr, void* dk, void* dv, float* dlogw, float* du, float* ds0,
                   float* states, float* gouts, float* du_part, int B, int S, int H,
                   cudaStream_t stream) {
  constexpr int CHAIN = sizeof(ChainSmem<N>), GRADS = sizeof(GradSmem<N>);
  static const cudaError_t attr = [] {
    const cudaError_t e1 = cudaFuncSetAttribute(
        chain_kernel<Tin, N, false>, cudaFuncAttributeMaxDynamicSharedMemorySize, CHAIN);
    const cudaError_t e2 = cudaFuncSetAttribute(
        chain_kernel<Tin, N, true>, cudaFuncAttributeMaxDynamicSharedMemorySize, CHAIN);
    const cudaError_t e3 = cudaFuncSetAttribute(
        grads_kernel<Tin, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, GRADS);
    return e1 != cudaSuccess ? e1 : e2 != cudaSuccess ? e2 : e3;
  }();
  if (attr != cudaSuccess) return attr;
  const int C = (S + T - 1) / T;
  const Tin *rr = static_cast<const Tin*>(r), *kk = static_cast<const Tin*>(k),
            *vv = static_cast<const Tin*>(v), *oo = static_cast<const Tin*>(dout);
  cudaError_t err;
  if (C > 0) {
    chain_kernel<Tin, N, false><<<dim3(H, B), THREADS, CHAIN, stream>>>(
        kk, vv, logw, s0, states, nullptr, S, H, C);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  chain_kernel<Tin, N, true><<<dim3(H, B), THREADS, CHAIN, stream>>>(rr, oo, logw, dstate,
                                                                      gouts, ds0, S, H, C);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (C > 0) {
    grads_kernel<Tin, N><<<dim3(H, B, C), THREADS, GRADS, stream>>>(
        rr, kk, vv, logw, u, oo, states, gouts, static_cast<Tin*>(dr), static_cast<Tin*>(dk),
        static_cast<Tin*>(dv), dlogw, du_part, S, H, C);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  du_kernel<N><<<H, N, 0, stream>>>(du_part, du, B, H, C);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// r, k, v, dout, dr, dk, dv: (B, S, H, N) contiguous, dtype 0 = fp32, 1 =
// bf16; logw, dlogw: (B, S, H, N), u, du: (H, N), s0, dstate, ds0: (B, H,
// N, N), all contiguous fp32; N = 32 or 64; scratch states and gouts (B, H,
// ceil(S / 32), N, N) and du_part (B, H, ceil(S / 32), N) fp32.
extern "C" int wkv6_bwd(const void* r, const void* k, const void* v, const float* logw,
                        const float* u, const float* s0, const void* dout, const float* dstate,
                        void* dr, void* dk, void* dv, float* dlogw, float* du, float* ds0,
                        float* states, float* gouts, float* du_part, int B, int S, int H, int N,
                        int dtype, void* stream) {
  using namespace repro_torch;
  if (B < 0 || S < 0 || H < 0 || B > 65535 || (S + T - 1) / T > 65535 ||
      (dtype != 0 && dtype != 1) || (N != 32 && N != 64))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0) return (int)cudaSuccess;
  using Launch = cudaError_t (*)(const void*, const void*, const void*, const float*,
                                 const float*, const float*, const void*, const float*, void*,
                                 void*, void*, float*, float*, float*, float*, float*, float*,
                                 int, int, int, cudaStream_t);
  const Launch fn = dtype == 0
                        ? (N == 64 ? &launch<float, 64> : &launch<float, 32>)
                        : (N == 64 ? &launch<__nv_bfloat16, 64> : &launch<__nv_bfloat16, 32>);
  return (int)fn(r, k, v, logw, u, s0, dout, dstate, dr, dk, dv, dlogw, du, ds0, states, gouts,
                 du_part, B, S, H, static_cast<cudaStream_t>(stream));
}
