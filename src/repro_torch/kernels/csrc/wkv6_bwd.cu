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
// as the forward pads it.  Within a chunk, with e_j = e^{w_j}, pd_t =
// Π_{j<t} e_j, sd_s = Π_{j>s} e_j, D = e^{Σ w}, S_c the state entering it,
// Go_c the gradient of the one leaving it and P = dO V^T (T x T):
//   dr′_t = pd_t ⊙ (S_c do_t) + Σ_{s<t} P[t,s] k_s ⊙ Π_{s<j<t} e_j,   dr = dr′ + P[t,t] u ⊙ k_t
//   dk′_s = sd_s ⊙ (Go_c v_s) + Σ_{τ>s} P[τ,s] r_τ ⊙ Π_{s<j<τ} e_j,   dk = dk′ + P[t,t] u ⊙ r_t
//   dv = (k ⊙ sd) Go_c + A^T dO   (A the forward's intra-chunk matrix)
//   dlogw_t = D ⊙ rowsum(Go_c ⊙ S_c) + Σ_{s<t} k_s ⊙ sd_s ⊙ (Go_c v_s)
//             + Σ_{τ>t} r_τ ⊙ dr′_τ − Σ_{s>=t} k_s ⊙ (dk′_s − sd_s ⊙ (Go_c v_s))
// the last the reverse-cumsum identity of the chunked form, the bonus terms
// (u) out of it; du = Σ_t P[t,t] r_t ⊙ k_t; and the chains
//   S_{c+1} = D ⊙ S_c + (k ⊙ sd)^T V,   Go_{c-1} = D ⊙ Go_c + (r ⊙ pd)^T dO
// (tests/test_torch_wkv6_bwd_chunked.py holds this decomposition, the
// segments and the tf32 parts below, in plain PyTorch).
//
// What bounds it on this card.  The sequential gradient takes about 14N^2
// fp32 operations a step against reading r, k, v, do, logw and writing dr,
// dk, dv, dlogw once: at N = 64 with bf16 r/k/v about 190 operations a
// byte, so operations bound it on the CUDA cores (0.46 ms at rwkv6-7b's
// training shape, its bytes 0.22 ms).  The chunked form puts nearly all of
// them in products of 32 to 64 rows, which run here on the tensor cores:
// - Every contraction is mma.sync.m16n8k8 tf32, each fp32 operand split into
//   its tf32 part and the tf32 rounding of what that leaves (tf32_split):
//   one product where both operands are bf16 values (exact in tf32: P at
//   bf16), two where one is (S_c·do, Go·v, A^T·dO, the chains' updates),
//   three where neither is (the decayed products, every product at fp32),
//   WKV_BWD_TF32_PASSES at most; each k8 step summed from zero and added
//   to its accumulator in IEEE fp32, as the forward does.
// - The intra-chunk sums (dr′'s and dk′'s second terms, and A) by the
//   forward's block-boundary factorisation: the diagonal 8 x 8 blocks on the
//   CUDA cores as short walks; the blocks below them on the tensor cores,
//   the pair's decay Π_{s<j<t} e_j cut at a block boundary b into a row
//   factor Π_{b<=j<t} and a column factor Π_{s<j<b}, both <= 1 (b = 16 for
//   rows 16.. against columns ..15, b = 8 and 24 for the two 8 x 8 blocks
//   left).  No e^{-Σ w} and no division anywhere: every decay is a product
//   of factors e^w <= 1, so none overflows; one below fp32's range
//   underflows to 0, as the true one does.  Only a chunk's and a segment's
//   own decays are e^{Σ w} of a double sum rounded once.
// - Parallel over the sequence: each (b, h) is cut into the forward's P
//   segments of Lc chunks (wkv6.plan_segments, B·H·P ≈ 2048 blocks), and
//   both chains are chained per segment as the forward chains its states.
//
// Four launches (the first two only where P > 1):
// - seg_kernel: every segment but the last runs from a zero state to its
//   state contribution U_p, every segment but the first from a zero
//   gradient at its end back to its gradient contribution V_p, each with the
//   segment's decay d_p;
// - seg_chain_kernel: per (b, h), the state entering every segment,
//   S_{p+1} = d_p ⊙ S_p + U_p from state0, and the gradient leaving it,
//   G_{p-1} = d_p ⊙ G_p + V_p from dS, elementwise, in place;
// - grads_kernel: one block a segment.  It walks the segment's chunks
//   forward from its incoming state, storing each chunk's state in scratch
//   (B·H·ceil(S/32)·N² fp32, 268 MB at rwkv6-7b's training shape, written
//   and read back by the same block, so mostly through L2), then backward
//   from the gradient leaving it, carrying Go_c in shared memory through the
//   gradient chain's update (so the chunks' gradients never reach device
//   memory) and writing dr, dk, dv, dlogw and the segment's part of du; the
//   first segment's walk ends with dstate0;
// - du_kernel: the segments' parts summed per head in a fixed order.
// No atomics anywhere: every output has one writer, and every sum one
// order, so two calls give the same bits, as the trainer's bitwise restart
// needs.
//
// Resources: 8 warps a block; at N = 64 in bf16, r, k, v and do stay bf16
// in shared memory and a block takes 110 KiB, so two blocks share an SM (in
// fp32 126 KiB, one block); the grads kernel at the 128 registers that two
// blocks of 256 threads leave, no spill.  Measured (PERF.md, PR 25): the
// kernel is latency-bound per chunk; unrolled k8 loops, one block an SM
// with more registers, double-buffered chain loads and taking the chunks'
// states from the segment pass were each slower or no faster.  The column passes (e^w, the running products
// and the factors, dlogw's sums) give each thread a column and a block of 8
// steps, the blocks' totals exchanged through shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

// tf32 products per operand product where neither operand is a bf16 value
// (1, 2 or 3; see above); a product with one bf16 operand takes at most 2,
// one of two bf16 operands 1
#ifndef WKV_BWD_TF32_PASSES
#define WKV_BWD_TF32_PASSES 3
#endif
static_assert(WKV_BWD_TF32_PASSES >= 1 && WKV_BWD_TF32_PASSES <= 3, "1, 2 or 3 tf32 passes");

namespace repro_torch {
namespace {

constexpr int T = 32;   // steps a chunk, the forward's
constexpr int Q = 8;    // the diagonal blocks, walked on the CUDA cores
constexpr int H2 = T / 2;
constexpr int WARPS = 8, THREADS = 32 * WARPS;

// Shared memory of a block.  Row pitches: fp32 rows of N + 4 floats (an
// A-operand fragment, rows g and columns q, reads 32 banks); bf16 input
// rows of N + 8 elements (16-byte rows for cp.async).
template <typename Tin, int N>
struct Smem {
  static constexpr int NP = N + 4, IP = N + (sizeof(Tin) == 2 ? 8 : 4);
  Tin r[T][IP], k[T][IP], v[T][IP], o[T][IP];  // r, k, v, do of the chunk
  float ew[T][NP];   // e^{logw}; then k ⊙ (dk′'s intra-chunk term)
  float pd[T][NP];   // Π_{j<t} e^{w_j}
  float sd[T][NP];   // Π_{j>t} e^{w_j}
  float fr[T][NP];   // row factors: [t - 16] Π_{16<=j<t} (t >= 16), [16 + t - 8] and
                     // [24 + t - 24] Π_{b<=j<t} (t in 8..15, b = 8; 24..31, b = 24)
  float fk[T][NP];   // column factors: [s] Π_{s<j<16} (s < 16), [16 + s] and
                     // [24 + s - 16] Π_{s<j<b} (s < 8, b = 8; 16..23, b = 24);
                     // then k ⊙ sd ⊙ (Go v)
  float sc[N][NP];   // the state entering the chunk (the running state forward);
                     // then r ⊙ dr′ in its first T rows
  float go[N][NP];   // the gradient of the state leaving it
  float p[T][T + 4];  // P = dO V^T
  float a[T][T + 4];  // A, [τ][t]; zero above its diagonal
  float blk[4][N];    // the column passes' per-block totals
  float blk2[3][4][N];
  double lsum[4][N];  // per-block Σ logw
  float dec[N];       // the chunk's decay D
  float tot[N];       // D ⊙ rowsum(Go ⊙ S_c)
  float u[N];
};

// An A fragment: its tf32 parts, or (EXACT: bf16 values) the values' bits.
template <bool EXACT>
struct Frag {
  uint32_t big[4], small[4];
  __device__ __forceinline__ explicit Frag(const float (&x)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (EXACT) {
        big[i] = __float_as_uint(x[i]);
      } else {
        tf32_split(x[i], big[i], small[i]);
      }
    }
  }
};

// acc += a · b for one k8 step: a (16 x 8) as its fragment, b (8 x 8) as its
// two fp32 fragment values; AX, BX: the operand holds bf16 values.  The
// product is summed from zero in its tf32 passes, smallest first, and added
// to acc in IEEE fp32.  Fragments (g = lane / 4, q = lane % 4): a = {(g, q),
// (g + 8, q), (g, q + 4), (g + 8, q + 4)}, b = {(k q, n g), (k q + 4, n g)},
// acc = {(g, 2q), (g, 2q + 1), (g + 8, 2q), (g + 8, 2q + 1)}.
template <bool AX, bool BX>
__device__ __forceinline__ void mma_parts(float (&acc)[4], const Frag<AX>& a, float b0f,
                                          float b1f) {
  constexpr int PASSES = WKV_BWD_TF32_PASSES;
  uint32_t bb0, bs0 = 0, bb1, bs1 = 0;
  if constexpr (BX) {
    bb0 = __float_as_uint(b0f);
    bb1 = __float_as_uint(b1f);
  } else {
    tf32_split(b0f, bb0, bs0);
    tf32_split(b1f, bb1, bs1);
  }
  float d[4];
  if constexpr ((AX && BX) || PASSES == 1) {
    mma_tf32_fresh(d, a.big, bb0, bb1);
  } else if constexpr (AX) {  // a exact: + a·small_b
    mma_tf32_fresh(d, a.big, bs0, bs1);
    mma_tf32(d, a.big, bb0, bb1);
  } else if constexpr (BX || PASSES == 2) {  // + small_a·b
    mma_tf32_fresh(d, a.small, bb0, bb1);
    mma_tf32(d, a.big, bb0, bb1);
  } else {  // + big_a·small_b + small_a·big_b
    mma_tf32_fresh(d, a.big, bs0, bs1);
    mma_tf32(d, a.small, bb0, bb1);
    mma_tf32(d, a.big, bb0, bb1);
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += d[e];
}

// acc[j] += A · B_j over the k8 steps k0, k0 + 8, .. < k1 for NT tiles
// of 16 x 8: fa(m, k) gives A's element (row m < 16, depth k), fb(k, j) B_j's
// (depth k, this lane's column g of tile j).
template <bool AX, bool BX, int NT, typename FA, typename FB>
__device__ __forceinline__ void mma_steps(float (&acc)[NT][4], int k0, int k1, FA&& fa,
                                          FB&& fb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  for (int kk = k0; kk < k1; kk += 8) {
    const float x[4] = {fa(g, kk + q), fa(g + 8, kk + q), fa(g, kk + q + 4),
                        fa(g + 8, kk + q + 4)};
    const Frag<AX> a(x);
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_parts<AX, BX>(acc[j], a, fb(kk + q, j), fb(kk + q + 4, j));
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
}

// T rows of a head (element (t, d) at src + head + (t0 + t)·row + d) into
// dst, 16 bytes a copy, zeros past S; committed by the caller.
template <typename Tin, int N>
__device__ __forceinline__ void load_rows(Tin (*dst)[Smem<Tin, N>::IP],
                                          const Tin* __restrict__ src, int64_t head,
                                          int64_t row, int t0, int S) {
  constexpr int VEC = 16 / sizeof(Tin), PER = N / VEC;
  for (int i = threadIdx.x; i < T * PER; i += THREADS) {
    const int t = i / PER, d = i % PER * VEC;
    const bool ok = t0 + t < S;
    cp_async16(&dst[t][d], src + head + (int64_t)(ok ? t0 + t : 0) * row + d, ok);
  }
}

// An N x N fp32 matrix from device memory into rows of pitch N + 4.
template <int N>
__device__ __forceinline__ void load_square(float (*dst)[N + 4], const float* __restrict__ src) {
  for (int i = threadIdx.x; i < N * N / 4; i += THREADS)
    cp_async16(&dst[i / (N / 4)][i % (N / 4) * 4], src + 4 * i, true);
}
template <int N>
__device__ __forceinline__ void store_square(float* __restrict__ dst, const float (*src)[N + 4]) {
  for (int i = threadIdx.x; i < N * N / 4; i += THREADS)
    reinterpret_cast<float4*>(dst)[i] =
        *reinterpret_cast<const float4*>(&src[i / (N / 4)][i % (N / 4) * 4]);
}

// The column pass's first half, on thread (d, b) = (tid % N, tid / N) for
// tid < 4N: logw of steps 8b .. 8b + 7 of column d, e^w into ew, the
// running products of e^w within the block both ways (lp[i] = Π_{j<i},
// ls[i] = Π_{j>i}), the block's product and its Σ logw into blk and lsum.
template <typename Tin, int N>
__device__ __forceinline__ void column_local(Smem<Tin, N>& sm, const float* __restrict__ logw,
                                             int64_t head, int64_t row, int t0, int S,
                                             float (&lp)[Q], float (&ls)[Q]) {
  const int d = threadIdx.x % N, b = threadIdx.x / N;
  float e[Q];
  double sum = 0.0;
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    const int t = Q * b + i;
    const float w = t0 + t < S ? logw[head + (int64_t)(t0 + t) * row + d] : 0.f;
    sum += (double)w;
    e[i] = expf(w);
    sm.ew[t][d] = e[i];
  }
  float f = 1.f;
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    lp[i] = f;
    f *= e[i];
  }
  sm.blk[b][d] = f;
  sm.lsum[b][d] = sum;
  f = 1.f;
#pragma unroll
  for (int i = Q - 1; i >= 0; --i) {
    ls[i] = f;
    f *= e[i];
  }
}

// The chunk's decay D = e^{Σ w} from the blocks' sums (thread b = 0), in
// order; returns the chunk's Σ w.
template <typename Tin, int N>
__device__ __forceinline__ double column_decay(Smem<Tin, N>& sm, int d) {
  const double sum = ((sm.lsum[0][d] + sm.lsum[1][d]) + sm.lsum[2][d]) + sm.lsum[3][d];
  sm.dec[d] = expf((float)sum);
  return sum;
}

// Products of the blocks' e^w products before and after block b.
template <typename Tin, int N>
__device__ __forceinline__ void column_outer(const Smem<Tin, N>& sm, int d, int b,
                                             float& before, float& after) {
  before = after = 1.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (i < b) before *= sm.blk[i][d];
    if (i > b) after *= sm.blk[i][d];
  }
}

// M = D ⊙ M + (X ⊙ F)^T Y for a chunk (N x N, depth T) on the warps' tiles
// of M: warp w takes row tile w % (N / 16) of 16 d and NS column tiles of
// 8 e.  States: X = k, F = sd, Y = v; the gradient (GRAD): r, pd, do.
template <typename Tin, int N, bool GRAD>
__device__ __forceinline__ void chain_update(Smem<Tin, N>& sm, float (*M)[N + 4]) {
  constexpr int MT = N / 16, NS = N * MT / 64;
  constexpr bool EXACT = sizeof(Tin) == 2;
  const auto& X = GRAD ? sm.r : sm.k;
  const auto& Y = GRAD ? sm.o : sm.v;
  const auto& F = GRAD ? sm.pd : sm.sd;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int m0 = 16 * (warp % MT), n0 = 8 * (warp / MT) * NS;
  float acc[NS][4];
  zero(acc);
  mma_steps<false, EXACT>(
      acc, 0, T, [&](int m, int t) { return to_f(X[t][m0 + m]) * F[t][m0 + m]; },
      [&](int t, int j) { return to_f(Y[t][n0 + 8 * j + g]); });
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int d = m0 + g + 8 * h;
    const float dt = sm.dec[d];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      float2* at = reinterpret_cast<float2*>(&M[d][n0 + 8 * j + 2 * q]);
      const float2 old = *at;
      *at = make_float2(fmaf(dt, old.x, acc[j][2 * h]), fmaf(dt, old.y, acc[j][2 * h + 1]));
    }
  }
}

// One chunk of a chain: the inputs (k, v for the states; r, do for the
// gradient) of chunk c, the running products (sd; pd for GRAD) and the
// decay, then M = D ⊙ M + (X ⊙ F)^T Y in sm.sc.  Returns the chunk's Σ logw
// on the threads d < N.  Starts and ends with every thread past a barrier.
template <typename Tin, int N, bool GRAD>
__device__ __forceinline__ double chain_chunk(Smem<Tin, N>& sm, const Tin* __restrict__ xs,
                                              const Tin* __restrict__ ys,
                                              const float* __restrict__ logw, int64_t head,
                                              int64_t row, int c, int S) {
  load_rows<Tin, N>(GRAD ? sm.r : sm.k, xs, head, row, c * T, S);
  load_rows<Tin, N>(GRAD ? sm.o : sm.v, ys, head, row, c * T, S);
  cp_async_commit();
  const bool col = threadIdx.x < 4 * N;
  const int d = threadIdx.x % N, b = threadIdx.x / N;
  float lp[Q], ls[Q];
  if (col) column_local(sm, logw, head, row, c * T, S, lp, ls);
  cp_async_wait<0>();
  __syncthreads();
  double sum = 0.0;
  if (col) {
    float before, after;
    column_outer(sm, d, b, before, after);
#pragma unroll
    for (int i = 0; i < Q; ++i) {
      if constexpr (GRAD) {
        sm.pd[Q * b + i][d] = before * lp[i];
      } else {
        sm.sd[Q * b + i][d] = ls[i] * after;
      }
    }
    if (b == 0) sum = column_decay(sm, d);
  }
  __syncthreads();
  chain_update<Tin, N, GRAD>(sm, sm.sc);
  __syncthreads();
  return sum;
}

// Two adjacent entries (t, d), (t, d + 1) of a (B, S, H, N) output.
template <typename Tin>
__device__ __forceinline__ void store2(Tin* __restrict__ out, int64_t at, float x0, float x1) {
  if constexpr (sizeof(Tin) == 4) {
    *reinterpret_cast<float2*>(out + at) = make_float2(x0, x1);
  } else {
    *reinterpret_cast<__nv_bfloat162*>(out + at) = __floats2bfloat162_rn(x0, x1);
  }
}

// Pass 1 (P > 1): blockIdx.z = p < P - 1: segment p of (b, h) =
// (blockIdx.y, blockIdx.x) from a zero state → its state contribution U_p
// (seg_state[b, h, p]) and decay d_p (seg_decay[b, h, p]); blockIdx.z =
// P - 2 + p for p >= 1: segment p from a zero gradient at its end back to
// its start → V_p (seg_grad[b, h, p - 1]), and d_{P-1} from p = P - 1.
template <typename Tin, int N>
__global__ void __launch_bounds__(THREADS, 2)
    seg_kernel(const Tin* __restrict__ r, const Tin* __restrict__ k, const Tin* __restrict__ v,
               const float* __restrict__ logw, const Tin* __restrict__ dout,
               float* __restrict__ seg_state, float* __restrict__ seg_grad,
               float* __restrict__ seg_decay, int S, int H, int P, int Lc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<Tin, N>& sm = *reinterpret_cast<Smem<Tin, N>*>(smem_raw);
  const bool grad = (int)blockIdx.z >= P - 1;
  const int h = blockIdx.x, b = blockIdx.y, p = grad ? blockIdx.z - (P - 2) : blockIdx.z;
  const int64_t row = (int64_t)H * N, head = ((int64_t)b * S * H + h) * N;
  const int64_t bh = (int64_t)b * H + h;
  for (int i = threadIdx.x; i < N * (N + 4); i += THREADS) (&sm.sc[0][0])[i] = 0.f;
  const int C = (S + T - 1) / T, c0 = p * Lc, c1 = min(c0 + Lc, C);
  double seg = 0.0;
  if (grad) {
    for (int c = c1 - 1; c >= c0; --c)
      seg += chain_chunk<Tin, N, true>(sm, r, dout, logw, head, row, c, S);
  } else {
    for (int c = c0; c < c1; ++c)
      seg += chain_chunk<Tin, N, false>(sm, k, v, logw, head, row, c, S);
  }
  store_square<N>(grad ? seg_grad + (bh * (P - 1) + p - 1) * N * N
                       : seg_state + (bh * (P - 1) + p) * N * N,
                  sm.sc);
  if (threadIdx.x < N && (!grad || p == P - 1))
    seg_decay[(bh * P + p) * N + threadIdx.x] = expf((float)seg);
}

// Pass 2 (P > 1), per (b, h) = (blockIdx.y, blockIdx.x), in place:
// blockIdx.z = 0: the state entering each segment, S_1 = d_0 ⊙ s0 + U_0,
// S_{p+1} = d_p ⊙ S_p + U_p; blockIdx.z = 1: the gradient leaving each
// segment, G_{P-2} = d_{P-1} ⊙ dS + V_{P-1}, G_{p-1} = d_p ⊙ G_p + V_p.
template <int N>
__global__ void __launch_bounds__(256)
    seg_chain_kernel(const float* __restrict__ s0, const float* __restrict__ dstate,
                     float* __restrict__ seg_state, float* __restrict__ seg_grad,
                     const float* __restrict__ seg_decay, int H, int P) {
  constexpr int PER = N * N / 256;
  const int64_t bh = (int64_t)blockIdx.y * H + blockIdx.x;
  const bool grad = blockIdx.z == 1;
  const float* init = (grad ? dstate : s0) + bh * N * N;
  float* seg = grad ? seg_grad : seg_state;
  float m[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) m[i] = init[threadIdx.x + 256 * i];
  for (int step = 0; step < P - 1; ++step) {
    const int p = grad ? P - 1 - step : step;  // the segment whose part is added
    float* x = seg + (bh * (P - 1) + (grad ? p - 1 : p)) * N * N;
    const float* dec = seg_decay + (bh * P + p) * N;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int idx = threadIdx.x + 256 * i;
      m[i] = fmaf(dec[idx / N], m[i], x[idx]);
      x[idx] = m[i];
    }
  }
}

// Pass 3: segment p = blockIdx.z of (b, h) = (blockIdx.y, blockIdx.x).  The
// states first: from the segment's incoming state (s0 for p = 0), each
// chunk's state into states[b, h, c].  Then the chunks last to first from
// the gradient leaving the segment (dS for p = P - 1): every gradient of the
// chunk, then Go carried back across it; the segment's du into du_part[b,
// h, p], and from p = 0 the gradient of state0.
template <typename Tin, int N>
__global__ void __launch_bounds__(THREADS, 2)
    grads_kernel(const Tin* __restrict__ r, const Tin* __restrict__ k,
                 const Tin* __restrict__ v, const float* __restrict__ logw,
                 const float* __restrict__ u, const float* __restrict__ s0,
                 const Tin* __restrict__ dout, const float* __restrict__ dstate,
                 const float* __restrict__ seg_state, const float* __restrict__ seg_grad,
                 float* __restrict__ states, Tin* __restrict__ dr, Tin* __restrict__ dk,
                 Tin* __restrict__ dv, float* __restrict__ dlogw, float* __restrict__ du_part,
                 float* __restrict__ ds0, int S, int H, int P, int Lc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<Tin, N>& sm = *reinterpret_cast<Smem<Tin, N>*>(smem_raw);
  constexpr int NP = Smem<Tin, N>::NP, NJ = N / 32;
  constexpr bool EXACT = sizeof(Tin) == 2;
  const int h = blockIdx.x, b = blockIdx.y, p = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int64_t row = (int64_t)H * N, head = ((int64_t)b * S * H + h) * N;
  const int64_t bh = (int64_t)b * H + h;
  const int C = (S + T - 1) / T, c0 = p * Lc, c1 = min(c0 + Lc, C);
  const bool col = tid < 4 * N;
  const int cd = tid % N, cb = tid / N;

  // the states
  load_square<N>(sm.sc, p == 0 ? s0 + bh * N * N : seg_state + (bh * (P - 1) + p - 1) * N * N);
  cp_async_commit();
  for (int i = tid; i < T * (T + 4); i += THREADS) (&sm.a[0][0])[i] = 0.f;
  if (tid < N) sm.u[tid] = u[(int64_t)h * N + tid];
  cp_async_wait<0>();
  __syncthreads();
  for (int c = c0; c < c1; ++c) {
    store_square<N>(states + (bh * C + c) * N * N, sm.sc);
    if (c + 1 < c1) chain_chunk<Tin, N, false>(sm, k, v, logw, head, row, c, S);
  }
  __syncthreads();  // every read of the last state is done

  // the gradients, chunks last to first; warp w's tiles of the T x N
  // outputs: rows m0 .. m0 + 15, columns n0 + 8j .. (j < NJ)
  const int mt = warp & 1, m0 = 16 * mt, n0 = 8 * (warp >> 1) * NJ;
  float (*rdr)[NP] = sm.sc;  // r ⊙ dr′, once S_c is read
  load_square<N>(sm.go, p == P - 1 ? dstate + bh * N * N : seg_grad + (bh * (P - 1) + p) * N * N);
  cp_async_commit();
  float du_acc = 0.f;
  for (int c = c1 - 1; c >= c0; --c) {
    const int t0 = c * T;
    load_rows<Tin, N>(sm.r, r, head, row, t0, S);
    load_rows<Tin, N>(sm.k, k, head, row, t0, S);
    load_rows<Tin, N>(sm.v, v, head, row, t0, S);
    load_rows<Tin, N>(sm.o, dout, head, row, t0, S);
    load_square<N>(sm.sc, states + (bh * C + c) * N * N);
    cp_async_commit();
    float lp[Q], ls[Q];
    if (col) column_local(sm, logw, head, row, t0, S, lp, ls);
    cp_async_wait<0>();
    __syncthreads();

    // P = dO V^T, its upper right quarter left out (never read)
    if (mt == 1 || (warp >> 1) < 2) {
      const int pn = 8 * (warp >> 1);
      float acc[1][4];
      zero(acc);
      mma_steps<EXACT, EXACT>(
          acc, 0, N, [&](int m, int e) { return to_f(sm.o[m0 + m][e]); },
          [&](int e, int) { return to_f(sm.v[pn + g][e]); });
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<float2*>(&sm.p[m0 + g + 8 * hh][pn + 2 * q]) =
            make_float2(acc[0][2 * hh], acc[0][2 * hh + 1]);
    }
    // the column pass: pd, sd, the factors of the blocks below the diagonal,
    // D (see Smem)
    if (col) {
      float before, after;
      column_outer(sm, cd, cb, before, after);
#pragma unroll
      for (int i = 0; i < Q; ++i) {
        const int t = Q * cb + i;
        sm.pd[t][cd] = before * lp[i];
        sm.sd[t][cd] = ls[i] * after;
        if (cb == 0) {
          sm.fk[i][cd] = ls[i] * sm.blk[1][cd];
          sm.fk[H2 + i][cd] = ls[i];
        } else if (cb == 1) {
          sm.fr[H2 + i][cd] = lp[i];
          sm.fk[Q + i][cd] = ls[i];
        } else if (cb == 2) {
          sm.fr[i][cd] = lp[i];
          sm.fk[3 * Q + i][cd] = ls[i];
        } else {
          sm.fr[Q + i][cd] = sm.blk[2][cd] * lp[i];
          sm.fr[3 * Q + i][cd] = lp[i];
        }
      }
      if (cb == 0) column_decay(sm, cd);
    }
    __syncthreads();

    // A: the blocks below the diagonal on warps 0-3 (tensor cores), the
    // diagonal blocks on warps 4-7 (CUDA cores); above it A stays 0
    if (warp < 2) {  // rows 16.. against columns 8·warp ..: factors at b = 16
      float acc[1][4];
      zero(acc);
      mma_steps<false, false>(
          acc, 0, N, [&](int m, int d) { return to_f(sm.r[H2 + m][d]) * sm.fr[m][d]; },
          [&](int d, int) {
            const int s = Q * warp + g;
            return to_f(sm.k[s][d]) * sm.fk[s][d];
          });
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<float2*>(&sm.a[H2 + g + 8 * hh][Q * warp + 2 * q]) =
            make_float2(acc[0][2 * hh], acc[0][2 * hh + 1]);
    } else if (warp < 4) {  // rows 8..15 against 0..7 (warp 2), 24..31 against 16..23
      const int sel = warp - 2;
      float acc[1][4];
      zero(acc);
      mma_steps<false, false>(
          acc, 0, N,
          [&](int m, int d) { return to_f(sm.r[Q + m + (m >= Q ? Q : 0)][d]) * sm.fr[H2 + m][d]; },
          [&](int d, int) {
            return to_f(sm.k[H2 * sel + g][d]) * sm.fk[H2 + Q * sel + g][d];
          });
      *reinterpret_cast<float2*>(&sm.a[Q + H2 * sel + g][H2 * sel + 2 * q]) =
          make_float2(acc[0][2 * sel], acc[0][2 * sel + 1]);
    } else {  // block warp - 4: lane (tl, dq) walks τ with k_t ⊙ Π_{t<j<τ} e_j over
              // the dq-th quarter of the columns, the quarters then summed
      constexpr int DQ = N / 4;
      const int t = Q * (warp - 4) + (lane & 7), d0 = (lane >> 3) * DQ;
      float kr[DQ], kD[DQ], bonus = 0.f;
#pragma unroll
      for (int i = 0; i < DQ; ++i) {
        kr[i] = to_f(sm.k[t][d0 + i]);
        kD[i] = 0.f;
        bonus = fmaf(to_f(sm.r[t][d0 + i]), sm.u[d0 + i] * kr[i], bonus);
      }
      float res[Q];
#pragma unroll
      for (int i = 0; i < Q; ++i) {
        const int tau = (t & ~(Q - 1)) + i;
        const float on = tau == t ? 1.f : 0.f;
        float dot[2] = {0.f, 0.f};
#pragma unroll
        for (int i2 = 0; i2 < DQ; ++i2) {
          dot[i2 & 1] = fmaf(to_f(sm.r[tau][d0 + i2]), kD[i2], dot[i2 & 1]);
          kD[i2] = fmaf(on, kr[i2], kD[i2] * sm.ew[tau][d0 + i2]);
        }
        res[i] = tau == t ? bonus : dot[0] + dot[1];
      }
#pragma unroll
      for (int i = 0; i < Q; ++i) {
        res[i] += __shfl_xor_sync(0xffffffffu, res[i], 8);
        res[i] += __shfl_xor_sync(0xffffffffu, res[i], 16);
        if (lane < Q && i >= lane) sm.a[(t & ~(Q - 1)) + i][t] = res[i];
      }
    }
    __syncthreads();

    // dv = (k ⊙ sd) Go + A^T dO
    {
      float acc[NJ][4];
      zero(acc);
      mma_steps<false, false>(
          acc, 0, N, [&](int m, int d) { return to_f(sm.k[m0 + m][d]) * sm.sd[m0 + m][d]; },
          [&](int d, int j) { return sm.go[d][n0 + 8 * j + g]; });
      mma_steps<false, EXACT>(
          acc, m0, T, [&](int m, int tau) { return sm.a[tau][m0 + m]; },
          [&](int tau, int j) { return to_f(sm.o[tau][n0 + 8 * j + g]); });
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int t = m0 + g + 8 * hh;
        if (t0 + t < S) {
#pragma unroll
          for (int j = 0; j < NJ; ++j)
            store2(dv, head + (int64_t)(t0 + t) * row + n0 + 8 * j + 2 * q, acc[j][2 * hh],
                   acc[j][2 * hh + 1]);
        }
      }
    }

    // D ⊙ rowsum(Go ⊙ S_c), on the warps of row tile 0: lane (g, q) sums the
    // columns e ≡ q (mod 4) of row d, then the four lanes of the row
    if (mt == 0) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = n0 + 8 * j + g;
        float s = 0.f;
#pragma unroll
        for (int e = q; e < N; e += 4) s = fmaf(sm.go[d][e], sm.sc[d][e], s);
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        if (q == 0) sm.tot[d] = sm.dec[d] * s;
      }
    }

    // dr = pd ⊙ (dO S_c^T) + the intra-chunk term + P[t,t] u ⊙ k
    float keep[NJ][4];  // r ⊙ dr′
    {
      float x1[NJ][4], big[NJ][4], sml[NJ][4];
      zero(x1);
      zero(big);
      zero(sml);
      mma_steps<EXACT, false>(
          x1, 0, N, [&](int m, int e) { return to_f(sm.o[m0 + m][e]); },
          [&](int e, int j) { return sm.sc[n0 + 8 * j + g][e]; });
      if (mt == 1)  // rows 16.. against columns ..15
        mma_steps<false, false>(
            big, 0, H2, [&](int m, int s) { return sm.p[H2 + m][s]; },
            [&](int s, int j) {
              const int d = n0 + 8 * j + g;
              return to_f(sm.k[s][d]) * sm.fk[s][d];
            });
      // rows 8..15 against 0..7 (row tile 0), 24..31 against 16..23 (1)
      mma_steps<false, false>(
          sml, 0, Q, [&](int m, int s) { return m >= Q ? sm.p[m0 + m][m0 + s] : 0.f; },
          [&](int s, int j) {
            const int d = n0 + 8 * j + g;
            return to_f(sm.k[m0 + s][d]) * sm.fk[H2 + Q * mt + s][d];
          });
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int t = m0 + g + 8 * hh, base = t & ~(Q - 1);
        const float ptt = sm.p[t][t];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          float out[2];
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            const int d = n0 + 8 * j + 2 * q + cc, x = 2 * hh + cc;
            float intra = 0.f, f = 1.f;  // the diagonal block, s from t - 1 down
#pragma unroll
            for (int i = 1; i < Q; ++i) {
              const int s = t - i;
              if (s >= base) {
                intra = fmaf(sm.p[t][s] * to_f(sm.k[s][d]), f, intra);
                f *= sm.ew[s][d];
              }
            }
            if (mt == 1) intra += sm.fr[t - H2][d] * big[j][x];
            if (hh == 1) intra += sm.fr[H2 + Q * mt + g][d] * sml[j][x];
            const float drp = sm.pd[t][d] * x1[j][x] + intra;
            keep[j][x] = to_f(sm.r[t][d]) * drp;
            out[cc] = drp + ptt * sm.u[d] * to_f(sm.k[t][d]);
          }
          if (t0 + t < S) store2(dr, head + (int64_t)(t0 + t) * row + n0 + 8 * j + 2 * q,
                                 out[0], out[1]);
        }
      }
    }
    __syncthreads();  // every read of S_c is done
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        *reinterpret_cast<float2*>(&rdr[m0 + g + 8 * hh][n0 + 8 * j + 2 * q]) =
            make_float2(keep[j][2 * hh], keep[j][2 * hh + 1]);

    // dk = sd ⊙ (V Go^T) + the intra-chunk term + P[s,s] u ⊙ r
    float ks[NJ][4], ki[NJ][4];  // k ⊙ its state and intra-chunk terms
    {
      float x2[NJ][4], big[NJ][4], sml[NJ][4];
      zero(x2);
      zero(big);
      zero(sml);
      mma_steps<EXACT, false>(
          x2, 0, N, [&](int m, int e) { return to_f(sm.v[m0 + m][e]); },
          [&](int e, int j) { return sm.go[n0 + 8 * j + g][e]; });
      if (mt == 0)  // rows ..15 against τ in 16..
        mma_steps<false, false>(
            big, 0, H2, [&](int m, int tau) { return sm.p[H2 + tau][m]; },
            [&](int tau, int j) {
              const int d = n0 + 8 * j + g;
              return to_f(sm.r[H2 + tau][d]) * sm.fr[tau][d];
            });
      // rows 0..7 against τ in 8..15 (row tile 0), 16..23 against 24..31 (1)
      mma_steps<false, false>(
          sml, 0, Q, [&](int m, int tau) { return m < Q ? sm.p[m0 + Q + tau][m0 + m] : 0.f; },
          [&](int tau, int j) {
            const int d = n0 + 8 * j + g;
            return to_f(sm.r[m0 + Q + tau][d]) * sm.fr[H2 + Q * mt + tau][d];
          });
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int s = m0 + g + 8 * hh, end = s | (Q - 1);
        const float pss = sm.p[s][s];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          float out[2];
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            const int d = n0 + 8 * j + 2 * q + cc, x = 2 * hh + cc;
            float intra = 0.f, f = 1.f;  // the diagonal block, τ from s + 1 up
#pragma unroll
            for (int i = 1; i < Q; ++i) {
              const int tau = s + i;
              if (tau <= end) {
                intra = fmaf(sm.p[tau][s] * to_f(sm.r[tau][d]), f, intra);
                f *= sm.ew[tau][d];
              }
            }
            if (mt == 0) intra += sm.fk[s][d] * big[j][x];
            if (hh == 0) intra += sm.fk[H2 + Q * mt + g][d] * sml[j][x];
            const float dks = sm.sd[s][d] * x2[j][x], kv = to_f(sm.k[s][d]);
            ks[j][x] = kv * dks;
            ki[j][x] = kv * intra;
            out[cc] = (dks + intra) + pss * sm.u[d] * to_f(sm.r[s][d]);
          }
          if (t0 + s < S) store2(dk, head + (int64_t)(t0 + s) * row + n0 + 8 * j + 2 * q,
                                 out[0], out[1]);
        }
      }
    }
    __syncthreads();  // every read of ew, fr, fk and Go is done
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int t = m0 + g + 8 * hh, d = n0 + 8 * j + 2 * q;
        *reinterpret_cast<float2*>(&sm.fk[t][d]) = make_float2(ks[j][2 * hh], ks[j][2 * hh + 1]);
        *reinterpret_cast<float2*>(&sm.ew[t][d]) = make_float2(ki[j][2 * hh], ki[j][2 * hh + 1]);
      }
    // Go_{c-1} = D ⊙ Go_c + (r ⊙ pd)^T dO, each warp on its own entries
    if (c > c0 || p == 0) chain_update<Tin, N, true>(sm, sm.go);
    __syncthreads();

    // dlogw by the reverse-cumsum identity, on thread (d, block of 8 steps):
    // the blocks' sums first, then each step's; and du's part
    float kl[Q], rl[Q], il[Q];
    if (col) {
      float ksum = 0.f, rsum = 0.f, isum = 0.f, dul = 0.f;
#pragma unroll
      for (int i = 0; i < Q; ++i) {
        const int t = Q * cb + i;
        kl[i] = sm.fk[t][cd];
        rl[i] = rdr[t][cd];
        il[i] = sm.ew[t][cd];
        ksum += kl[i];
        rsum += rl[i];
        isum += il[i];
        dul = fmaf(sm.p[t][t], to_f(sm.r[t][cd]) * to_f(sm.k[t][cd]), dul);
      }
      sm.blk2[0][cb][cd] = ksum;
      sm.blk2[1][cb][cd] = rsum;
      sm.blk2[2][cb][cd] = isum;
      sm.blk[cb][cd] = dul;
    }
    __syncthreads();
    if (col) {
      float before = 0.f, after_r = 0.f, from_i = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (i < cb) before += sm.blk2[0][i][cd];
        if (i > cb) {
          after_r += sm.blk2[1][i][cd];
          from_i += sm.blk2[2][i][cd];
        }
      }
      const float tot = sm.tot[cd];
      float pre[Q];
#pragma unroll
      for (int i = 0; i < Q; ++i) {
        pre[i] = before;
        before += kl[i];
      }
#pragma unroll
      for (int i = Q - 1; i >= 0; --i) {
        const int t = Q * cb + i;
        from_i += il[i];
        if (t0 + t < S)
          dlogw[head + (int64_t)(t0 + t) * row + cd] = ((tot + pre[i]) + after_r) - from_i;
        after_r += rl[i];
      }
      if (cb == 0) du_acc += ((sm.blk[0][cd] + sm.blk[1][cd]) + sm.blk[2][cd]) + sm.blk[3][cd];
    }
    __syncthreads();
  }
  cp_async_wait<0>();  // Go's load where the segment has no chunk (S = 0)
  __syncthreads();
  if (p == 0) store_square<N>(ds0 + bh * N * N, sm.go);
  if (tid < N) du_part[(bh * P + p) * N + tid] = du_acc;
}

// du[h, d] = Σ_b Σ_p du_part[b, h, p, d], in that order.
template <int N>
__global__ void du_kernel(const float* __restrict__ du_part, float* __restrict__ du, int B,
                          int H, int P) {
  const int h = blockIdx.x, d = threadIdx.x;
  float acc = 0.f;
  for (int b = 0; b < B; ++b)
    for (int p = 0; p < P; ++p) acc += du_part[(((int64_t)b * H + h) * P + p) * N + d];
  du[(int64_t)h * N + d] = acc;
}

template <typename Tin, int N>
cudaError_t launch(const void* r, const void* k, const void* v, const float* logw,
                   const float* u, const float* s0, const void* dout, const float* dstate,
                   void* dr, void* dk, void* dv, float* dlogw, float* du, float* ds0,
                   float* states, float* seg_state, float* seg_grad, float* seg_decay,
                   float* du_part, int B, int S, int H, int P, int Lc, cudaStream_t stream) {
  constexpr int SMEM = sizeof(Smem<Tin, N>);
  static const cudaError_t attr = [] {
    const cudaError_t e1 = cudaFuncSetAttribute(
        seg_kernel<Tin, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    const cudaError_t e2 = cudaFuncSetAttribute(
        grads_kernel<Tin, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    return e1 != cudaSuccess ? e1 : e2;
  }();
  if (attr != cudaSuccess) return attr;
  const Tin *rr = static_cast<const Tin*>(r), *kk = static_cast<const Tin*>(k),
            *vv = static_cast<const Tin*>(v), *oo = static_cast<const Tin*>(dout);
  cudaError_t err;
  if (P > 1) {
    seg_kernel<Tin, N><<<dim3(H, B, 2 * (P - 1)), THREADS, SMEM, stream>>>(
        rr, kk, vv, logw, oo, seg_state, seg_grad, seg_decay, S, H, P, Lc);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    seg_chain_kernel<N><<<dim3(H, B, 2), 256, 0, stream>>>(s0, dstate, seg_state, seg_grad,
                                                           seg_decay, H, P);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  grads_kernel<Tin, N><<<dim3(H, B, P), THREADS, SMEM, stream>>>(
      rr, kk, vv, logw, u, s0, oo, dstate, seg_state, seg_grad, states, static_cast<Tin*>(dr),
      static_cast<Tin*>(dk), static_cast<Tin*>(dv), dlogw, du_part, ds0, S, H, P, Lc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  du_kernel<N><<<H, N, 0, stream>>>(du_part, du, B, H, P);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// r, k, v, dout, dr, dk, dv: (B, S, H, N) contiguous, dtype 0 = fp32, 1 =
// bf16; logw, dlogw: (B, S, H, N), u, du: (H, N), s0, dstate, ds0: (B, H,
// N, N), all contiguous fp32; N = 32 or 64; P segments of Lc chunks of 32
// steps, as wkv6_fwd takes them; scratch: states (B, H, ceil(S / 32), N, N),
// seg_state and seg_grad (B, H, P - 1, N, N), seg_decay and du_part (B, H,
// P, N), fp32.  All 16-byte aligned.
extern "C" int wkv6_bwd(const void* r, const void* k, const void* v, const float* logw,
                        const float* u, const float* s0, const void* dout, const float* dstate,
                        void* dr, void* dk, void* dv, float* dlogw, float* du, float* ds0,
                        float* states, float* seg_state, float* seg_grad, float* seg_decay,
                        float* du_part, int B, int S, int H, int N, int dtype, int P, int Lc,
                        void* stream) {
  using namespace repro_torch;
  const int nchunks = (S + T - 1) / T;
  if (B < 0 || S < 0 || H < 0 || B > 65535 || P < 1 || 2 * (P - 1) > 65535 || Lc < 0 ||
      (dtype != 0 && dtype != 1) || (N != 32 && N != 64) ||
      (S > 0 ? (int64_t)(P - 1) * Lc >= nchunks || (int64_t)P * Lc < nchunks : P != 1))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0) return (int)cudaSuccess;
  using Launch = cudaError_t (*)(const void*, const void*, const void*, const float*,
                                 const float*, const float*, const void*, const float*, void*,
                                 void*, void*, float*, float*, float*, float*, float*, float*,
                                 float*, float*, int, int, int, int, int, cudaStream_t);
  const Launch fn = dtype == 0
                        ? (N == 64 ? &launch<float, 64> : &launch<float, 32>)
                        : (N == 64 ? &launch<__nv_bfloat16, 64> : &launch<__nv_bfloat16, 32>);
  return (int)fn(r, k, v, logw, u, s0, dout, dstate, dr, dk, dv, dlogw, du, ds0, states,
                 seg_state, seg_grad, seg_decay, du_part, B, S, H, P, Lc,
                 static_cast<cudaStream_t>(stream));
}
