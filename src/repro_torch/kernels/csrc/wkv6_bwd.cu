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
// bf16 at N = 64 once B·H fills the card's SMs (wkv6.backward_plan) takes
// wkv6_bwd_wgmma_kernel instead (below: one segment a (b, h), 64-step
// chunks on wgmma); every other call the tf32 kernels described here.
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
// bf16 parts of an fp32 operand in the wgmma kernel's products but the
// chains' (1 or 2; three do not fit an SM's shared memory beside the
// chains' three; see wkv6_bwd_wgmma_kernel)
#ifndef WKV_BWD_PARTS
#define WKV_BWD_PARTS 2
#endif
static_assert(WKV_BWD_PARTS >= 1 && WKV_BWD_PARTS <= 2, "1 or 2 bf16 parts");

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

// ---- bf16 at N = 64 on wgmma fed by TMA (wkv6_bwd_wgmma_kernel) ----
//
// At rwkv6-7b's training row (B 4 × 2048, 64 heads of 64) the tf32 kernel
// above took 1.87 ms against a 0.46 ms bound: every contraction on
// mma.sync in up to three tf32 passes, 32-step chunks behind block-wide
// barriers, a segment pass, a chain and a second sweep of the inputs.
// This kernel takes one block of 16 warps a (b, h) (B·H ≥ 96: no
// segments) and 64-step chunks, its roles on warps of their own:
// - A producer thread keeps r, k and logw (one stage, the prep warps') and
//   v and do (two stages, the MMA warpgroup's) in flight by TMA, in the
//   order of each walk; steps past S read as zeros.
// - The forward walk: the prep warps take e^w, the chunk's decay D (a
//   double Σ w rounded once) and k ⊙ sd; the MMA warpgroup carries S in
//   registers, S_{c+1} = D ⊙ S_c + (k ⊙ sd)ᵀ V, storing each chunk's
//   entering state (scratch B·H·ceil(S/64)·64² fp32).
// - The reverse walk, Go carried in three bf16 parts (which hold it
//   exactly).  The 8 prep warps, a thread a column and a quarter of the
//   chunk: e^w, the decays, the levels' operands F_L (L = 32, 16, 8: at
//   rows with bit L set r ⊙ Π e from the start of the row's L-block,
//   elsewhere k ⊙ Π e to the end of its L-block, so that a pair's decay is
//   cut at the block boundary between its steps into two factors ≤ 1; no
//   e^{-Σw}, no division), A's and dr′'s and dk′'s diagonal 8 x 8 blocks by
//   short walks, r ⊙ pd, k ⊙ sd, and every output but dv: dr, dk, dlogw
//   (the chunk's identity per half of 32 steps: over 64 its terms'
//   rounding would exceed what a 32-step chunk leaves) and du's part.  The
//   MMA warpgroup: P = dO Vᵀ and Pᵀ (exact), X1ᵀ = S_c dOᵀ, X2 = V Goᵀ, the
//   levels' P_L F_L and P_Lᵀ F_L (P at the level's pairs), Aᵀ from F_L
//   F_Lᵀ, dv = (k ⊙ sd) Go + Aᵀ dO and Go = D ⊙ Go + (r ⊙ pd)ᵀ dO, all
//   wgmma m64n64k16 in bf16: an fp32 operand in WKV_BWD_PARTS parts
//   (CPARTS in the two chains), a bf16 one exact as stored; its sums reach
//   the prep warps through two exchange tiles.
// - Full and empty mbarriers between the roles, named barriers within
//   them; setmaxnreg 200 an MMA thread, 144 a prep thread, 24 the
//   producer's; no spill: the shared-memory block and the thread indices
//   are made opaque at each chunk's start and the descriptors at each
//   product, so that nothing is held from one chunk to the next.
// - du: each block's part, summed by du_kernel in a fixed order: no
//   atomics anywhere, the same bits on every call.
// What bounds it (the WKV_BWD_PROF stamps of one block at rwkv6-7b's row,
// parity_probe.py --kernel recurrent_bwd; PERF.md): a reverse chunk takes
// ~38k cycles, the two roles handing each other the chunk four times: the
// prep warps' operands (~4k) before the MMA warpgroup's products, the
// levels' sums (~9k on the MMA side, the prep warps consuming them), r ⊙
// pd and k ⊙ sd before dv and the chain, and the prep warps' outputs (~8k)
// before the next chunk's operands.  CUDA-core work on few warps,
// latency-bound, binds, not the tensor cores or the bytes.

constexpr int TW = 64;                 // steps a chunk, the wgmma forward's
constexpr int NW = 64;                 // the head size
constexpr int NPARTS = WKV_BWD_PARTS;  // bf16 parts of an fp32 operand
constexpr int WG_THREADS = 512;        // MMA warpgroup, two prep warpgroups, producer warpgroup
constexpr int PREP = 128, PREP_THREADS = 256, PRODUCER = 384;
constexpr int V_STAGES = 2;            // chunks of v and do in their ring
// named barriers: the prep warps', the MMA warpgroup's
constexpr int BAR_PREP = 1, BAR_MMA = 2;
// registers a thread after setmaxnreg (512 threads start with 128)
constexpr int PREP_REGS = 144, PRODUCER_REGS = 24;
constexpr int MMA_REGS = (65536 - 256 * PREP_REGS) / 128 - PRODUCER_REGS;
static_assert(128 * (MMA_REGS + PRODUCER_REGS) + 256 * PREP_REGS == 65536, "the SM's registers");
constexpr int TILE = TW * 128;         // bytes of a 64 x 64 bf16 tile
// the products that feed the carried state and gradient (S's increment, the
// gradient's chain) take three parts whatever NPARTS: their error is carried
// from chunk to chunk, and Go's three parts hold its fp32 value exactly
constexpr int CPARTS = 3;
// Row pitches (floats): the exchange, which the MMA warpgroup writes a row
// at a time as float2 (≡ 8 mod 32 keeps a half warp on distinct banks), and
// the forward walk's k ⊙ sd, which it reads transposed (≡ 4)
constexpr int LDX = NW + 8, LDT = NW + 4;
// the F region: the levels' operands in parts, then k ⊙ sd in parts; in the
// forward walk the fp32 k ⊙ sd
constexpr int F_BYTES = 3 * NPARTS * TILE > TW * LDT * 4 ? 3 * NPARTS * TILE : TW * LDT * 4;

struct alignas(1024) BwdSmem {
  uint8_t r[TILE], k[TILE];         // bf16 [t][d], 128-byte swizzle (TMA): the prep warps'
  float w[TW][NW];                   // logw, then e^{logw} in place
  // (the forward walk's two stages: k and logw in k and w, and in r and ex)
  uint8_t v[V_STAGES][TILE];         // bf16 [s][e] (TMA); the MMA warpgroup's
  uint8_t o[V_STAGES][TILE];         // do, bf16 [t][e] (TMA)
  alignas(1024) uint8_t f[F_BYTES];  // F_L of the levels 32, 16 and 8 in parts, [x][d] swizzled
  uint8_t gop[CPARTS][TILE];         // Go in parts, [d][e] swizzled (the last NPARTS: Go in NPARTS)
  uint8_t rp[CPARTS][TILE];          // r ⊙ pd in parts, [t][d] swizzled
  float ex[2][TW][LDX];              // the exchange from the MMA warpgroup to the prep warps
  float pdiag[TW][8];                // P's diagonal 8 x 8 blocks, [t][s % 8]
  float adiag[TW][8];                // A's, [t][s % 8] (0 for s > t)
  double wsum[2][4][NW];             // Σ logw over each quarter of the chunk (by parity)
  float qp[2][4][NW];                // Π e^{w} over each quarter (by parity)
  float qsum[4][4][NW];              // dlogw's sums over each quarter
  float dt[NW], tot[NW], u[NW], du[4][NW];
  uint64_t out[4];   // dr, dk, dv, dlogw at this (b, h)
  uint64_t ra_full, ra_empty, fa_full[2], fa_empty[2], v_full[V_STAGES], v_empty[V_STAGES];
  uint64_t slot_full, slot_empty, pdiag_full, ex_full[2], ex_empty[2], f_dead, kr_full, kk_full;
};
constexpr int BWD_SMEM = sizeof(BwdSmem) + 1024;  // and the 1024-byte alignment
static_assert(BWD_SMEM <= 232448, "one block an SM");

// The pairs (a's part, b's part) of a product of two operands split into
// NPARTS, smallest first: those whose indices sum to NPARTS - 1 or more (at
// two parts the dropped small·small product is below 2^-16 of |a|·|b|)
constexpr int NPAIRS = NPARTS == 2 ? 3 : 1;
__host__ __device__ constexpr int pair_a(int q) { return NPARTS == 2 && q > 0 ? 1 : 0; }
__host__ __device__ constexpr int pair_b(int q) { return NPARTS == 2 && q != 1 ? 1 : 0; }

// Element (row, col) of NPARTS swizzled tiles TILE apart: x in its bf16 parts.
template <int NP = NPARTS>
__device__ __forceinline__ void put_parts(uint8_t* tiles, int row, int col, float x) {
  const int off = swz128(row, col);
#pragma unroll
  for (int p = NP - 1; p >= 0; --p) {
    const __nv_bfloat16 h = __float2bfloat16_rn(x);
    *reinterpret_cast<__nv_bfloat16*>(tiles + p * TILE + off) = h;
    x -= __bfloat162float(h);
  }
}

// The highest bit in which a != b differ: of two steps of a chunk, 3, 4 or 5
// where they lie in different 8-step blocks; of two blocks, that less 3.
__device__ __forceinline__ int level(int a, int b) { return 31 - __clz(a ^ b); }

// The wgmma A fragments (bf16 parts, smallest first) of a 64 x 64 fp32 tile
// read through x(row, col), a float2 of columns col and col + 1: for k16
// step j, rows 16w + g (+ 8) and columns 16j + 2t4 (+ 8).
template <int NP, typename Read>
__device__ __forceinline__ void a_parts(uint32_t (&frag)[4][NP][4], int w, int g, int t4,
                                        Read&& x) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float2 v = x(16 * w + g + 8 * (r & 1), 16 * j + 2 * t4 + 8 * (r >> 1));
      uint32_t part[NP];
      split_bf16<NP>(v.x, v.y, part);
#pragma unroll
      for (int p = 0; p < NP; ++p) frag[j][p][r] = part[p];
    }
}
// The same of an m64n64 accumulator (acc[4jj + 2h + c]: row 16w + g + 8h,
// column 8jj + 2t4 + c) over its columns, the entries where keep(the row's
// 8-step block, the column's) fails as 0.
template <typename Keep>
__device__ __forceinline__ void acc_parts(uint32_t (&frag)[4][NPARTS][4], const float (&acc)[32],
                                          int w, int g, int t4, Keep&& keep) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int h = r & 1, jj = 2 * j + (r >> 1);
      const bool on = keep(2 * w + h, jj);
      uint32_t part[NPARTS];
      split_bf16<NPARTS>(on ? acc[4 * jj + 2 * h] : 0.f, on ? acc[4 * jj + 2 * h + 1] : 0.f,
                         part);
#pragma unroll
      for (int p = 0; p < NPARTS; ++p) frag[j][p][r] = part[p];
    }
}

// A descriptor made opaque where a product takes it, so that the compiler
// computes each as it is issued instead of holding a chunk's worth of them.
__device__ __forceinline__ uint64_t opq(uint64_t x) {
  asm volatile("" : "+l"(x));
  return x;
}

// acc (+)= A·B over the k16 steps in the mask KS, A in parts from registers,
// B in parts in shared memory, MN-major (k row kk of part p at b + p·TILE
// + kk·128): the pairs of parts, smallest first.  ACC: add to acc.
template <int KS, bool ACC = false>
__device__ __forceinline__ void rs_parts(float (&acc)[32], const uint32_t (&a)[4][NPARTS][4],
                                         const uint8_t* b) {
  bool first = !ACC;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (!((KS >> kk) & 1)) continue;
#pragma unroll
    for (int q = 0; q < NPAIRS; ++q) {
      wgmma_rs<64>(acc, a[kk][pair_a(q)], opq(mn_desc(b + pair_b(q) * TILE + kk * 2048)),
                   first ? 0 : 1);
      first = false;
    }
  }
}
// d (+)= a·b, 64 x 64 x 16, A from registers and B K-major (rows n of 128
// bytes of k, swizzled): wgmma_rs with B not transposed.
__device__ __forceinline__ void wgmma_rs_k(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                           int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}
// acc = A·Bᵀ, A in parts from registers, B an exact bf16 tile, K-major.
__device__ __forceinline__ void rs_exact_k(float (&acc)[32], const uint32_t (&a)[4][NPARTS][4],
                                           const uint8_t* b) {
  const uint64_t db = kmajor_desc(b);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int p = 0; p < NPARTS; ++p) wgmma_rs_k(acc, a[kk][p], opq(db + 2 * kk), kk || p ? 1 : 0);
}
// acc (+)= A·B, A in parts from registers, B an exact bf16 tile, MN-major.
template <bool ACC, int NP = NPARTS>
__device__ __forceinline__ void rs_exact(float (&acc)[32], const uint32_t (&a)[4][NP][4],
                                         const uint8_t* b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int p = 0; p < NP; ++p)
      wgmma_rs<64>(acc, a[kk][p], opq(mn_desc(b + kk * 2048)), ACC || kk || p ? 1 : 0);
}
// acc = A·Bᵀ of two K-major tiles in shared memory: exact bf16 A and B in
// parts (PARTS_B), or both exact.
template <bool PARTS_B>
__device__ __forceinline__ void ss_product(float (&acc)[32], const uint8_t* a, const uint8_t* b) {
  const uint64_t da = kmajor_desc(a);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int p = 0; p < (PARTS_B ? NPARTS : 1); ++p)
      wgmma_ss<64>(acc, opq(da + 2 * kk), opq(kmajor_desc(b + p * TILE) + 2 * kk),
                   kk || p ? 1 : 0);
}
// d (+)= a·b, 64 x 64 x 16, A and B from shared memory, TA / TB: A / B
// MN-major (transposed) rather than K-major.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_t(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc), "n"(TA), "n"(TB));
}
// (k ⊙ sd) Go: A in parts K-major ([s][d]), B in parts MN-major ([d][e]): the pairs.
__device__ __forceinline__ void ss_kgo(float (&acc)[32], const uint8_t* a, const uint8_t* b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int q = 0; q < NPAIRS; ++q)
      wgmma_ss_t<0, 1>(acc, opq(kmajor_desc(a + pair_a(q) * TILE) + 2 * kk),
                       opq(mn_desc(b + pair_b(q) * TILE + kk * 2048)), kk || q ? 1 : 0);
}
// (r ⊙ pd)ᵀ dO: A in parts MN-major ([τ][d] read as [d][τ]), B exact MN-major.
__device__ __forceinline__ void ss_chain(float (&acc)[32], const uint8_t* a, const uint8_t* b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int p = 0; p < CPARTS; ++p)
      wgmma_ss_t<1, 1>(acc, opq(mn_desc(a + p * TILE + kk * 2048)), opq(mn_desc(b + kk * 2048)),
                       kk || p ? 1 : 0);
}
// acc = F·Fᵀ of a level's operand in parts, both K-major: the pairs.
__device__ __forceinline__ void ss_level(float (&acc)[32], const uint8_t* f) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int q = 0; q < NPAIRS; ++q)
      wgmma_ss<64>(acc, opq(kmajor_desc(f + pair_a(q) * TILE) + 2 * kk),
                   opq(kmajor_desc(f + pair_b(q) * TILE) + 2 * kk), kk || q ? 1 : 0);
}

// An m64n64 accumulator's rows where rows(row) holds into an fp32 tile of
// pitch LDX.
template <typename Rows>
__device__ __forceinline__ void put_rows(float (*dst)[LDX], const float (&acc)[32], int w, int g,
                                         int t4, Rows&& rows) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = 16 * w + g + 8 * h;
    if (!rows(row)) continue;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
      *reinterpret_cast<float2*>(&dst[row][8 * jj + 2 * t4]) =
          make_float2(acc[4 * jj + 2 * h], acc[4 * jj + 2 * h + 1]);
  }
}

// The state or the gradient (the accumulator layout, rows d, columns e) into
// its bf16 parts, [d][e] swizzled: a K-major B over e, an MN-major B over d.
__device__ __forceinline__ void square_parts(uint8_t* dst, const float (&s)[32], int w, int g,
                                             int t4) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int d = 16 * w + g + 8 * h;
      uint32_t part[CPARTS];
      split_bf16<CPARTS>(s[4 * j + 2 * h], s[4 * j + 2 * h + 1], part);
      const int off = d * 128 + ((j ^ (d & 7)) << 4) + 4 * t4;
#pragma unroll
      for (int p = 0; p < CPARTS; ++p) *reinterpret_cast<uint32_t*>(dst + p * TILE + off) = part[p];
    }
}

// An N x N fp32 square (B, H, .., 64, 64) in the accumulator layout.
__device__ __forceinline__ void load_square_acc(float (&s)[32], const float* src, int w, int g,
                                                int t4) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 x =
          *reinterpret_cast<const float2*>(src + (16 * w + g + 8 * h) * NW + 8 * j + 2 * t4);
      s[4 * j + 2 * h] = x.x;
      s[4 * j + 2 * h + 1] = x.y;
    }
}
__device__ __forceinline__ void store_square_acc(float* dst, const float (&s)[32], int w, int g,
                                                 int t4) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(dst + (16 * w + g + 8 * h) * NW + 8 * j + 2 * t4) =
          make_float2(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]);
}

// A's diagonal blocks, block b of lane (s, column group dg) for s = 8b + i
// and 8b + 4 + i (i = lane % 4), walked side by side: kD = k_s ⊙ Π_{s<j<t}
// e^{w_j} over its 8 columns (0 until t = s), the partial sums Σ_d r_td kD_d
// and, at t = s, the bonus Σ_d r u k; those of the 8 column groups added
// across lanes (xor 4, 8, 16) and stored by group 0 into adiag[t][s % 8].
__device__ __forceinline__ void diag_walk(BwdSmem& sm, int blk, int i, int dg) {
  const int t0 = 8 * blk, d0 = 8 * dg;
  float kr[2][8], kD[2][8], bonus[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float rs[8];
    bf16x8_at(sm.k, t0 + 4 * h + i, dg, kr[h]);
    bf16x8_at(sm.r, t0 + 4 * h + i, dg, rs);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      bonus[h] = fmaf(rs[j], sm.u[d0 + j] * kr[h][j], bonus[h]);
      kD[h][j] = 0.f;
    }
  }
#pragma unroll
  for (int jt = 0; jt < 8; ++jt) {
    const int t = t0 + jt;
    float r[8];
    bf16x8_at(sm.r, t, dg, r);
    const float4 ea = *reinterpret_cast<const float4*>(&sm.w[t][d0]);
    const float4 eb = *reinterpret_cast<const float4*>(&sm.w[t][d0 + 4]);
    const float e[8] = {ea.x, ea.y, ea.z, ea.w, eb.x, eb.y, eb.z, eb.w};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int s = t0 + 4 * h + i;
      float dot[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        dot[j & 1] = fmaf(r[j], kD[h][j], dot[j & 1]);
        kD[h][j] = fmaf(t == s ? 1.f : 0.f, kr[h][j], kD[h][j] * e[j]);
      }
      float res = t == s ? bonus[h] : dot[0] + dot[1];
      res += __shfl_xor_sync(0xffffffffu, res, 4);
      res += __shfl_xor_sync(0xffffffffu, res, 8);
      res += __shfl_xor_sync(0xffffffffu, res, 16);
      if (dg == 0) sm.adiag[t][4 * h + i] = res;
    }
  }
}

// WKV_BWD_PROF (parity_probe.py's build): clock64 stamps of block (0, 0)
// over the first PROF_CHUNKS chunks of each walk, read back by
// wkv6_bwd_prof.  The reverse walk's rows: the prep warps' 0 inputs landed,
// 1 e^w done, 2 slot free, 3 the levels' operands written (slot full), 4
// A's diagonal blocks walked, 5 the exchange read, 6 P's diagonal blocks
// in, 7 dr′'s and dk′'s diagonal walks done, 8 r ⊙ pd written, 9 the F
// region free, 10 k ⊙ sd written, 11 the outputs written; the MMA
// warpgroup's 12 v and do in, 13 the slot full, 14 the levels' dr and dk
// products done, 15 A's products retired, 16 r ⊙ pd in, 17 the chain and
// dv retired, 18 the gradient carried.  The forward walk's, at row
// PROF_CHUNKS + chunk: the prep warps' 0 inputs landed, 1 slot free, 2 k ⊙
// sd written; the MMA warpgroup's 3 slot full, 4 the product retired.
#ifdef WKV_BWD_PROF
constexpr int PROF_CHUNKS = 16, PROF_STAMPS = 19;
__device__ long long bwd_prof[2 * PROF_CHUNKS][PROF_STAMPS];
#define PROF(i, k)                                                                     \
  do {                                                                                 \
    if ((i) < PROF_CHUNKS && blockIdx.x == 0 && blockIdx.y == 0) bwd_prof[i][k] = clock64(); \
  } while (0)
#define PROF_FWD(i, k)                                                                 \
  do {                                                                                 \
    if ((i) < PROF_CHUNKS && blockIdx.x == 0 && blockIdx.y == 0)                       \
      bwd_prof[PROF_CHUNKS + (i)][k] = clock64();                                      \
  } while (0)
#else
#define PROF(i, k) ((void)0)
#define PROF_FWD(i, k) ((void)0)
#endif

// One level of the intra-chunk sums on the MMA warpgroup (LB = 5, 4, 3 for
// the pairs whose steps first differ in bit LB): dr's part P_L · F_L and
// dk's part P_Lᵀ · F_L (P_L: P at the level's pairs, from the registers;
// F_L in parts, MN-major), into exchange buffer n: dr's rows (bit LB of t
// set) and dk's (bit LB of s clear).
template <int LB>
__device__ __forceinline__ void level_round(BwdSmem& sm, const float (&pacc)[32],
                                            const float (&ptacc)[32], int w, int g, int t4,
                                            int n) {
  const uint8_t* fl = sm.f + (5 - LB) * NPARTS * TILE;
  // k16 steps with a column of the level: dr's K = s with bit LB clear,
  // dk's K = τ with it set (every step at LB = 3)
  constexpr int KS_DR = LB == 5 ? 0x3 : LB == 4 ? 0x5 : 0xF;
  constexpr int KS_DK = LB == 5 ? 0xC : LB == 4 ? 0xA : 0xF;
  const int buf = n & 1;
  float acc[32];
  uint32_t a[4][NPARTS][4];
  acc_parts(a, pacc, w, g, t4, [](int tb, int sb) { return sb < tb && level(tb, sb) == LB - 3; });
  wgmma_fence();
  rs_parts<KS_DR>(acc, a, fl);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
  fence_regs(a);
  mbar_wait(&sm.ex_empty[buf], ((n >> 1) & 1) ^ 1);
  put_rows(sm.ex[buf], acc, w, g, t4, [](int row) { return (row >> LB) & 1; });
  acc_parts(a, ptacc, w, g, t4, [](int sb, int tb) { return tb > sb && level(sb, tb) == LB - 3; });
  wgmma_fence();
  rs_parts<KS_DK>(acc, a, fl);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
  fence_regs(a);
  put_rows(sm.ex[buf], acc, w, g, t4, [](int row) { return !((row >> LB) & 1); });
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(&sm.ex_full[buf]);
}

// Go from its three parts in shared memory (square_parts' layout; they sum
// to it exactly), in the accumulator layout.
__device__ __forceinline__ void square_from_parts(float (&s)[32], const uint8_t* src, int w,
                                                  int g, int t4) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int d = 16 * w + g + 8 * h;
      const int off = d * 128 + ((j ^ (d & 7)) << 4) + 4 * t4;
      float x0 = 0.f, x1 = 0.f;
#pragma unroll
      for (int p = CPARTS - 1; p >= 0; --p) {
        const uint32_t bits = *reinterpret_cast<const uint32_t*>(src + p * TILE + off);
        x0 += __uint_as_float(bits << 16);
        x1 += __uint_as_float(bits & 0xffff0000u);
      }
      s[4 * j + 2 * h] = x0;
      s[4 * j + 2 * h + 1] = x1;
    }
}

// e^w of the prep thread's rows (column d, rows 16q .. 16q + 15) in place,
// Σ w in double and Π e^w over its quarter into wsum and qp (buffer pb);
// past the prep warps' barrier, the chunk's decay D of column d.
__device__ __forceinline__ float column_decays(BwdSmem& sm, float (*w)[NW], int d, int q,
                                               int pb) {
  float x[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) x[j] = w[16 * q + j][d];
  double sum = 0.0;
  float prod = 1.f;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    sum += (double)x[j];
    const float e = expf(x[j]);
    prod *= e;
    w[16 * q + j][d] = e;
  }
  sm.wsum[pb][q][d] = sum;
  sm.qp[pb][q][d] = prod;
  bar_sync(BAR_PREP, PREP_THREADS);
  return expf((float)((sm.wsum[pb][0][d] + sm.wsum[pb][1][d]) +
                      (sm.wsum[pb][2][d] + sm.wsum[pb][3][d])));
}
// Π e^w over the quarters before q and after q, of column d.
__device__ __forceinline__ float quarters_before(const BwdSmem& sm, int d, int q, int pb) {
  float f = 1.f;
#pragma unroll
  for (int k = 0; k < 3; ++k)
    if (k < q) f *= sm.qp[pb][k][d];
  return f;
}
__device__ __forceinline__ float quarters_after(const BwdSmem& sm, int d, int q, int pb) {
  float f = 1.f;
#pragma unroll
  for (int k = 3; k > 0; --k)
    if (k > q) f *= sm.qp[pb][k][d];
  return f;
}

// Thread indices made opaque at a chunk's start, so that the compiler
// recomputes what it derives from them (swizzled offsets, the levels'
// masks) within the chunk instead of holding it across the walk.
__device__ __forceinline__ int opq_i(int x) {
  asm volatile("" : "+r"(x));
  return x;
}

// The smem block behind an opaque pointer, so that the compiler keeps no
// address or descriptor of it in registers from one chunk to the next.
__device__ __forceinline__ BwdSmem& opaque(BwdSmem& sm) {
  BwdSmem* p = &sm;
  asm volatile("" : "+l"(p));
  return *p;
}

// One (b, h) = (blockIdx.y, blockIdx.x) a block: the forward walk from
// state0 storing each chunk's entering state into states[b, h, c], then
// the chunks last to first from dS: dr, dk, dv, dlogw, the block's part of
// du (du_part[b, h]) and dstate0.
__global__ void __launch_bounds__(WG_THREADS, 1)
    wkv6_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_r,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_w,
                          const __grid_constant__ CUtensorMap tm_o, const float* __restrict__ u,
                          const float* __restrict__ s0, const float* __restrict__ dstate,
                          __nv_bfloat16* __restrict__ dr, __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv, float* __restrict__ dlogw,
                          float* __restrict__ ds0, float* __restrict__ states,
                          float* __restrict__ du_part, int S, int H) {
  extern __shared__ uint8_t smem_raw[];
  BwdSmem& sm0 = *reinterpret_cast<BwdSmem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int h = blockIdx.x, b = blockIdx.y;
  const int64_t bh = (int64_t)b * H + h;
  const int C = (S + TW - 1) / TW;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(&sm0.ra_full, 1);
    mbar_init(&sm0.ra_empty, 8);      // the prep warps
    for (int s = 0; s < 2; ++s) {
      mbar_init(&sm0.fa_full[s], 1);
      mbar_init(&sm0.fa_empty[s], 8);
      mbar_init(&sm0.v_full[s], 1);
      mbar_init(&sm0.v_empty[s], 4);  // the MMA warps
      mbar_init(&sm0.ex_full[s], 4);
      mbar_init(&sm0.ex_empty[s], 8);
    }
    mbar_init(&sm0.slot_full, 8);
    mbar_init(&sm0.slot_empty, 4);
    mbar_init(&sm0.pdiag_full, 4);
    mbar_init(&sm0.f_dead, 4);
    mbar_init(&sm0.kr_full, 8);
    mbar_init(&sm0.kk_full, 8);
    mbar_init_fence();
  }
  if (tid < NW) sm0.u[tid] = u[(int64_t)h * NW + tid];
  if (tid == 0) {   // the outputs' element (b, 0, h, 0), read back where they are written
    const int64_t head = ((int64_t)b * S * H + h) * NW;
    sm0.out[0] = reinterpret_cast<uint64_t>(dr + head);
    sm0.out[1] = reinterpret_cast<uint64_t>(dk + head);
    sm0.out[2] = reinterpret_cast<uint64_t>(dv + head);
    sm0.out[3] = reinterpret_cast<uint64_t>(dlogw + head);
  }
  __syncthreads();

  if (tid >= PRODUCER) {  // one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (tid == PRODUCER) {
      BwdSmem& sm = sm0;
      // the forward walk: k, logw (two stages) and v of chunks 0 .. C - 2
      for (int c = 0; c + 1 < C; ++c) {
        const int fs = c & 1, sv = c % V_STAGES;
        mbar_wait(&sm.fa_empty[fs], ((c >> 1) & 1) ^ 1);  // the first round passes
        mbar_expect_tx(&sm.fa_full[fs], TILE + TW * NW * 4);
        tma_load_4d(fs ? sm.r : sm.k, &tm_k, &sm.fa_full[fs], 0, c * TW, h, b);
        tma_load_4d(fs ? &sm.ex[0][0][0] : &sm.w[0][0], &tm_w, &sm.fa_full[fs], 0, c * TW, h,
                    b);
        mbar_wait(&sm.v_empty[sv], ((c / V_STAGES) & 1) ^ 1);
        mbar_expect_tx(&sm.v_full[sv], TILE);
        tma_load_4d(sm.v[sv], &tm_v, &sm.v_full[sv], 0, c * TW, h, b);
      }
      // both forward stages released before the reverse walk writes over them
      for (int fs = 0; fs < 2; ++fs) {
        const int uses = (C - 1 - fs + 1) / 2;  // chunks c ≡ fs (mod 2), c ≤ C - 2
        if (uses > 0) mbar_wait(&sm.fa_empty[fs], (uses - 1) & 1);
      }
      // the reverse walk: r, k, logw, v and do of chunks C - 1 .. 0
      for (int jr = 0; jr < C; ++jr) {
        const int i = C - 1 + jr, t0 = (C - 1 - jr) * TW, sv = i % V_STAGES;
        mbar_wait(&sm.ra_empty, (jr & 1) ^ 1);
        mbar_expect_tx(&sm.ra_full, 2 * TILE + TW * NW * 4);
        tma_load_4d(sm.r, &tm_r, &sm.ra_full, 0, t0, h, b);
        tma_load_4d(sm.k, &tm_k, &sm.ra_full, 0, t0, h, b);
        tma_load_4d(&sm.w[0][0], &tm_w, &sm.ra_full, 0, t0, h, b);
        mbar_wait(&sm.v_empty[sv], ((i / V_STAGES) & 1) ^ 1);
        mbar_expect_tx(&sm.v_full[sv], 2 * TILE);
        tma_load_4d(sm.v[sv], &tm_v, &sm.v_full[sv], 0, t0, h, b);
        tma_load_4d(sm.o[sv], &tm_o, &sm.v_full[sv], 0, t0, h, b);
      }
    }
  } else if (tid >= PREP) {  // the prep warps: the decays, the operands and the outputs
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(PREP_REGS));
    const int pt = tid - PREP;
    // the forward walk: k ⊙ sd a chunk, read transposed by the MMA warpgroup
    for (int c = 0; c + 1 < C; ++c) {
      BwdSmem& sm = opaque(sm0);
      const int lane = opq_i(pt) & 31, d = opq_i(pt) & 63, q = opq_i(pt) >> 6;
      const int fs = c & 1;
      mbar_wait(&sm.fa_full[fs], (c >> 1) & 1);
      if (pt == 0) PROF_FWD(c, 0);
      float (*w)[NW] = fs ? reinterpret_cast<float (*)[NW]>(&sm.ex[0][0][0]) : sm.w;
      const float dtd = column_decays(sm, w, d, q, fs);
      const uint8_t* kt = fs ? sm.r : sm.k;
      float f = quarters_after(sm, d, q, fs);
      mbar_wait(&sm.slot_empty, (c & 1) ^ 1);   // the MMA warpgroup is done with the slot
      if (pt == 0) PROF_FWD(c, 1);
      if (q == 0) sm.dt[d] = dtd;
      float (*kd)[LDT] = reinterpret_cast<float (*)[LDT]>(sm.f);
#pragma unroll
      for (int j = 15; j >= 0; --j) {
        const int t = 16 * q + j;
        kd[t][d] = bf16_at(kt, t, d) * f;
        f *= w[t][d];
      }
      fence_proxy_async();  // e^w written into the stage before TMA refills it
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(&sm.slot_full);
        mbar_arrive(&sm.fa_empty[fs]);
      }
      if (pt == 0) PROF_FWD(c, 2);
    }
    // the reverse walk; e^w of row t of column d is sm.w[t][d] from the chunk's start on
    float du_acc = 0.f;
    for (int jr = 0; jr < C; ++jr) {
      BwdSmem& sm = opaque(sm0);
      const int lane = opq_i(pt) & 31, pw = opq_i(pt) >> 5, d = opq_i(pt) & 63,
                q = opq_i(pt) >> 6;
      const int i = C - 1 + jr, t0 = (C - 1 - jr) * TW, pb = jr & 1;
      const float* ew = &sm.w[16 * q][d];   // e^w of row 16q + j at ew[NW j]
      mbar_wait(&sm.ra_full, jr & 1);
      if (pt == 0) PROF(jr, 0);
      const float dtd = column_decays(sm, sm.w, d, q, pb);
      if (pt == 0) PROF(jr, 1);
      mbar_wait(&sm.slot_empty, (i & 1) ^ 1);  // the MMA warpgroup is done with the slot
      if (pt == 0) PROF(jr, 2);
      if (q == 0) sm.dt[d] = dtd;
      {
        // the levels' operands F_L in parts: at the rows with bit L set r
        // times Π e from the start of the row's L-block, elsewhere k times
        // Π e to its end; levels 32, 16 and 8
        float x[16];
        float lp = q == 3 ? sm.qp[pb][2][d] : 1.f, ls = q == 0 ? sm.qp[pb][1][d] : 1.f;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int jb = 15 - j;
          if (q >= 2) x[j] = bf16_at(sm.r, 16 * q + j, d) * lp;
          if (q < 2) x[jb] = bf16_at(sm.k, 16 * q + jb, d) * ls;
          lp *= ew[NW * j];
          ls *= ew[NW * jb];
        }
#pragma unroll
        for (int j = 0; j < 16; ++j) put_parts(sm.f, 16 * q + j, d, x[j]);
        lp = ls = 1.f;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int jb = 15 - j;
          if (q & 1) x[j] = bf16_at(sm.r, 16 * q + j, d) * lp;
          if (!(q & 1)) x[jb] = bf16_at(sm.k, 16 * q + jb, d) * ls;
          lp *= ew[NW * j];
          ls *= ew[NW * jb];
        }
#pragma unroll
        for (int j = 0; j < 16; ++j) put_parts(sm.f + NPARTS * TILE, 16 * q + j, d, x[j]);
        lp = ls = 1.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          x[8 + j] = bf16_at(sm.r, 16 * q + 8 + j, d) * lp;
          x[7 - j] = bf16_at(sm.k, 16 * q + 7 - j, d) * ls;
          lp *= ew[NW * (8 + j)];
          ls *= ew[NW * (7 - j)];
        }
#pragma unroll
        for (int j = 0; j < 16; ++j) put_parts(sm.f + 2 * NPARTS * TILE, 16 * q + j, d, x[j]);
      }
      fence_proxy_async();  // the parts, before wgmma reads them
      __syncwarp();
      if (lane == 0) mbar_arrive(&sm.slot_full);
      if (pt == 0) PROF(jr, 3);
      // A's diagonal blocks (read by the MMA warpgroup after kr_full), while
      // it runs the first products: warp pw takes block pw
      diag_walk(sm, pw, lane & 3, lane >> 2);
      if (pt == 0) PROF(jr, 4);

      // the exchange: pd ⊙ X1, sd ⊙ X2, then the levels' sums times their
      // row factors (dr′) or column factors (dk′).  dlogw takes the chunk's
      // identity per half of 32 steps (the sums of its terms cancel, and
      // over 64 steps their rounding would exceed what a 32-step chunk
      // leaves): in the first half the level-32 part of dk′ counts with the
      // state's term (k ⊙ sd ⊙ Go v), and each half's constant is tot plus
      // the other half's state terms, r ⊙ pd ⊙ X1 of the second half or k
      // ⊙ sd ⊙ X2 of the first (s_half)
      float s_half = 0.f, drp[16], dks[16], dki[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) drp[j] = dks[j] = dki[j] = 0.f;
#pragma unroll 1
      for (int m = 0; m < 5; ++m) {
        const int n = 5 * jr + m, buf = n & 1;
        mbar_wait(&sm.ex_full[buf], (n >> 1) & 1);
        const float (*ex)[LDX] = sm.ex[buf];
        const bool rows_r = m == 0 || (m == 2 && q >= 2) || (m == 3 && (q & 1));
        if (m == 4 || rows_r) {   // prefix factors
          float f = m == 0 ? quarters_before(sm, d, q, pb)
                  : (m == 2 && q == 3) ? sm.qp[pb][2][d] : 1.f, f8 = 1.f;
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const float z = ex[16 * q + j][d];
            if (j == 8) f8 = 1.f;
            if (m == 0) {
              const float x = f * z;
              drp[j] += x;
              if (q >= 2) s_half = fmaf(bf16_at(sm.r, 16 * q + j, d), x, s_half);
            } else if (m == 4) {
              if (j >= 8) drp[j] = fmaf(f8, z, drp[j]);
            } else {
              drp[j] = fmaf(f, z, drp[j]);
            }
            const float e = ew[NW * j];
            f *= e;
            f8 *= e;
          }
        }
        if (m == 4 || !rows_r) {  // suffix factors
          float f = m == 1 ? quarters_after(sm, d, q, pb)
                  : (m == 2 && q == 0) ? sm.qp[pb][1][d] : 1.f, f8 = 1.f;
#pragma unroll
          for (int j = 15; j >= 0; --j) {
            const float z = ex[16 * q + j][d];
            if (j == 7) f8 = 1.f;
            if (m == 1) {
              dks[j] = f * z;
              if (q < 2) s_half = fmaf(bf16_at(sm.k, 16 * q + j, d), dks[j], s_half);
            } else if (m == 2) {
              dks[j] = fmaf(f, z, dks[j]);   // q < 2: the first half's level 32
            } else if (m == 4) {
              if (j < 8) dki[j] = fmaf(f8, z, dki[j]);
            } else {
              dki[j] = fmaf(f, z, dki[j]);
            }
            const float e = ew[NW * j];
            f *= e;
            f8 *= e;
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&sm.ex_empty[buf]);
      }
      if (pt == 0) PROF(jr, 5);

      // the diagonal blocks of dr′'s and dk′'s intra-chunk sums, and du
      mbar_wait(&sm.pdiag_full, jr & 1);
      if (pt == 0) PROF(jr, 6);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int t = 16 * q + j, b0 = j & 8;
        float acc = 0.f, f = 1.f;     // Σ_{s<t} P[t, s] k_s Π_{s<i<t} e_i
#pragma unroll
        for (int s = j - 1; s >= b0; --s) {
          acc = fmaf(sm.pdiag[t][s & 7] * bf16_at(sm.k, 16 * q + s, d), f, acc);
          f *= ew[NW * s];
        }
        drp[j] += acc;
        acc = 0.f;
        f = 1.f;                      // Σ_{τ>t} P[τ, t] r_τ Π_{t<i<τ} e_i
#pragma unroll
        for (int tau = j + 1; tau < b0 + 8; ++tau) {
          acc = fmaf(sm.pdiag[16 * q + tau][j & 7] * bf16_at(sm.r, 16 * q + tau, d), f, acc);
          f *= ew[NW * tau];
        }
        dki[j] += acc;
        du_acc = fmaf(sm.pdiag[t][j & 7], bf16_at(sm.r, t, d) * bf16_at(sm.k, t, d), du_acc);
      }
      if (pt == 0) PROF(jr, 7);

      // r ⊙ pd ([t][d], three parts) for the gradient's chain; then, once the
      // levels' products have retired, k ⊙ sd ([s][d]) into the F region
      {
        float f = quarters_before(sm, d, q, pb);
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int t = 16 * q + j;
          put_parts<CPARTS>(sm.rp[0], t, d, bf16_at(sm.r, t, d) * f);
          f *= ew[NW * j];
        }
      }
      fence_proxy_async();  // the parts, before wgmma reads them
      __syncwarp();
      if (lane == 0) mbar_arrive(&sm.kr_full);
      if (pt == 0) PROF(jr, 8);
      mbar_wait(&sm.f_dead, jr & 1);
      if (pt == 0) PROF(jr, 9);
      {
        float f = quarters_after(sm, d, q, pb);
#pragma unroll
        for (int j = 15; j >= 0; --j) {
          const int t = 16 * q + j;
          put_parts(sm.f, t, d, bf16_at(sm.k, t, d) * f);
          f *= ew[NW * j];
        }
      }
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(&sm.kk_full);
      if (pt == 0) PROF(jr, 10);

      // dr, dk; then r ⊙ dr′, k ⊙ (the state's term) and k ⊙ (dk′'s
      // intra-chunk sum) in place for dlogw, and their sums over the quarter
      float s_ks = 0.f, s_rr = 0.f, s_ki = 0.f;
      const float ud = sm.u[d];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int t = 16 * q + j;
        const float r = bf16_at(sm.r, t, d), k = bf16_at(sm.k, t, d);
        const float ptt = sm.pdiag[t][t & 7];
        if (t0 + t < S) {
          const int64_t at = (int64_t)(t0 + t) * H * NW + d;
          reinterpret_cast<__nv_bfloat16*>(sm.out[0])[at] =
              __float2bfloat16_rn(drp[j] + ptt * ud * k);
          reinterpret_cast<__nv_bfloat16*>(sm.out[1])[at] =
              __float2bfloat16_rn((dks[j] + dki[j]) + ptt * ud * r);
        }
        drp[j] *= r;
        dks[j] *= k;
        dki[j] *= k;
        s_rr += drp[j];
        s_ks += dks[j];
        s_ki += dki[j];
      }
      sm.qsum[0][q][d] = s_ks;
      sm.qsum[1][q][d] = s_rr;
      sm.qsum[2][q][d] = s_ki;
      sm.qsum[3][q][d] = s_half;
      bar_sync(BAR_PREP, PREP_THREADS);
      {  // dlogw_t = tot_half + Σ_{s<t} ks + Σ_{τ>t} rr − Σ_{s≥t} ki within t's half
        const int q0 = q & 2;   // the half's first quarter
        float before = q == q0 + 1 ? sm.qsum[0][q0][d] : 0.f;
        float after_r = q == q0 ? sm.qsum[1][q0 + 1][d] : 0.f;
        float from_i = q == q0 ? sm.qsum[2][q0 + 1][d] : 0.f;
        const float tot = sm.tot[d] + (sm.qsum[3][2 - q0][d] + sm.qsum[3][3 - q0][d]);
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const float x = dks[j];
          dks[j] = before;
          before += x;
        }
#pragma unroll
        for (int j = 15; j >= 0; --j) {
          const int t = 16 * q + j;
          from_i += dki[j];
          if (t0 + t < S)
            reinterpret_cast<float*>(sm.out[3])[(int64_t)(t0 + t) * H * NW + d] =
                ((tot + dks[j]) + after_r) - from_i;
          after_r += drp[j];
        }
      }
      fence_proxy_async();  // e^w written into the stage before TMA refills it
      __syncwarp();
      if (lane == 0) mbar_arrive(&sm.ra_empty);
      if (pt == 0) PROF(jr, 11);
    }
    // du: the quarters' sums in order
    sm0.du[pt >> 6][pt & 63] = du_acc;
    bar_sync(BAR_PREP, PREP_THREADS);
    if (pt < NW)   // (b, h) from the block's indices again: nothing is kept from the start
      du_part[((int64_t)opq_i(blockIdx.y) * H + blockIdx.x) * NW + pt] =
          ((sm0.du[0][pt] + sm0.du[1][pt]) + sm0.du[2][pt]) + sm0.du[3][pt];
  } else {  // the MMA warpgroup: every product, the state and the gradient
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(MMA_REGS));
    float* st = states + bh * (int64_t)C * NW * NW;
    {  // the forward walk: S_{c+1} = D ⊙ S_c + (k ⊙ sd)ᵀ V from state0
      const int w = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
      float s[32];
      load_square_acc(s, s0 + bh * NW * NW, w, g, t4);
      for (int c = 0; c < C; ++c) {
        store_square_acc(st + (int64_t)c * NW * NW, s, w, g, t4);
        if (c + 1 == C) break;
        BwdSmem& sm = opaque(sm0);
        const int sv = c % V_STAGES;
        mbar_wait(&sm.v_full[sv], (c / V_STAGES) & 1);
        mbar_wait(&sm.slot_full, c & 1);
        if (tid == 0) PROF_FWD(c, 3);
        uint32_t kp[4][CPARTS][4];
        const float (*kd)[LDT] = reinterpret_cast<const float (*)[LDT]>(sm.f);
        a_parts<CPARTS>(kp, w, g, t4,
                [&](int dd, int ss) { return make_float2(kd[ss][dd], kd[ss + 1][dd]); });
        const float dta = sm.dt[16 * w + g], dtb = sm.dt[16 * w + g + 8];
        __syncwarp();
        if (lane == 0) mbar_arrive(&sm.slot_empty);
        float pacc[32];
        wgmma_fence();
        rs_exact<false, CPARTS>(pacc, kp, sm.v[sv]);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(pacc);
        fence_regs(kp);
        __syncwarp();
        if (lane == 0) mbar_arrive(&sm.v_empty[sv]);
        if (tid == 0) PROF_FWD(c, 4);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[4 * j] = fmaf(dta, s[4 * j], pacc[4 * j]);
          s[4 * j + 1] = fmaf(dta, s[4 * j + 1], pacc[4 * j + 1]);
          s[4 * j + 2] = fmaf(dtb, s[4 * j + 2], pacc[4 * j + 2]);
          s[4 * j + 3] = fmaf(dtb, s[4 * j + 3], pacc[4 * j + 3]);
        }
      }
    }
    // the reverse walk from Go = dS, carried in its three parts
    {
      const int w = tid >> 5, g = (tid & 31) >> 2, t4 = tid & 3;
      float go[32];
      load_square_acc(go, dstate + bh * NW * NW, w, g, t4);
      square_parts(sm0.gop[0], go, w, g, t4);
      fence_proxy_async();
      bar_sync(BAR_MMA, 128);
    }
    for (int jr = 0; jr < C; ++jr) {
      BwdSmem& sm = opaque(sm0);
      const int w = opq_i(tid) >> 5, lane = opq_i(tid) & 31, g = lane >> 2, t4 = lane & 3;
      const int i = C - 1 + jr, c = C - 1 - jr, t0 = c * TW, sv = i % V_STAGES;
      const uint8_t* vt = sm.v[sv];
      const uint8_t* ot = sm.o[sv];
      float sc[32];   // S_c as the forward walk stored it
      load_square_acc(sc, st + (int64_t)c * NW * NW, w, g, t4);
      mbar_wait(&sm.v_full[sv], (i / V_STAGES) & 1);
      if (tid == 0) PROF(jr, 12);
      float pacc[32], x1[32], x2[32];
      {
        uint32_t sp[4][NPARTS][4];   // S_c's parts over e
        acc_parts(sp, sc, w, g, t4, [](int, int) { return true; });
        // rowsum(Go ⊙ S_c), the row's columns summed across its lanes (tot
        // = D ⊙ it once the slot holds D)
        float rowsum[2], go[32];
        square_from_parts(go, sm.gop[0], w, g, t4);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float x = 0.f;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            x = fmaf(go[4 * j + 2 * hh], sc[4 * j + 2 * hh], x);
            x = fmaf(go[4 * j + 2 * hh + 1], sc[4 * j + 2 * hh + 1], x);
          }
          x += __shfl_xor_sync(0xffffffffu, x, 1);
          rowsum[hh] = x + __shfl_xor_sync(0xffffffffu, x, 2);
        }
        wgmma_fence();
        ss_product<false>(pacc, ot, vt);   // P = dO Vᵀ, [t][s]
        wgmma_commit();
        rs_exact_k(x1, sp, ot);            // X1ᵀ = S_c dOᵀ, [d][t]
        wgmma_commit();
        ss_product<true>(x2, vt, sm.gop[CPARTS - NPARTS]);   // X2 = V Goᵀ, [s][d]
        wgmma_commit();
        wgmma_wait<2>();
        fence_regs(pacc);
        // the slot: D, the levels' operands (and the prep warps done with
        // the last chunk's P, tot and outputs)
        mbar_wait(&sm.slot_full, i & 1);
        if (tid == 0) PROF(jr, 13);
        if (t4 == 0) {
          sm.tot[16 * w + g] = sm.dt[16 * w + g] * rowsum[0];
          sm.tot[16 * w + g + 8] = sm.dt[16 * w + g + 8] * rowsum[1];
        }
        // P's diagonal 8 x 8 blocks for the prep warps
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)   // block 2w + hh (indices fixed at compile time)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            if (jj == 2 * w + hh)
              *reinterpret_cast<float2*>(&sm.pdiag[16 * w + g + 8 * hh][2 * t4]) =
                  make_float2(pacc[4 * jj + 2 * hh], pacc[4 * jj + 2 * hh + 1]);
        __syncwarp();
        if (lane == 0) mbar_arrive(&sm.pdiag_full);
        wgmma_wait<1>();
        fence_regs(x1);
        fence_regs(sp);
        {  // X1ᵀ transposed into the exchange
          const int n = 5 * jr, buf = n & 1;
          mbar_wait(&sm.ex_empty[buf], ((n >> 1) & 1) ^ 1);
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
#pragma unroll
              for (int cc = 0; cc < 2; ++cc)
                sm.ex[buf][8 * j + 2 * t4 + cc][16 * w + g + 8 * hh] = x1[4 * j + 2 * hh + cc];
          __syncwarp();
          if (lane == 0) mbar_arrive(&sm.ex_full[buf]);
        }
        wgmma_wait<0>();
        fence_regs(x2);
        {
          const int n = 5 * jr + 1, buf = n & 1;
          mbar_wait(&sm.ex_empty[buf], ((n >> 1) & 1) ^ 1);
          put_rows(sm.ex[buf], x2, w, g, t4, [](int) { return true; });
          __syncwarp();
          if (lane == 0) mbar_arrive(&sm.ex_full[buf]);
        }
      }
      {  // the levels' intra-chunk sums of dr′ and dk′
        float ptacc[32];
        wgmma_fence();
        ss_product<false>(ptacc, vt, ot);   // Pᵀ = V dOᵀ, [s][τ]
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(ptacc);
        level_round<5>(sm, pacc, ptacc, w, g, t4, 5 * jr + 2);
        level_round<4>(sm, pacc, ptacc, w, g, t4, 5 * jr + 3);
        level_round<3>(sm, pacc, ptacc, w, g, t4, 5 * jr + 4);
      }
      if (tid == 0) PROF(jr, 14);
      // Aᵀ [s][τ]: the levels' F_L F_Lᵀ, each entry from its pair's level,
      // and the diagonal blocks (adiag), in parts over τ
      uint32_t ap[4][NPARTS][4];
      {
        float a5[32], a4[32], a3[32];
        wgmma_fence();
        ss_level(a5, sm.f);
        ss_level(a4, sm.f + NPARTS * TILE);
        ss_level(a3, sm.f + 2 * NPARTS * TILE);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(a5);
        fence_regs(a4);
        fence_regs(a3);
        __syncwarp();
        if (lane == 0) mbar_arrive(&sm.f_dead);
        if (tid == 0) PROF(jr, 15);
        mbar_wait(&sm.kr_full, jr & 1);
        if (tid == 0) PROF(jr, 16);
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int h = r & 1, jj = 2 * j + (r >> 1), sb = 2 * w + h, x = 4 * jj + 2 * h;
            const int lv = level(jj, sb);   // the pair of blocks' level less 3
            float v[2];
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const float diag = sm.adiag[8 * jj + 2 * t4 + c][g];
              v[c] = jj > sb ? (lv == 2 ? a5[x + c] : lv == 1 ? a4[x + c] : a3[x + c])
                   : jj == sb ? diag : 0.f;
            }
            uint32_t part[NPARTS];
            split_bf16<NPARTS>(v[0], v[1], part);
#pragma unroll
            for (int p = 0; p < NPARTS; ++p) ap[j][p][r] = part[p];
          }
      }
      // the gradient's chain (r ⊙ pd)ᵀ dO, [d][e]; then dv = (k ⊙ sd) Go + Aᵀ
      // dO, [s][e], once k ⊙ sd is in
      float ch[32], dva[32];
      wgmma_fence();
      ss_chain(ch, sm.rp[0], ot);
      wgmma_commit();
      mbar_wait(&sm.kk_full, jr & 1);
      wgmma_fence();
      ss_kgo(dva, sm.f, sm.gop[CPARTS - NPARTS]);
      rs_exact<true>(dva, ap, ot);
      wgmma_commit();
      const float dta = sm.dt[16 * w + g], dtb = sm.dt[16 * w + g + 8];
      wgmma_wait<0>();
      fence_regs(ch);
      fence_regs(dva);
      fence_regs(ap);
      __syncwarp();
      if (lane == 0) {   // every read of the slot and of v and do is done
        mbar_arrive(&sm.slot_empty);
        mbar_arrive(&sm.v_empty[sv]);
      }
      if (tid == 0) PROF(jr, 17);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int t = t0 + 16 * w + g + 8 * hh;
        if (t >= S) continue;
        __nv_bfloat16* dst =
            reinterpret_cast<__nv_bfloat16*>(sm.out[2]) + (int64_t)t * H * NW + 2 * t4;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
              __floats2bfloat162_rn(dva[4 * j + 2 * hh], dva[4 * j + 2 * hh + 1]);
      }
      {  // Go_{c-1} = D ⊙ Go_c + (r ⊙ pd)ᵀ dO
        float go[32];
        square_from_parts(go, sm.gop[0], w, g, t4);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          go[4 * j] = fmaf(dta, go[4 * j], ch[4 * j]);
          go[4 * j + 1] = fmaf(dta, go[4 * j + 1], ch[4 * j + 1]);
          go[4 * j + 2] = fmaf(dtb, go[4 * j + 2], ch[4 * j + 2]);
          go[4 * j + 3] = fmaf(dtb, go[4 * j + 3], ch[4 * j + 3]);
        }
        if (c > 0) {  // its parts, for the next chunk's products
          square_parts(sm.gop[0], go, w, g, t4);
          fence_proxy_async();
          bar_sync(BAR_MMA, 128);
        } else {      // dstate0
          store_square_acc(ds0 + bh * NW * NW, go, w, g, t4);
        }
      }
      if (tid == 0) PROF(jr, 18);
    }
  }
}

// Tensor map of the fp32 logw, (B, S, H, 64) contiguous: boxes of 64
// columns by 64 steps of one head, no swizzle; steps past S read as zeros.
bool logw_map(CUtensorMap* map, const float* ptr, int S, int H, int B) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)NW, (cuuint64_t)std::max(S, 1), (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)H * NW * 4, (cuuint64_t)NW * 4,
                                 (cuuint64_t)std::max(S, 1) * H * NW * 4};
  const cuuint32_t box[4] = {(cuuint32_t)NW, (cuuint32_t)TW, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<float*>(ptr), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

cudaError_t launch_wgmma(const void* r, const void* k, const void* v, const float* logw,
                         const float* u, const float* s0, const void* dout, const float* dstate,
                         void* dr, void* dk, void* dv, float* dlogw, float* du, float* ds0,
                         float* states, float* du_part, int B, int S, int H,
                         cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      wkv6_bwd_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, BWD_SMEM);
  if (attr != cudaSuccess) return attr;
  if (S == 0) {  // no step: dstate0 is dS and du is 0 (and a map of no steps has no strides)
    const cudaError_t err = cudaMemcpyAsync(ds0, dstate, sizeof(float) * B * H * NW * NW,
                                            cudaMemcpyDeviceToDevice, stream);
    return err != cudaSuccess ? err : cudaMemsetAsync(du, 0, sizeof(float) * H * NW, stream);
  }
  CUtensorMap tr, tk, tv, tw, to;
  const int64_t rs = (int64_t)H * NW, hs = NW, bs = (int64_t)S * H * NW;
  if (!head_map(&tr, r, NW, S, H, B, rs, hs, bs, TW) ||
      !head_map(&tk, k, NW, S, H, B, rs, hs, bs, TW) ||
      !head_map(&tv, v, NW, S, H, B, rs, hs, bs, TW) ||
      !head_map(&to, dout, NW, S, H, B, rs, hs, bs, TW) || !logw_map(&tw, logw, S, H, B))
    return cudaErrorInvalidValue;
  wkv6_bwd_wgmma_kernel<<<dim3(H, B), WG_THREADS, BWD_SMEM, stream>>>(
      tr, tk, tv, tw, to, u, s0, dstate, static_cast<__nv_bfloat16*>(dr),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), dlogw, ds0, states,
      du_part, S, H);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  du_kernel<NW><<<H, NW, 0, stream>>>(du_part, du, B, H, 1);
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

// The wgmma kernel (bf16 at N = 64, one block a (b, h), chunks of 64): r, k,
// v, dout, dr, dk, dv (B, S, H, 64) bf16 contiguous; logw, dlogw (B, S, H,
// 64), u, du (H, 64), s0, dstate, ds0 (B, H, 64, 64) fp32 contiguous;
// scratch: states (B, H, ceil(S / 64), 64, 64) and du_part (B, H, 64) fp32.
// All 16-byte aligned.
extern "C" int wkv6_bwd_wgmma(const void* r, const void* k, const void* v, const float* logw,
                              const float* u, const float* s0, const void* dout,
                              const float* dstate, void* dr, void* dk, void* dv, float* dlogw,
                              float* du, float* ds0, float* states, float* du_part, int B, int S,
                              int H, void* stream) {
  using namespace repro_torch;
  if (B < 0 || S < 0 || H < 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0) return (int)cudaSuccess;
  return (int)launch_wgmma(r, k, v, logw, u, s0, dout, dstate, dr, dk, dv, dlogw, du, ds0,
                           states, du_part, B, S, H, static_cast<cudaStream_t>(stream));
}

#ifdef WKV_BWD_PROF
// The stamps of the last profiled launch: 2·PROF_CHUNKS x PROF_STAMPS clock64
// (the reverse walk's rows, then the forward walk's).
extern "C" int wkv6_bwd_prof(long long* host) {
  return (int)cudaMemcpyFromSymbol(host, repro_torch::bwd_prof, sizeof(repro_torch::bwd_prof));
}
#endif
