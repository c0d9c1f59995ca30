// The backward of flash attention on Hopper (sm_90a): dQ, dK and dV of
// exactly the function flash_attention.cu computes, fp32 accumulation.
//
// Replaces no TPU kernel.  The JAX reference trains through its jnp path
// and takes the attention gradient from XLA's autodiff of `attend`
// (src/repro/models/layers.py); it has no backward kernel and no
// custom_vjp.  On the card the port's forward is the hand-written K1, which
// autograd cannot see into, so training on the card needs the gradient as
// a kernel too.  This is it: GQA (G = H/K query heads per kv head), causal
// or not with Sq != Skv allowed, a sliding window (0 = global), the tanh
// softcap and per-sequence `lengths`, fp32 or bf16 in, the gradients out in
// the input's type.  Masked entries contribute nothing; a query row with no
// live key (output 0 in the forward) gets no gradient.
//
// What bounds it on this card: five products of Sq x Skv x d per head (the
// scores, dP, dV, dK, dQ), 10·d operations per unmasked (query, key) pair,
// far above the H100's 295 operations per byte, so operations: the products
// belong on the tensor cores, and on Hopper that means wgmma.
//
// bf16 (bwd_dq_wgmma_kernel, bwd_dkv_wgmma_kernel): two launches, each
// warp-specialised as K1's forward is: a producer warpgroup, one thread of
// which issues every TMA copy into a ring of STAGES tiles (full and empty
// mbarriers, 4-D tensor maps over the models' strided (B, S, heads, d)
// views, the 128-byte swizzle wgmma reads, zeros past Sq and Skv), and two
// consumer warpgroups on setmaxnreg 240 that take turns on named barriers
// (ping-pong), so that one's exponentials and dS arithmetic run under the
// other's wgmma products.
// - The statistics come from the forward.  K1's bf16 forward writes each
//   row's lse (m + log l of the scaled, capped scores, 1e30 for a row with
//   no live key) and its output before the bf16 rounding, in fp32, when the
//   backward will need them (flash_attention(..., return_stats=True)).
//   D = rowsum(dO ∘ O) is taken from that fp32 O in the dQ kernel's
//   prologue, once a row, and written for the dK/dV kernel.  From the bf16
//   O it would not do: every row of dS sums to zero, so dQ_i = sum_j dS_ij
//   k_j cancels, and an error e in D_i moves dQ_i by -e·(P·K)_i, which does
//   not (tests/test_torch_flash_bwd.py::
//   test_delta_from_bf16_output_exceeds_the_chip_limit).  No statistics
//   sweep: S and dP are formed once in each kernel.
// - dQ kernel, one block per (head, b, 128 query rows), 64 a warpgroup, Q
//   and dO loaded once, K and V tiles of 64 keys (32 at d = 256) in the
//   ring: S = Q·Kᵀ and dP = dO·Vᵀ (wgmma with both operands in shared
//   memory, one group), dS = P (dP - D) times the softcap's derivative in
//   registers, then dQ += dS·K with dS as register-A (S's accumulator
//   layout is the A fragment's) and K read MN-major, as K1 reads V.  Tile
//   n issues S(n) and dP(n), then dS(n - 1)·K(n - 1), in its turn, and forms
//   dS(n) while the latter retires.
// - dK/dV kernel, one block per (kv head, b, key tile), K and V loaded
//   once; Q, dO, lse and D tiles of 64 query rows (32 at d = 256) in the
//   ring, the G heads of the kv head one after the other and each head's
//   live query tiles (no atomics, a fixed order: two calls give the same
//   bits).  Sᵀ = K·Qᵀ puts the keys in the rows, so that Pᵀ and dSᵀ are
//   register-A of dV += Pᵀ·dO and dK += dSᵀ·Q, dO and Q read MN-major.  At
//   d = 64 each warpgroup owns 64 keys of a 128-key tile and sums both
//   (dK and dV are d = 64 fp32 registers a thread; the split below made the
//   kernel 12-31% slower there).  From d = 128 that
//   cannot fit beside the scores (d = 256 registers at d = 256): both
//   warpgroups read the same 64 keys, warpgroup 0 summing dV (Sᵀ, then Pᵀ)
//   and 1 dK (Sᵀ and dPᵀ, then dSᵀ), so Sᵀ is formed twice.  Tensor work,
//   counting each bf16 part of P and dS: 2 + 2·PARTS products in the dQ
//   kernel, 2 + 2·PARTS in the dK/dV kernel at d = 64 and 3 + 2·PARTS from
//   d = 128: 10 or 11 at two parts, against the bound's five.
// - Entries.  Each entry of P and dS costs an FMA (the scale and the lse,
//   with log2 e folded into both: the dQ kernel writes lse in ex2's units
//   for the dK/dV kernel), an ex2, and dS's subtraction and product; the
//   softcap and the mask are tested once a tile, not an entry.  Tested an
//   entry, with the cap's division beside, they made the d = 64 kernels
//   2.6-4x slower (a whole granite-3-2b call 3.6-3.7 ms against 0.90).
// - Parity.  The gradients are held to the float64 plain version within
//   2^-14·max|want| + 2^-7·|want| (chip_smoke.py phase 18).  S and dP are
//   exact products of bf16 inputs, summed in chains of PARITY_QK_CHAIN k16
//   steps (one chain at every d).  P and dS are fp32 values; rounded once
//   to bf16 (PARITY_BWD_PARTS = 1) they put ~2^-9 of relative error into
//   every term of a gradient's sum and miss the limit by 9.9-20.8x, so they
//   enter the gradient products in two bf16 parts (split_bf16): 0.480-0.490
//   of the limit, the bf16 output's own half ulp.  Three parts, each k16
//   step summed from zero (PARITY_BWD_FRESH = 1), S in chains of 8 at
//   d = 256 and the IEEE exponentials give the same ratios and cost
//   16-69%, 11-48%, 0-4% and 11-24% more, so none ships.  D from the bf16 output
//   misses by 3.2-41x.  (parity_probe.py --kernel flash_bwd, NVIDIA H100
//   80GB HBM3, 700.00 W.)
// - Registers (ptxas, no spill at any d; setmaxnreg 240 a consumer thread,
//   24 the producer's).
// - Masking stays in registers: each warp tests its 16 rows against a tile
//   and masks only a tile that crosses an edge.  Kv tiles that no row of a
//   dQ block sees, and query tiles that see no key of a dK/dV block
//   (causality, the window, `lengths`), are never loaded.  The dQ kernel
//   issues each head's longest causal rows first, the dK/dV kernel its
//   first (longest) key tiles first; the other orders measured slower.
//
// fp32 (bwd_{stats,dq,dkv}_kernel): the first version, unchanged: three
// passes of IEEE fp32 FMA on the CUDA cores (67 TFLOP/s peak), the scores
// and dP recomputed in each (9 products), tiles in shared memory as fp32
// with a padded row pitch; 256 threads as 16 row groups x 16 column lanes,
// each owning rows rg + 16i and columns cg + 16j of a score tile and of its
// accumulators; 64 x 64 tiles at d = 64 and 128 and 32 x 32 at d = 256.
// Only the ~100M fp32 config trains through it; it takes no forward state.
// common.cuh's parity switches as this kernel ships them (see the header)
#ifndef PARITY_QK_CHAIN
#define PARITY_QK_CHAIN 16
#endif
#ifndef PARITY_BWD_PARTS
#define PARITY_BWD_PARTS 2
#endif
#ifndef PARITY_BWD_FRESH
#define PARITY_BWD_FRESH 0
#endif
#ifndef PARITY_IEEE_EXP
#define PARITY_IEEE_EXP 0
#endif

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int NTF = 256;  // fp32: 16 row groups x 16 column lanes

// tensors, in the order of their strides
enum { TQ, TK, TV, TDO, TDQ, TDK, TDV };

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  // bf16: the forward's lse (B, H, sq_pitch) and fp32 output (B, H, Sq, d),
  // and scratch of lse's shape for D and, in the units of kExpScale, lse
  // (lse_x), which the dQ kernel writes for the dK/dV kernel; fp32: lse and
  // D scratch, rows Sq apart, and no o32
  float* lse;
  float* delta;
  float* lse_x;
  const float* o32;
  const int* lengths;
  int64_t st[21];  // (b, head, seq) element strides of q, k, v, dout, dq, dk, dv
  int H, K, Sq, Skv, causal, window;
  float softcap, sm_scale;
  int sq_pitch;
};

template <int D>
struct Tiles {
  static constexpr int B = D == 256 ? 32 : 64;  // query rows and keys per tile
};

template <typename T>
__device__ __forceinline__ T* at(const BwdArgs& a, int t, const void* base, int b, int head) {
  return static_cast<T*>(const_cast<void*>(base)) + b * a.st[3 * t] + head * a.st[3 * t + 1];
}

__device__ __forceinline__ bool live(const BwdArgs& a, int len, int qi, int kj) {
  return qi < a.Sq && kj < len && (!a.causal || kj <= qi) &&
         (a.window <= 0 || kj > qi - a.window);
}

// The kv tiles that can hold a live key for some row of query tile q0.
template <int BT>
__device__ __forceinline__ void kv_range(const BwdArgs& a, int len, int q0, int& begin,
                                         int& end) {
  end = len;
  if (a.causal) end = min(end, min(q0 + BT, a.Sq));
  begin = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  begin -= begin % BT;
}

// acc[i][j] = sum_c A[r_i][c] B[c_j][c], rows r_i = rg + 16i of A and
// c_j = cg + 16j of B, both tiles of D columns at pitch D + 1.
template <int D, int RI, int CJ>
__device__ __forceinline__ void tile_dot(float (&acc)[RI][CJ], const float* A, const float* B,
                                         int rg, int cg) {
  constexpr int LD = D + 1;
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int c = 0; c < D; ++c) {
    float x[RI], y[CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i) x[i] = A[(rg + 16 * i) * LD + c];
#pragma unroll
    for (int j = 0; j < CJ; ++j) y[j] = B[(cg + 16 * j) * LD + c];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
  }
}

// acc[i][j] += sum_n A(r_i, n) B[n][c_j] over N rows of B (pitch D + 1):
// A(r, n) = A[n * LDA + r] when TRANS (a tile stored query-major read
// key-major), else A[r * LDA + n].
template <int D, int RI, int N, int LDA, bool TRANS>
__device__ __forceinline__ void tile_acc(float (&acc)[RI][D / 16], const float* A,
                                         const float* B, int rg, int cg) {
  constexpr int LD = D + 1;
#pragma unroll 4
  for (int n = 0; n < N; ++n) {
    float x[RI], y[D / 16];
#pragma unroll
    for (int i = 0; i < RI; ++i) x[i] = TRANS ? A[n * LDA + rg + 16 * i] : A[(rg + 16 * i) * LDA + n];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) y[j] = B[n * LD + cg + 16 * j];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
  }
}

// Reductions over the 16 lanes that share a row group.
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// dS of one score: P (dP - D), times the softcap's derivative; 0 if masked.
// `s` is the raw product q.k, `p` gets P.
__device__ __forceinline__ float grad_score(const BwdArgs& a, bool ok, float s, float dp,
                                            float lse, float dlt, float& p) {
  if (!ok) {
    p = 0.f;
    return 0.f;
  }
  const float sc = softcap_f(s * a.sm_scale, a.softcap);
  p = expf(sc - lse);
  float ds = p * (dp - dlt);
  if (a.softcap > 0.f) {
    const float t = sc / a.softcap;
    ds *= 1.f - t * t;
  }
  return ds;
}

// ---- pass 1: each row's log-sum-exp and D ----
template <typename T, int D>
__global__ void __launch_bounds__(NTF) bwd_stats_kernel(BwdArgs a) {
  constexpr int BT = Tiles<D>::B, LD = D + 1, R = BT / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sO = sQ + BT * LD;
  float* sK = sO + BT * LD;
  float* sV = sK + BT * LD;
  const int q0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.K), rg = threadIdx.x >> 4, cg = threadIdx.x & 15;
  const int len = a.lengths ? min(a.lengths[b], a.Skv) : a.Skv;
  load_tile<T, D, LD, NTF>(sQ, at<T>(a, TQ, a.q, b, h), a.st[3 * TQ + 2], q0, BT, a.Sq);
  load_tile<T, D, LD, NTF>(sO, at<T>(a, TDO, a.dout, b, h), a.st[3 * TDO + 2], q0, BT, a.Sq);
  const T* Kp = at<T>(a, TK, a.k, b, kvh);
  const T* Vp = at<T>(a, TV, a.v, b, kvh);

  float m[R], l[R], acc[R];
#pragma unroll
  for (int i = 0; i < R; ++i) m[i] = kNegInf, l[i] = 0.f, acc[i] = 0.f;
  int kb, ke;
  kv_range<BT>(a, len, q0, kb, ke);
  for (int k0 = kb; k0 < ke; k0 += BT) {
    __syncthreads();
    load_tile<T, D, LD, NTF>(sK, Kp, a.st[3 * TK + 2], k0, BT, a.Skv);
    load_tile<T, D, LD, NTF>(sV, Vp, a.st[3 * TV + 2], k0, BT, a.Skv);
    __syncthreads();
    float s[R][R], dp[R][R];
    tile_dot<D>(s, sQ, sK, rg, cg);
    tile_dot<D>(dp, sO, sV, rg, cg);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qi = q0 + rg + 16 * i;
      bool ok[R];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        ok[j] = live(a, len, qi, k0 + cg + 16 * j);
        s[i][j] = softcap_f(s[i][j] * a.sm_scale, a.softcap);
        if (ok[j]) mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f, sd = 0.f;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += p;
        sd = fmaf(p, dp[i][j], sd);
      }
      l[i] = l[i] * alpha + row_sum(sum);
      acc[i] = acc[i] * alpha + row_sum(sd);
      m[i] = m_new;
    }
  }
  if (cg == 0) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qi = q0 + rg + 16 * i;
      if (qi >= a.Sq) continue;
      const int64_t row = ((int64_t)b * a.H + h) * a.Sq + qi;
      a.lse[row] = l[i] > 0.f ? m[i] + logf(l[i]) : kNoKey;
      a.delta[row] = l[i] > 0.f ? acc[i] / l[i] : 0.f;
    }
  }
}

// Rows q0.. of lse and D into shared memory (0 past Sq).
template <int BT>
__device__ __forceinline__ void load_stats(const BwdArgs& a, float* sL, float* sD, int b,
                                           int h, int q0) {
  for (int r = threadIdx.x; r < BT; r += NTF) {
    const int64_t row = ((int64_t)b * a.H + h) * a.Sq + q0 + r;
    const bool in = q0 + r < a.Sq;
    sL[r] = in ? a.lse[row] : kNoKey;
    sD[r] = in ? a.delta[row] : 0.f;
  }
}

// ---- pass 2: dQ ----
template <typename T, int D>
__global__ void __launch_bounds__(NTF) bwd_dq_kernel(BwdArgs a) {
  constexpr int BT = Tiles<D>::B, LD = D + 1, LDS = BT + 1, R = BT / 16, C = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sO = sQ + BT * LD;
  float* sK = sO + BT * LD;
  float* sV = sK + BT * LD;
  float* sS = sV + BT * LD;
  float* sL = sS + BT * LDS;
  float* sD = sL + BT;
  const int q0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.K), rg = threadIdx.x >> 4, cg = threadIdx.x & 15;
  const int len = a.lengths ? min(a.lengths[b], a.Skv) : a.Skv;
  load_tile<T, D, LD, NTF>(sQ, at<T>(a, TQ, a.q, b, h), a.st[3 * TQ + 2], q0, BT, a.Sq);
  load_tile<T, D, LD, NTF>(sO, at<T>(a, TDO, a.dout, b, h), a.st[3 * TDO + 2], q0, BT, a.Sq);
  load_stats<BT>(a, sL, sD, b, h, q0);
  const T* Kp = at<T>(a, TK, a.k, b, kvh);
  const T* Vp = at<T>(a, TV, a.v, b, kvh);

  float acc[R][C];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) acc[i][j] = 0.f;
  int kb, ke;
  kv_range<BT>(a, len, q0, kb, ke);
  for (int k0 = kb; k0 < ke; k0 += BT) {
    __syncthreads();  // the previous tile's sK and sS are no longer read
    load_tile<T, D, LD, NTF>(sK, Kp, a.st[3 * TK + 2], k0, BT, a.Skv);
    load_tile<T, D, LD, NTF>(sV, Vp, a.st[3 * TV + 2], k0, BT, a.Skv);
    __syncthreads();
    float s[R][R], dp[R][R];
    tile_dot<D>(s, sQ, sK, rg, cg);
    tile_dot<D>(dp, sO, sV, rg, cg);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = rg + 16 * i;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int c = cg + 16 * j;
        float p;
        sS[r * LDS + c] = grad_score(a, live(a, len, q0 + r, k0 + c), s[i][j], dp[i][j],
                                     sL[r], sD[r], p);
      }
    }
    __syncthreads();
    tile_acc<D, R, BT, LDS, false>(acc, sS, sK, rg, cg);
  }
  T* dQ = at<T>(a, TDQ, a.dq, b, h);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qi = q0 + rg + 16 * i;
    if (qi >= a.Sq) continue;
#pragma unroll
    for (int j = 0; j < C; ++j)
      dQ[qi * a.st[3 * TDQ + 2] + cg + 16 * j] = from_f<T>(acc[i][j] * a.sm_scale);
  }
}

// ---- pass 3: dK and dV, the G query heads of a kv head summed in the block ----
template <typename T, int D>
__global__ void __launch_bounds__(NTF) bwd_dkv_kernel(BwdArgs a) {
  constexpr int BT = Tiles<D>::B, LD = D + 1, LDS = BT + 1, R = BT / 16, C = D / 16;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + BT * LD;
  float* sQ = sV + BT * LD;
  float* sO = sQ + BT * LD;
  float* sP = sO + BT * LD;
  float* sS = sP + BT * LDS;
  float* sL = sS + BT * LDS;
  float* sD = sL + BT;
  const int k0 = blockIdx.x * BT, kvh = blockIdx.y, b = blockIdx.z, G = a.H / a.K;
  const int rg = threadIdx.x >> 4, cg = threadIdx.x & 15;
  const int len = a.lengths ? min(a.lengths[b], a.Skv) : a.Skv;
  load_tile<T, D, LD, NTF>(sK, at<T>(a, TK, a.k, b, kvh), a.st[3 * TK + 2], k0, BT, a.Skv);
  load_tile<T, D, LD, NTF>(sV, at<T>(a, TV, a.v, b, kvh), a.st[3 * TV + 2], k0, BT, a.Skv);

  float ak[R][C], av[R][C];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) ak[i][j] = av[i][j] = 0.f;
  // the query rows that can see a live key of this tile: qi >= kj when
  // causal, qi < kj + window when windowed
  int qb = 0, qe = k0 < len ? a.Sq : 0;
  if (a.causal) qb = k0 - k0 % BT;
  if (a.window > 0) qe = min(qe, min(k0 + BT, len) - 1 + a.window);
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const T* Qp = at<T>(a, TQ, a.q, b, h);
    const T* Op = at<T>(a, TDO, a.dout, b, h);
    for (int q0 = qb; q0 < qe; q0 += BT) {
      __syncthreads();  // the previous tile's sQ, sO, sP and sS are no longer read
      load_tile<T, D, LD, NTF>(sQ, Qp, a.st[3 * TQ + 2], q0, BT, a.Sq);
      load_tile<T, D, LD, NTF>(sO, Op, a.st[3 * TDO + 2], q0, BT, a.Sq);
      load_stats<BT>(a, sL, sD, b, h, q0);
      __syncthreads();
      float s[R][R], dp[R][R];
      tile_dot<D>(s, sQ, sK, rg, cg);
      tile_dot<D>(dp, sO, sV, rg, cg);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int r = rg + 16 * i;
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int c = cg + 16 * j;
          float p;
          sS[r * LDS + c] = grad_score(a, live(a, len, q0 + r, k0 + c), s[i][j], dp[i][j],
                                       sL[r], sD[r], p);
          sP[r * LDS + c] = p;
        }
      }
      __syncthreads();
      tile_acc<D, R, BT, LDS, true>(av, sP, sO, rg, cg);
      tile_acc<D, R, BT, LDS, true>(ak, sS, sQ, rg, cg);
    }
  }
  T* dK = at<T>(a, TDK, a.dk, b, kvh);
  T* dV = at<T>(a, TDV, a.dv, b, kvh);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int kj = k0 + rg + 16 * i;
    if (kj >= a.Skv) continue;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      dK[kj * a.st[3 * TDK + 2] + cg + 16 * j] = from_f<T>(ak[i][j] * a.sm_scale);
      dV[kj * a.st[3 * TDV + 2] + cg + 16 * j] = from_f<T>(av[i][j]);
    }
  }
}

// ---- bf16: two kernels on wgmma fed by TMA (see the notes at the top) ----

using bf16 = __nv_bfloat16;
constexpr int WG_ROWS = 64;           // rows (queries or keys) of a consumer warpgroup
constexpr int WG_THREADS = 3 * 128;   // two consumer warpgroups and the producer's
constexpr int STAGES = 3;             // tiles in the ring
constexpr int PINGPONG = 1;           // named barriers 1 and 2: warpgroup 0's, 1's turn
constexpr int OWN_BAR = 3;            // 3 and 4: each consumer warpgroup's own
// rows of the lse and D of a head, padded to a multiple of K1's 128-row
// blocks (its forward writes lse to the pitch)
constexpr int kStatsRows = 128;

// The dQ kernel: a block owns BQ query rows of one (b, head), 64 a consumer
// warpgroup; K and V tiles of BKV keys through the ring (32 at d = 256,
// where dQ's 128 registers a thread leave room for no more scores).
template <int D>
struct DqTiles {
  static constexpr int BQ = 2 * WG_ROWS;
  static constexpr int BKV = D == 256 ? 32 : 64;
  static constexpr int Q_BYTES = BQ * D * 2;    // Q, and dO: D / 64 boxes of BQ rows
  static constexpr int KV_BYTES = BKV * D * 2;  // a K or a V tile: D / 64 boxes of BKV rows
  static constexpr int SMEM =
      1024 + 2 * Q_BYTES + 2 * STAGES * KV_BYTES + 4 * BQ + 8 * (1 + 2 * STAGES);
};

// The dK/dV kernel: a block owns BKV keys of one (b, kv head); Q and dO
// tiles of BQ rows, with their lse and D, through the ring (32 at d = 256,
// where dK's 128 registers a thread leave room for no more).  At d = 64
// each consumer warpgroup owns 64 keys and sums their dK and dV (d
// registers a thread); from d = 128 that cannot fit beside the scores, and
// both warpgroups read the same 64 keys (SPLIT), warpgroup 0 summing dV and
// 1 dK.
template <int D>
struct DkvTiles {
  static constexpr bool SPLIT = D != 64;
  static constexpr int BKV = D == 64 ? 128 : 64;
  static constexpr int BQ = D == 256 ? 32 : 64;
  static constexpr int KV_BYTES = BKV * D * 2;  // K, and V
  static constexpr int Q_BYTES = BQ * D * 2;    // a Q or a dO tile
  static constexpr int SMEM =
      1024 + 2 * KV_BYTES + STAGES * (2 * Q_BYTES + 2 * BQ * 4) + 8 * (1 + 2 * STAGES);
};

// Every pair among queries [q0, q0 + nq) and keys [k0, k0 + nk) live.
__device__ __forceinline__ bool all_live(const BwdArgs& a, int len, int q0, int nq, int k0,
                                         int nk) {
  return q0 + nq <= a.Sq && k0 + nk <= len && (!a.causal || k0 + nk - 1 <= q0) &&
         (a.window <= 0 || k0 > q0 + nq - 1 - a.window);
}

// t = tanh(x / cap) of a scaled score x under a softcap (1 / cap given):
// the capped score is cap·t and its derivative 1 - t².
__device__ __forceinline__ float cap_t(float x, float inv_cap) {
#if PARITY_IEEE_EXP
  return tanhf(x * inv_cap);
#else
  return 1.f - __fdividef(2.f, __expf(2.f * x * inv_cap) + 1.f);
#endif
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

__device__ __forceinline__ void own_sync(int wg) {  // one consumer warpgroup's 128 threads
  asm volatile("bar.sync %0, 128;\n" ::"r"(OWN_BAR + wg) : "memory");
}
// The ping-pong's turns: wait for this warpgroup's, hand over the other's.
__device__ __forceinline__ void turn_wait(int wg) { named_sync(PINGPONG + wg); }
__device__ __forceinline__ void turn_give(int wg) { named_arrive(PINGPONG + 1 - wg); }

// Exponents in the units of kExpScale: base 2 for the fast exponential, so
// that log2 e, folded into the scale, the cap and the lse, costs nothing an
// entry (one FMA, then ex2); natural for the IEEE one.
constexpr float kExpScale = PARITY_IEEE_EXP ? 1.f : 1.4426950408889634f;
__device__ __forceinline__ float exp_x(float x) {
#if PARITY_IEEE_EXP
  return expf(x);
#else
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
#endif
}

// X = A·Bᵀ over the D columns for one warpgroup: A its 64 rows from `a` of
// a tile stored as D / 64 boxes of AROWS rows, B the N rows of `b` stored as
// boxes of N rows (both K-major, in the 128-byte swizzle TMA writes), in
// chains of PARITY_QK_CHAIN k16 steps, each from zero: the first into x, a
// second (where the chain is shorter than D / 16) into u, which the caller
// adds to x once the group has retired.  Issued into the caller's group.
template <int D, int N, int AROWS>
__device__ __forceinline__ void ss_issue(float (&x)[N / 2], float (&u)[N / 2], const uint8_t* a,
                                         const uint8_t* b) {
  constexpr int KS = D / 16, C = KS < PARITY_QK_CHAIN ? KS : PARITY_QK_CHAIN;
  static_assert(KS <= 2 * C, "at most two chains");
  // A's descriptors are hidden from the compiler, so that it does not keep
  // all D / 16 of them (loop-invariant) in registers
  uint64_t da = kmajor_desc(a);
  const uint64_t db = kmajor_desc(b);
  asm volatile("" : "+l"(da));
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const uint64_t xa = da + (kk / 4) * AROWS * 128 / 16 + 2 * (kk % 4);
    const uint64_t xb = db + (kk / 4) * N * 128 / 16 + 2 * (kk % 4);
    if (kk < C) {
      wgmma_ss<N>(x, xa, xb, kk > 0);
    } else {
      wgmma_ss<N>(u, xa, xb, kk > C);
    }
  }
}

// The second chain's sums into the first, once the group has retired.
template <int D, int N>
__device__ __forceinline__ void ss_finish(float (&x)[N / 2], float (&u)[N / 2]) {
  fence_regs(x);
  if constexpr (D / 16 > PARITY_QK_CHAIN) {
    fence_regs(u);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) x[i] += u[i];
  }
}

// acc += A·B for one warpgroup: A from registers, pa[j] the fragments of
// its k16 step j in NP bf16 parts (smallest first), B the NK rows (the
// reduced dimension) of a tile stored as D / 64 boxes of NK rows, read
// MN-major; acc[c] holds columns 64c..64c+63.  PARITY_BWD_FRESH = F > 0:
// for each 64-column slice, chains of F k16 steps (their parts chained)
// summed from zero in t, one group each, added to acc in IEEE fp32 once it
// retires; the last group is left in flight for rs_finish.  F = 0: every
// step chained into acc in one group.
template <int D, int NK>
__device__ __forceinline__ void rs_issue(float (&acc)[D / 64][32],
                                         const uint32_t (&pa)[NK / 16][PARITY_BWD_PARTS][4],
                                         float (&t)[32], const uint8_t* b) {
  constexpr int KS = NK / 16, NS = D / 64, NP = PARITY_BWD_PARTS;
  if constexpr (PARITY_BWD_FRESH > 0) {
    constexpr int F = PARITY_BWD_FRESH < KS ? PARITY_BWD_FRESH : KS;  // k16 steps a chain
    static_assert(KS % F == 0, "whole chains a tile");
#pragma unroll
    for (int c = 0; c < KS / F; ++c) {
#pragma unroll
      for (int sl = 0; sl < NS; ++sl) {
        wgmma_fence();
#pragma unroll
        for (int j = c * F; j < (c + 1) * F; ++j)
#pragma unroll
          for (int i = 0; i < NP; ++i)
            wgmma_rs<64>(t, pa[j][i], mn_desc(b + sl * NK * 128 + j * 2048), j > c * F || i > 0);
        wgmma_commit();
        fence_regs(t);
        if (c < KS / F - 1 || sl < NS - 1) {
          wgmma_wait<0>();
          fence_regs(t);
#pragma unroll
          for (int i = 0; i < 32; ++i) acc[sl][i] += t[i];
        }
      }
    }
  } else {
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < KS; ++j)
#pragma unroll
      for (int sl = 0; sl < NS; ++sl)
#pragma unroll
        for (int i = 0; i < NP; ++i)
          wgmma_rs<64>(acc[sl], pa[j][i], mn_desc(b + sl * NK * 128 + j * 2048), 1);
    wgmma_commit();
    fence_regs(acc);
  }
}

// Once rs_issue's groups have retired: the last fresh group's sums (the
// last slice's), or the chained sums in acc pinned after the wait.
template <int D>
__device__ __forceinline__ void rs_finish(float (&acc)[D / 64][32], float (&t)[32]) {
  if constexpr (PARITY_BWD_FRESH > 0) {
    fence_regs(t);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[D / 64 - 1][i] += t[i];
  } else {
    fence_regs(acc);
  }
}

// A warpgroup's N columns of P or dS (the accumulator layout: x[4n + e],
// rows g, g + 8 for e / 2 = 0, 1 of columns 8n + 2t4 + e % 2) as the A
// registers of the k16 steps that reduce over those columns, in
// PARITY_BWD_PARTS bf16 parts: step j's rows g, g + 8 of columns 16j +
// 2t4.., then of 16j + 8 + 2t4..
template <int N>
__device__ __forceinline__ void to_parts(const float (&x)[N / 2],
                                         uint32_t (&pa)[N / 16][PARITY_BWD_PARTS][4]) {
#pragma unroll
  for (int j = 0; j < N / 16; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      uint32_t part[PARITY_BWD_PARTS];
      const int i = 8 * j + 4 * (r >> 1) + 2 * (r & 1);
      split_bf16<PARITY_BWD_PARTS>(x[i], x[i + 1], part);
#pragma unroll
      for (int p = 0; p < PARITY_BWD_PARTS; ++p) pa[j][p][r] = part[p];
    }
}

// ---- bf16 kernel 1: D, then dQ (one block per head, b, 128 query rows) ----
template <int D>
__global__ void __launch_bounds__(WG_THREADS, 1)
    bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_o,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v, BwdArgs a) {
  using Tl = DqTiles<D>;
  constexpr int BQ = Tl::BQ, BKV = Tl::BKV, NS = D / 64, KS = BKV / 16, NP = PARITY_BWD_PARTS;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = align1024(smem_raw);
  uint8_t* sO = sQ + Tl::Q_BYTES;               // dO
  uint8_t* sK = sO + Tl::Q_BYTES;               // [STAGES]
  uint8_t* sV = sK + STAGES * Tl::KV_BYTES;     // [STAGES]
  float* sD = reinterpret_cast<float*>(sV + STAGES * Tl::KV_BYTES);  // the block's rows' D
  uint64_t* qbar = reinterpret_cast<uint64_t*>(sD + BQ);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + STAGES;

  // the grid is (H, B, query tiles): every head's longest causal rows first
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int h = blockIdx.x, b = blockIdx.y, kvh = h / (a.H / a.K);
  const int len = max(0, a.lengths ? min(a.lengths[b], a.Skv) : a.Skv);
  // the kv range that can hold a live key for some row of this block
  int ke = len;
  if (a.causal) ke = min(ke, min(q0 + BQ, a.Sq));
  int kb = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  kb -= kb % BKV;
  const int ntiles = kb < ke ? (ke - kb + BKV - 1) / BKV : 0;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one release a consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {  // the producer: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256 && ntiles > 0) {
      mbar_expect_tx(qbar, 2 * Tl::Q_BYTES);
      for (int c = 0; c < NS; ++c) {
        tma_load_4d(sQ + c * BQ * 128, &tm_q, qbar, 64 * c, q0, h, b);
        tma_load_4d(sO + c * BQ * 128, &tm_o, qbar, 64 * c, q0, h, b);
      }
      for (int i = 0; i < ntiles; ++i) {
        const int st = i % STAGES, k0 = kb + i * BKV;
        mbar_wait(&empty[st], ((i / STAGES) & 1) ^ 1);  // the first round passes
        uint8_t* kt = sK + st * Tl::KV_BYTES;
        uint8_t* vt = sV + st * Tl::KV_BYTES;
        mbar_expect_tx(&full[st], 2 * Tl::KV_BYTES);
        for (int c = 0; c < NS; ++c) {
          tma_load_4d(kt + c * BKV * 128, &tm_k, &full[st], 64 * c, k0, kvh, b);
          tma_load_4d(vt + c * BKV * 128, &tm_v, &full[st], 64 * c, k0, kvh, b);
        }
      }
    }
  } else {  // consumers: rows q0 + 64 wg .. + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int r0 = q0 + WG_ROWS * wg;  // this warpgroup's rows
    const int w0 = r0 + 16 * warp;     // this warp's: w0 + g and w0 + g + 8
    const int64_t head = (int64_t)b * a.H + h;

    // D = rowsum(dO ∘ O) over the forward's fp32 output, two threads a
    // row, into sD and the scratch the dK/dV kernel reads (0 past Sq)
    {
      const int r = tid >> 1, half = tid & 1, qi = r0 + r;
      float dot = 0.f;
      if (qi < a.Sq) {
        const bf16* o = at<bf16>(a, TDO, a.dout, b, h) + (int64_t)qi * a.st[3 * TDO + 2] +
                        half * (D / 2);
        const float* o32 = a.o32 + (head * a.Sq + qi) * D + half * (D / 2);
#pragma unroll 4
        for (int c = 0; c < D / 2; c += 8) {
          const uint4 raw = *reinterpret_cast<const uint4*>(o + c);
          const bf16* e = reinterpret_cast<const bf16*>(&raw);
          const float4 x0 = *reinterpret_cast<const float4*>(o32 + c);
          const float4 x1 = *reinterpret_cast<const float4*>(o32 + c + 4);
          const float x[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
          for (int u = 0; u < 8; ++u) dot = fmaf(__bfloat162float(e[u]), x[u], dot);
        }
      }
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      if (half == 0) {  // rows within the pitch, as the forward wrote lse
        sD[WG_ROWS * wg + r] = dot;
        a.delta[head * a.sq_pitch + qi] = dot;
        a.lse_x[head * a.sq_pitch + qi] = a.lse[head * a.sq_pitch + qi] * kExpScale;
      }
      own_sync(wg);
    }
    const float inv_cap = a.softcap > 0.f ? 1.f / a.softcap : 0.f;
    const float scale_x = a.sm_scale * kExpScale, cap_x = a.softcap * kExpScale;
    float lse[2], dl[2];  // lse in the units of kExpScale
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int qi = w0 + g + 8 * hh;
      lse[hh] = a.lse[head * a.sq_pitch + qi] * kExpScale;
      dl[hh] = sD[qi - q0];
    }

    // acc[c][4j + e]: rows g, g + 8 (e / 2) of columns 64c + 8j + 2t4 + e % 2
    float acc[NS][32];
#pragma unroll
    for (int c = 0; c < NS; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;

    if (ntiles > 0) {
      uint32_t pa[KS][NP][4];  // dS of the tile before, in bf16 parts
      const uint8_t* q = sQ + wg * WG_ROWS * 128;
      const uint8_t* o = sO + wg * WG_ROWS * 128;
      // S(n) = Q·K(n)ᵀ and dP(n) = dO·V(n)ᵀ, one group, in this warpgroup's turn
      auto issue_sdp = [&](int n, float (&s)[BKV / 2], float (&u)[BKV / 2],
                           float (&dp)[BKV / 2], float (&w)[BKV / 2]) {
        mbar_wait(&full[n % STAGES], (n / STAGES) & 1);
        turn_wait(wg);
        wgmma_fence();
        ss_issue<D, BKV, BQ>(s, u, q, sK + (n % STAGES) * Tl::KV_BYTES);
        ss_issue<D, BKV, BQ>(dp, w, o, sV + (n % STAGES) * Tl::KV_BYTES);
        wgmma_commit();
        fence_regs(s);
        fence_regs(dp);
        if constexpr (D / 16 > PARITY_QK_CHAIN) {
          fence_regs(u);
          fence_regs(w);
        }
      };
      // S(n) and dP(n) retired: dS = P (dP - D) times the softcap's
      // derivative, in place of S; masked entries 0.  The softcap and the
      // mask are tested once a tile, so that a whole tile without a cap
      // costs an FMA, an exponential, a subtraction and a product an entry.
      auto grad = [&](int n, float (&s)[BKV / 2], float (&u)[BKV / 2], float (&dp)[BKV / 2],
                      float (&w)[BKV / 2]) {
        ss_finish<D, BKV>(s, u);
        ss_finish<D, BKV>(dp, w);
        if (a.softcap > 0.f) {
#pragma unroll
          for (int i = 0; i < BKV / 2; ++i) {
            const int hh = (i >> 1) & 1;
            const float t = cap_t(s[i] * a.sm_scale, inv_cap);
            s[i] = exp_x(fmaf(cap_x, t, -lse[hh])) * (dp[i] - dl[hh]) * (1.f - t * t);
          }
        } else {
#pragma unroll
          for (int i = 0; i < BKV / 2; ++i) {
            const int hh = (i >> 1) & 1;
            s[i] = exp_x(fmaf(s[i], scale_x, -lse[hh])) * (dp[i] - dl[hh]);
          }
        }
        const int k0 = kb + n * BKV;
        if (!all_live(a, len, w0, 16, k0, BKV)) {
#pragma unroll
          for (int i = 0; i < BKV / 2; ++i)
            if (!live(a, len, w0 + g + 8 * ((i >> 1) & 1), k0 + 8 * (i >> 2) + 2 * t4 + (i & 1)))
              s[i] = 0.f;
        }
      };
      auto release = [&](int n) {
        if (lane == 0) mbar_arrive(&empty[n % STAGES]);  // K(n) and V(n) read
      };

      mbar_wait(qbar, 0);
      if (wg == 1) turn_give(wg);  // warpgroup 0 issues first
      {  // tile 0: S(0) and dP(0) alone
        float s[BKV / 2], u[BKV / 2], dp[BKV / 2], w[BKV / 2];
        issue_sdp(0, s, u, dp, w);
        turn_give(wg);  // the other's turn
        wgmma_wait<0>();
        grad(0, s, u, dp, w);
        to_parts<BKV>(s, pa);
      }
      // Tile n: S(n) and dP(n), then dQ += dS(n - 1)·K(n - 1), in this
      // warpgroup's turn; dS(n) is formed while dQ's products retire and
      // the other warpgroup's run.
#pragma unroll 1
      for (int n = 1; n < ntiles; ++n) {
        float s[BKV / 2], u[BKV / 2], dp[BKV / 2], w[BKV / 2], t[32];
        issue_sdp(n, s, u, dp, w);
        rs_issue<D, BKV>(acc, pa, t, sK + ((n - 1) % STAGES) * Tl::KV_BYTES);
        turn_give(wg);
        wgmma_wait<1>();
        grad(n, s, u, dp, w);
        wgmma_wait<0>();
        fence_regs(pa);
        rs_finish<D>(acc, t);
        release(n - 1);
        to_parts<BKV>(s, pa);
      }
      {  // dQ += dS(last)·K(last) alone
        float t[32];
        turn_wait(wg);
        rs_issue<D, BKV>(acc, pa, t, sK + ((ntiles - 1) % STAGES) * Tl::KV_BYTES);
        if (wg == 0) turn_give(wg);
        wgmma_wait<0>();
        rs_finish<D>(acc, t);
        release(ntiles - 1);
      }
    }

    bf16* dQ = at<bf16>(a, TDQ, a.dq, b, h);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int qi = w0 + g + 8 * hh;
      if (qi >= a.Sq) continue;
      bf16* dst = dQ + (int64_t)qi * a.st[3 * TDQ + 2] + 2 * t4;
#pragma unroll
      for (int c = 0; c < NS; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(dst + 64 * c + 8 * j) = __floats2bfloat162_rn(
              acc[c][4 * j + 2 * hh] * a.sm_scale, acc[c][4 * j + 2 * hh + 1] * a.sm_scale);
    }
  }
}

// x if A, else y (an array by reference: the registers stay registers).
template <bool A, typename T>
__device__ __forceinline__ T& pick(T& x, T& y) {
  if constexpr (A) return x;
  else return y;
}

// ---- bf16 kernel 2: dK and dV (one block per kv head, b, BKV keys) ----
// One consumer warpgroup's part, over the tiles the producer brings (each
// head of the group, then its live query tiles): ROLE DV sums dV += Pᵀ·dO,
// DK dK += dSᵀ·Q over the block's 64 keys (SPLIT), BOTH both over this
// warpgroup's 64 keys.  Sᵀ = K·Qᵀ (and dPᵀ = V·dOᵀ) put the keys in the
// rows, so that Pᵀ and dSᵀ come out of the accumulators as the A registers
// of the gradient products; Q and dO are read MN-major.  The role is a
// template parameter: no branch around a wgmma in the loop.
enum { DV = 0, DK = 1, BOTH = 2 };

template <int D, int ROLE>
__device__ __forceinline__ void dkv_consumer(const BwdArgs& a, const uint8_t* sK,
                                             const uint8_t* sV, const uint8_t* sQ,
                                             const uint8_t* sO, const float* sStat,
                                             uint64_t* full, uint64_t* empty, uint64_t* kvbar,
                                             int b, int kvh, int k0, int len, int qb, int nq,
                                             int ntiles) {
  using Tl = DkvTiles<D>;
  constexpr int BQ = Tl::BQ, NS = D / 64, KS = BQ / 16, NP = PARITY_BWD_PARTS;
  constexpr bool WANT_DS = ROLE != DV, WANT_P = ROLE != DK;
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = ROLE == BOTH ? WG_ROWS * wg : 0;  // this warpgroup's keys in the block
  const int kw = k0 + r0 + 16 * warp;              // this warp's: kw + g and kw + g + 8
  const uint8_t* k_rows = sK + r0 * 128;
  const uint8_t* v_rows = sV + r0 * 128;
  const float inv_cap = a.softcap > 0.f ? 1.f / a.softcap : 0.f;
  const float scale_x = a.sm_scale * kExpScale, cap_x = a.softcap * kExpScale;

  // acc_v: dV (DV, BOTH); acc_k: dK (DK, BOTH); acc[c][4j + e] rows g, g + 8
  // (e / 2) of columns 64c + 8j + 2t4 + e % 2
  float acc_v[WANT_P ? NS : 1][32], acc_k[WANT_DS ? NS : 1][32];
#pragma unroll
  for (int c = 0; c < (WANT_P ? NS : 1); ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc_v[c][i] = 0.f;
#pragma unroll
  for (int c = 0; c < (WANT_DS ? NS : 1); ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc_k[c][i] = 0.f;

  if (ntiles > 0) {
    // Pᵀ and dSᵀ of the tile before, in bf16 parts
    uint32_t pa_p[WANT_P ? KS : 1][NP][4], pa_ds[WANT_DS ? KS : 1][NP][4];
    auto issue_s = [&](int i, float (&s)[BQ / 2], float (&u)[BQ / 2], float (&dp)[BQ / 2],
                       float (&w)[BQ / 2]) {
      const int st = i % STAGES;
      mbar_wait(&full[st], (i / STAGES) & 1);
      turn_wait(wg);
      wgmma_fence();
      ss_issue<D, BQ, Tl::BKV>(s, u, k_rows, sQ + st * Tl::Q_BYTES);
      if constexpr (WANT_DS) ss_issue<D, BQ, Tl::BKV>(dp, w, v_rows, sO + st * Tl::Q_BYTES);
      wgmma_commit();
      fence_regs(s);
      if constexpr (WANT_DS) fence_regs(dp);
      if constexpr (D / 16 > PARITY_QK_CHAIN) {
        fence_regs(u);
        if constexpr (WANT_DS) fence_regs(w);
      }
    };
    // Sᵀ(i) (and dPᵀ(i)) retired: Pᵀ in place of Sᵀ and dSᵀ = Pᵀ (dPᵀ -
    // D) times the softcap's derivative in place of dPᵀ (DK: in place of
    // Sᵀ); masked entries 0.  The softcap and the mask are tested once a
    // tile, as in the dQ kernel.
    auto grad = [&](int i, float (&s)[BQ / 2], float (&u)[BQ / 2], float (&dp)[BQ / 2],
                    float (&w)[BQ / 2]) {
      ss_finish<D, BQ>(s, u);
      if constexpr (WANT_DS) ss_finish<D, BQ>(dp, w);
      const int st = i % STAGES, q0 = qb + (i % nq) * BQ;
      const float* L = sStat + st * 2 * BQ;  // this tile's lse (kExpScale's units), then D
      auto& ds = pick<ROLE == DK>(s, dp);
      if (a.softcap > 0.f) {
#pragma unroll
        for (int e = 0; e < BQ / 2; ++e) {
          const int c = 8 * (e >> 2) + 2 * t4 + (e & 1);  // the query column
          const float t = cap_t(s[e] * a.sm_scale, inv_cap);
          const float p = exp_x(fmaf(cap_x, t, -L[c]));
          if constexpr (WANT_DS) ds[e] = p * (dp[e] - L[BQ + c]) * (1.f - t * t);
          if constexpr (WANT_P) s[e] = p;
        }
      } else {
#pragma unroll
        for (int e = 0; e < BQ / 2; ++e) {
          const int c = 8 * (e >> 2) + 2 * t4 + (e & 1);
          const float p = exp_x(fmaf(s[e], scale_x, -L[c]));
          if constexpr (WANT_DS) ds[e] = p * (dp[e] - L[BQ + c]);
          if constexpr (WANT_P) s[e] = p;
        }
      }
      if (!all_live(a, len, q0, BQ, kw, 16)) {
#pragma unroll
        for (int e = 0; e < BQ / 2; ++e)
          if (!live(a, len, q0 + 8 * (e >> 2) + 2 * t4 + (e & 1), kw + g + 8 * ((e >> 1) & 1))) {
            if constexpr (WANT_P) s[e] = 0.f;
            if constexpr (WANT_DS) ds[e] = 0.f;
          }
      }
    };
    // the entries into bf16 parts, once the products reading the last ones
    // have retired
    auto parts = [&](float (&s)[BQ / 2], float (&dp)[BQ / 2]) {
      if constexpr (WANT_P) to_parts<BQ>(s, pa_p);
      if constexpr (WANT_DS) to_parts<BQ>(pick<ROLE == DK>(s, dp), pa_ds);
    };
    // dV += Pᵀ·dO(i) and/or dK += dSᵀ·Q(i): one group each
    auto issue_grad = [&](int i, float (&t)[32], float (&t2)[32]) {
      if constexpr (WANT_P) rs_issue<D, BQ>(acc_v, pa_p, t, sO + (i % STAGES) * Tl::Q_BYTES);
      if constexpr (WANT_DS) rs_issue<D, BQ>(acc_k, pa_ds, t2, sQ + (i % STAGES) * Tl::Q_BYTES);
    };
    auto finish_grad = [&](float (&t)[32], float (&t2)[32]) {
      if constexpr (WANT_P) rs_finish<D>(acc_v, t);
      if constexpr (WANT_DS) rs_finish<D>(acc_k, t2);
    };
    auto release = [&](int i) {
      if (lane == 0) mbar_arrive(&empty[i % STAGES]);  // the stage's tiles read
    };

    mbar_wait(kvbar, 0);
    if (wg == 1) turn_give(wg);  // warpgroup 0 issues first
    {  // tile 0: the scores alone
      float s[BQ / 2], u[BQ / 2], dp[BQ / 2], w[BQ / 2];
      issue_s(0, s, u, dp, w);
      turn_give(wg);
      wgmma_wait<0>();
      grad(0, s, u, dp, w);
      parts(s, dp);
    }
    // Tile i: the scores of i, then the gradient products of i - 1, in this
    // warpgroup's turn; tile i's entries are formed while those retire and
    // the other warpgroup's run.
#pragma unroll 1
    for (int i = 1; i < ntiles; ++i) {
      float s[BQ / 2], u[BQ / 2], dp[BQ / 2], w[BQ / 2], t[32], t2[32];
      issue_s(i, s, u, dp, w);
      issue_grad(i - 1, t, t2);
      turn_give(wg);
      wgmma_wait<ROLE == BOTH ? 2 : 1>();  // the scores' group retired
      grad(i, s, u, dp, w);
      wgmma_wait<0>();
      if constexpr (WANT_P) fence_regs(pa_p);
      if constexpr (WANT_DS) fence_regs(pa_ds);
      finish_grad(t, t2);
      release(i - 1);
      parts(s, dp);
    }
    {  // the gradient products of the last tile alone
      float t[32], t2[32];
      turn_wait(wg);
      issue_grad(ntiles - 1, t, t2);
      if (wg == 0) turn_give(wg);
      wgmma_wait<0>();
      finish_grad(t, t2);
      release(ntiles - 1);
    }
  }

  auto store = [&](int tt, const float (&acc)[NS][32], float scale) {
    bf16* base = at<bf16>(a, tt, tt == TDK ? a.dk : a.dv, b, kvh);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int kj = kw + g + 8 * hh;
      if (kj >= a.Skv) continue;
      bf16* dst = base + (int64_t)kj * a.st[3 * tt + 2] + 2 * t4;
#pragma unroll
      for (int c = 0; c < NS; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(dst + 64 * c + 8 * j) = __floats2bfloat162_rn(
              acc[c][4 * j + 2 * hh] * scale, acc[c][4 * j + 2 * hh + 1] * scale);
    }
  };
  if constexpr (WANT_P) store(TDV, acc_v, 1.f);
  if constexpr (WANT_DS) store(TDK, acc_k, a.sm_scale);
}

template <int D>
__global__ void __launch_bounds__(WG_THREADS, 1)
    bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_o,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v, BwdArgs a) {
  using Tl = DkvTiles<D>;
  constexpr int BQ = Tl::BQ, BKV = Tl::BKV, NS = D / 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sK = align1024(smem_raw);
  uint8_t* sV = sK + Tl::KV_BYTES;
  uint8_t* sQ = sV + Tl::KV_BYTES;              // [STAGES]
  uint8_t* sO = sQ + STAGES * Tl::Q_BYTES;      // [STAGES] dO
  float* sStat = reinterpret_cast<float*>(sO + STAGES * Tl::Q_BYTES);  // [STAGES][lse, D][BQ]
  uint64_t* kvbar = reinterpret_cast<uint64_t*>(sStat + STAGES * 2 * BQ);
  uint64_t* full = kvbar + 1;
  uint64_t* empty = full + STAGES;

  // the grid is (K, B, kv tiles): every head's first (under causality the
  // longest) tiles first
  const int k0 = blockIdx.z * BKV, kvh = blockIdx.x, b = blockIdx.y, G = a.H / a.K;
  const int len = max(0, a.lengths ? min(a.lengths[b], a.Skv) : a.Skv);
  // the query rows that can see a live key of this block: qi >= kj when
  // causal, qi < kj + window when windowed
  int qb = 0, qe = k0 < len ? a.Sq : 0;
  if (a.causal) qb = k0 - k0 % BQ;
  if (a.window > 0) qe = min(qe, min(k0 + BKV, len) - 1 + a.window);
  const int nq = qb < qe ? (qe - qb + BQ - 1) / BQ : 0;
  const int ntiles = G * nq;  // head kvh·G + i / nq, its query tile i % nq
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(kvbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256 && ntiles > 0) {
      mbar_expect_tx(kvbar, 2 * Tl::KV_BYTES);
      for (int c = 0; c < NS; ++c) {
        tma_load_4d(sK + c * BKV * 128, &tm_k, kvbar, 64 * c, k0, kvh, b);
        tma_load_4d(sV + c * BKV * 128, &tm_v, kvbar, 64 * c, k0, kvh, b);
      }
      for (int i = 0; i < ntiles; ++i) {
        const int st = i % STAGES, h = kvh * G + i / nq, q0 = qb + (i % nq) * BQ;
        mbar_wait(&empty[st], ((i / STAGES) & 1) ^ 1);
        uint8_t* qt = sQ + st * Tl::Q_BYTES;
        uint8_t* ot = sO + st * Tl::Q_BYTES;
        float* lt = sStat + st * 2 * BQ;
        const int64_t row = ((int64_t)b * a.H + h) * a.sq_pitch + q0;  // within the pitch
        mbar_expect_tx(&full[st], 2 * Tl::Q_BYTES + 2 * BQ * 4);
        for (int c = 0; c < NS; ++c) {
          tma_load_4d(qt + c * BQ * 128, &tm_q, &full[st], 64 * c, q0, h, b);
          tma_load_4d(ot + c * BQ * 128, &tm_o, &full[st], 64 * c, q0, h, b);
        }
        bulk_load(lt, a.lse_x + row, BQ * 4, &full[st]);
        bulk_load(lt + BQ, a.delta + row, BQ * 4, &full[st]);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    if constexpr (!Tl::SPLIT)
      dkv_consumer<D, BOTH>(a, sK, sV, sQ, sO, sStat, full, empty, kvbar, b, kvh, k0, len, qb,
                            nq, ntiles);
    else if (wg == 0)
      dkv_consumer<D, DV>(a, sK, sV, sQ, sO, sStat, full, empty, kvbar, b, kvh, k0, len, qb, nq,
                          ntiles);
    else
      dkv_consumer<D, DK>(a, sK, sV, sQ, sO, sStat, full, empty, kvbar, b, kvh, k0, len, qb, nq,
                          ntiles);
  }
}

// ---- launches ----

template <int D>
constexpr size_t tile_floats() { return (size_t)Tiles<D>::B * (D + 1); }
template <int D>
constexpr size_t score_floats() { return (size_t)Tiles<D>::B * (Tiles<D>::B + 1); }

template <typename K>
cudaError_t launch(K kernel, dim3 grid, int threads, size_t smem, const BwdArgs& a,
                   cudaStream_t stream) {
  if (grid.x * grid.y * grid.z == 0) return cudaSuccess;  // nothing to compute
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const BwdArgs& a, int B, cudaStream_t stream) {
  constexpr int BT = Tiles<D>::B;
  const dim3 q_grid((a.Sq + BT - 1) / BT, a.H, B);
  const dim3 kv_grid((a.Skv + BT - 1) / BT, a.K, B);
  cudaError_t err = launch(bwd_stats_kernel<float, D>, q_grid, NTF,
                           4 * tile_floats<D>() * sizeof(float), a, stream);
  if (err != cudaSuccess) return err;
  err = launch(bwd_dq_kernel<float, D>, q_grid, NTF,
               (4 * tile_floats<D>() + score_floats<D>() + 2 * BT) * sizeof(float), a, stream);
  if (err != cudaSuccess) return err;
  return launch(bwd_dkv_kernel<float, D>, kv_grid, NTF,
                (4 * tile_floats<D>() + 2 * score_floats<D>() + 2 * BT) * sizeof(float), a,
                stream);
}

// The maps of tensor t (q, dout: H heads of Sq rows; k, v: K of Skv) in
// boxes of `rows` rows.
bool map_of(CUtensorMap* map, const BwdArgs& a, int t, int D, int B, int rows) {
  const void* ptr = t == TQ ? a.q : t == TK ? a.k : t == TV ? a.v : a.dout;
  const bool kv = t == TK || t == TV;
  return head_map(map, ptr, D, kv ? a.Skv : a.Sq, kv ? a.K : a.H, B, a.st[3 * t + 2],
                  a.st[3 * t + 1], a.st[3 * t], rows);
}

template <int D>
cudaError_t launch_bf16(const BwdArgs& a, int B, cudaStream_t stream) {
  using QT = DqTiles<D>;
  using KT = DkvTiles<D>;
  static_assert(kStatsRows % QT::BQ == 0 && kStatsRows % KT::BQ == 0, "stats pitch");
  static_assert(QT::SMEM <= 232448 && KT::SMEM <= 232448, "shared memory of a block");
  static const cudaError_t attr = [] {
    cudaError_t err = cudaFuncSetAttribute(
        bwd_dq_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, QT::SMEM);
    return err != cudaSuccess ? err : cudaFuncSetAttribute(
        bwd_dkv_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, KT::SMEM);
  }();
  if (attr != cudaSuccess) return attr;
  if (a.Sq == 0 || a.Skv == 0 || B == 0) return cudaSuccess;  // nothing to compute
  CUtensorMap tq, to, tk, tv;
  if (!map_of(&tq, a, TQ, D, B, QT::BQ) || !map_of(&to, a, TDO, D, B, QT::BQ) ||
      !map_of(&tk, a, TK, D, B, QT::BKV) || !map_of(&tv, a, TV, D, B, QT::BKV))
    return cudaErrorInvalidValue;
  bwd_dq_wgmma_kernel<D><<<dim3(a.H, B, (a.Sq + QT::BQ - 1) / QT::BQ), WG_THREADS, QT::SMEM,
                           stream>>>(tq, to, tk, tv, a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (!map_of(&tq, a, TQ, D, B, KT::BQ) || !map_of(&to, a, TDO, D, B, KT::BQ) ||
      !map_of(&tk, a, TK, D, B, KT::BKV) || !map_of(&tv, a, TV, D, B, KT::BKV))
    return cudaErrorInvalidValue;
  bwd_dkv_wgmma_kernel<D><<<dim3(a.K, B, (a.Skv + KT::BKV - 1) / KT::BKV), WG_THREADS,
                            KT::SMEM, stream>>>(tq, to, tk, tv, a);
  return cudaGetLastError();
}

cudaError_t launch_d(const BwdArgs& a, int B, int d, int dtype, cudaStream_t stream) {
  if (dtype == 0) {
    switch (d) {
      case 64: return launch_f32<64>(a, B, stream);
      case 128: return launch_f32<128>(a, B, stream);
      case 256: return launch_f32<256>(a, B, stream);
    }
  } else if (dtype == 1) {
    switch (d) {
      case 64: return launch_bf16<64>(a, B, stream);
      case 128: return launch_bf16<128>(a, B, stream);
      case 256: return launch_bf16<256>(a, B, stream);
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace repro_torch

// strides: 21 element strides (b, head, seq) of q, k, v, dout, dq, dk, dv in
// that order; head dimensions contiguous and rows 16-byte aligned.  scratch:
// (2, B, H, ceil(Sq / 128)·128) fp32, 16-byte aligned.  dtype 0 = float32
// (three passes: lse and D in scratch, rows Sq apart; o32 and lse null); 1
// = bfloat16 (two): o32 and lse the forward's state, (B, H, Sq, d) and (B,
// H, ceil(Sq / 128)·128) fp32 (flash_attention_fwd's), contiguous and
// 16-byte aligned, and scratch D and lse in the exponent's units.  The
// passes run in order on `stream`; each launch is checked.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* dout, const float* o32, float* lse, void* dq,
                                   void* dk, void* dv, float* scratch, const int* lengths,
                                   const long long* strides, int B, int H, int K, int Sq,
                                   int Skv, int d, int dtype, int causal, int window,
                                   float softcap, float sm_scale, void* stream) {
  using namespace repro_torch;
  if (dtype == 1 && (!o32 || !lse)) return (int)cudaErrorInvalidValue;
  BwdArgs a;
  a.sq_pitch = (Sq + kStatsRows - 1) / kStatsRows * kStatsRows;
  float* second = scratch + (int64_t)B * H * a.sq_pitch;
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.dq = dq; a.dk = dk; a.dv = dv;
  a.o32 = o32; a.lengths = lengths;
  a.lse = dtype == 1 ? lse : scratch;
  a.delta = dtype == 1 ? scratch : second;
  a.lse_x = second;
  for (int i = 0; i < 21; ++i) a.st[i] = strides[i];
  a.H = H; a.K = K; a.Sq = Sq; a.Skv = Skv; a.causal = causal; a.window = window;
  a.softcap = softcap; a.sm_scale = sm_scale;
  return (int)launch_d(a, B, d, dtype, static_cast<cudaStream_t>(stream));
}
