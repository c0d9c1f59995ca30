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
// belong on the tensor cores.
//
// bf16 (bwd_dq_bf16_kernel, bwd_dkv_bf16_kernel): FlashAttention-2's
// backward on mma.sync.m16n8k16, bf16 in and fp32 out, in two launches.
// - Pass 1, one block per (b, h, 64-row query tile), 4 warps of 16 rows,
//   kv tiles double-buffered by cp.async into swizzled bf16 tiles, as K1:
//   sweep 1 takes each row's log-sum-exp and D = sum_j P_ij dP_ij online
//   from S = Q·Kᵀ and dP = dO·Vᵀ (D from P and dP, not from rowsum(dO ∘ O):
//   K1's O is rounded to bf16, and its rounding would enter every dS), and
//   writes them for pass 2; sweep 2 forms S and dP again, dS = P (dP - D)
//   times the softcap's derivative in registers, and dQ += dS·K with dS as
//   the A operand straight from the accumulators and K read transposed by
//   ldmatrix.trans (common.cuh's pv_step).
// - Pass 2, one block per (b, kv head, kv tile), each warp owning 16 keys:
//   over the G query heads and their live query tiles (Q, dO, lse and D
//   double-buffered), Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ, so that Pᵀ and dSᵀ come
//   out of the accumulators in the A-fragment layout of dV += Pᵀ·dO and
//   dK += dSᵀ·Q, Q and dO read transposed.  The block sums the G heads
//   itself: no atomics, a fixed order, so two calls give the same bits.
// - Seven products where the bound counts five (the statistics' S and dP,
//   17-27% of the time).  Taking lse and an fp32 O from K1's forward would
//   save them, but a gradient through autograd and a direct call of this
//   kernel on the same inputs (which has no forward state) would then
//   differ in their bits.
// - Parity.  The gradients are held to the float64 plain version within
//   2^-14·max|want| + 2^-7·|want| (chip_smoke.py phase 18).  S and dP are
//   exact products of bf16 inputs, summed in chains of PARITY_QK_CHAIN = 8
//   k16 steps as K1 on mma.sync took them.  P and dS are fp32 values; rounded once to bf16
//   (PARITY_BWD_PARTS = 1) they put ~2^-9 of relative error into every term
//   of a gradient's sum, and on phase 18's cases the gradients miss the
//   limit by 9.9-20.8x.  In two parts (split_bf16) every case is at
//   0.480-0.490 of it, the bf16 output's own half ulp; three parts give the
//   same ratios and, chained, cost 4-8% more, so two ship.  Summing each k16 step
//   from zero and adding it in IEEE fp32 (PARITY_BWD_FRESH = 1, as K1 on
//   mma.sync took P·V) against chaining every step into the accumulator, whose mma adds
//   truncate: the same ratios at these sizes (dK and dV sum up to 16 heads
//   x 4096 queries), and chaining is 5-25% faster, so it ships.  The fast
//   exponentials (PARITY_IEEE_EXP = 0, the statistics and P alike) leave
//   the ratios as they are and take 0.5-10% off.  (parity_probe.py --kernel
//   flash_bwd on an H100.)
// - Registers (ptxas, no spill at any d).  dK and dV of 16 keys x d are d
//   fp32 a thread together: at d = 64 one warp keeps both, with steps of 32
//   queries; from d = 128 (spilled at d = 128, cannot fit at d = 256) a
//   pair of warps owns 16 keys, one summing dV and the other dK, with steps
//   of 64 queries (16 at d = 256), and the pair computes Sᵀ twice.  Pass 1
//   keeps 16 x d of dQ, as K1 its output: steps of 32 keys, and 16-key
//   tiles at d = 256 (32-key tiles, at one block an SM, made it 1.5-1.7x
//   slower on an H100).
// - Tiles that causality, the window or `lengths` mask whole are skipped,
//   warps skip their own dead steps and mask only steps that cross an edge;
//   both passes issue their longest blocks first across the whole grid.
//
// fp32 (bwd_{stats,dq,dkv}_kernel): the first version, unchanged: three
// passes of IEEE fp32 FMA on the CUDA cores (67 TFLOP/s peak), the scores
// and dP recomputed in each (9 products), tiles in shared memory as fp32
// with a padded row pitch; 256 threads as 16 row groups x 16 column lanes,
// each owning rows rg + 16i and columns cg + 16j of a score tile and of its
// accumulators; 64 x 64 tiles at d = 64 and 128 and 32 x 32 at d = 256.
// Only the ~100M fp32 config trains through it.
// common.cuh's parity switches as this kernel ships them (see the header)
#ifndef PARITY_QK_CHAIN
#define PARITY_QK_CHAIN 8
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
constexpr float kNoKey = 1e30f;     // lse of a row with no live key: P = 0

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
  float* lse;    // (B, H, sq_pitch) in bf16, rows Sq apart in fp32
  float* delta;  // likewise
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

// ---- bf16: the tensor-core design (see the notes at the top) ----

using bf16 = __nv_bfloat16;
constexpr int NTH = 128;  // bf16: 4 warps

// The stats and dQ kernel: 64 query rows a block, 16 a warp; kv tiles of
// BKV keys, double-buffered; steps of KS keys (the score registers beside
// the 16 x d dQ accumulator: d/2 a thread, 128 at d = 256).
template <int D>
struct QTiles {
  static constexpr int BQ = 64;
  static constexpr int BKV = D == 256 ? 16 : 64;
  static constexpr int KS = D == 256 ? 16 : 32;
};

// The dK/dV kernel: a block owns BKV keys, 16 a warp; from d = 128 a pair
// of warps owns 16 keys, the even warp summing dV and the odd one dK
// (SPLIT): one warp's 16 x d of dK and dV, d registers a thread, spilled at
// d = 128 beside the scores (ptxas; 255 registers and 20 bytes of spill at
// 16-query steps) and cannot fit at d = 256.  Query tiles of BQ rows,
// double-buffered with their lse and D; steps of QS queries.
template <int D>
struct KvTiles {
  static constexpr bool SPLIT = D >= 128;
  static constexpr int BKV = SPLIT ? 32 : 64;
  static constexpr int BQ = D == 256 ? 32 : 64;
  static constexpr int QS = D == 64 ? 32 : D == 128 ? 64 : 16;
};

// rows of the (B, H, sq_pitch) lse and D: every query tile of the stats
// kernel whole, 16-byte aligned
constexpr int kStatsRows = 64;

// `rows` rows of D bf16 from row0 of src (row pitch `stride`) into a
// swizzled tile by cp.async, rows at or past `valid` zero-filled and not
// read.
template <int D>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int64_t stride, int row0,
                                          int rows, int valid) {
  constexpr int CPR = D / 8;
#pragma unroll 1  // unrolled, its hoisted addresses spill at d = 256
  for (int i = threadIdx.x; i < rows * CPR; i += NTH) {
    const int r = i / CPR, c = i % CPR;
    const bool ok = row0 + r < valid;
    cp_async16(dst + swz<CPR, 8>(r, c), src + (ok ? (int64_t)(row0 + r) * stride : 0) + c * 8,
               ok);
  }
}

// No live (query, key) pair among queries [q0, q0 + nq) and keys [k0, k0 + nk).
__device__ __forceinline__ bool none_live(const BwdArgs& a, int len, int q0, int nq, int k0,
                                          int nk) {
  return q0 >= a.Sq || k0 >= len || (a.causal && k0 > q0 + nq - 1) ||
         (a.window > 0 && k0 + nk - 1 <= q0 - a.window);
}
// Every pair among them live.
__device__ __forceinline__ bool all_live(const BwdArgs& a, int len, int q0, int nq, int k0,
                                         int nk) {
  return q0 + nq <= a.Sq && k0 + nk <= len && (!a.causal || k0 + nk - 1 <= q0) &&
         (a.window <= 0 || k0 > q0 + nq - 1 - a.window);
}

// The softcap's derivative at the scaled, capped score sc, times ds.
__device__ __forceinline__ float cap_grad(const BwdArgs& a, float sc, float ds) {
  if (a.softcap > 0.f) {
    const float t = sc / a.softcap;
    ds *= 1.f - t * t;
  }
  return ds;
}

// One step of the online statistics over a warp's scores s (rows g and
// g + 8 of the mma layout; scaled, capped, masked entries -inf) and dP:
// the running max m, and this thread's shares of the row sums l of
// exp(s - m) and pd of exp(s - m)·dP, rescaled where the max moved.
template <int NT>
__device__ __forceinline__ void stats_step(const float (&s)[NT][4], const float (&dp)[NT][4],
                                           float (&m)[2], float (&l)[2], float (&pd)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = -INFINITY;
#pragma unroll
    for (int n = 0; n < NT; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * h], s[n][2 * h + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[h], mx);
    if (m_new == -INFINITY) continue;  // no live key in this row yet
    const float alpha = exp_tc(m[h] - m_new);
    float sum = 0.f, sd = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 2 * h; e < 2 * h + 2; ++e) {
        const float p = exp_tc(s[n][e] - m_new);
        sum += p;
        sd = fmaf(p, dp[n][e], sd);
      }
    l[h] = l[h] * alpha + sum;
    pd[h] = pd[h] * alpha + sd;
    m[h] = m_new;
  }
}

// ---- bf16 pass 1: lse and D, then dQ (one block per b, h, query tile) ----
template <int D>
__global__ void __launch_bounds__(NTH) bwd_dq_bf16_kernel(BwdArgs a) {
  using Tl = QTiles<D>;
  constexpr int BQ = Tl::BQ, BKV = Tl::BKV, KS = Tl::KS, NT = KS / 8, NO = D / 8;
  extern __shared__ __align__(16) unsigned char smem16[];
  bf16* sQ = reinterpret_cast<bf16*>(smem16);
  bf16* sO = sQ + BQ * D;       // dO
  bf16* sK = sO + BQ * D;       // [2][BKV][D]
  bf16* sV = sK + 2 * BKV * D;  // [2][BKV][D]
  // the grid is (H, B, query tiles): every head's longest causal rows first
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int h = blockIdx.x, b = blockIdx.y, kvh = h / (a.H / a.K);
  const int len = max(0, a.lengths ? min(a.lengths[b], a.Skv) : a.Skv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const bf16* Kp = at<bf16>(a, TK, a.k, b, kvh);
  const bf16* Vp = at<bf16>(a, TV, a.v, b, kvh);

  // the kv range that can hold a live key for some row of this tile
  int ke = len;
  if (a.causal) ke = min(ke, min(q0 + BQ, a.Sq));
  int kb = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  kb -= kb % BKV;
  const int ntiles = kb < ke ? (ke - kb + BKV - 1) / BKV : 0;

  auto issue = [&](int tile) {
    const int stage = tile & 1, k0 = kb + tile * BKV;
    load_rows<D>(sK + stage * BKV * D, Kp, a.st[3 * TK + 2], k0, BKV, ke);
    load_rows<D>(sV + stage * BKV * D, Vp, a.st[3 * TV + 2], k0, BKV, ke);
  };
  const int w0 = q0 + 16 * warp;  // this warp's rows: w0 + g and w0 + g + 8
  // S = Q·Kᵀ and dP = dO·Vᵀ of one step of KS keys from k0 (stage, offset)
  auto scores = [&](float (&s)[NT][4], float (&dp)[NT][4], int stage, int sub) {
    qk_step<NT, D>(s, sQ, 16 * warp, sK + stage * BKV * D, sub * KS, lane);
    qk_step<NT, D>(dp, sO, 16 * warp, sV + stage * BKV * D, sub * KS, lane);
  };

  // sweep 1: each row's lse and D = sum_j P_ij dP_ij, online over the keys
  load_rows<D>(sQ, at<bf16>(a, TQ, a.q, b, h), a.st[3 * TQ + 2], q0, BQ, a.Sq);
  load_rows<D>(sO, at<bf16>(a, TDO, a.dout, b, h), a.st[3 * TDO + 2], q0, BQ, a.Sq);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, pd[2] = {0.f, 0.f};
  pipeline<2>(ntiles, issue, [&](int tile) {
    const int stage = tile & 1;
#pragma unroll 1
    for (int sub = 0; sub < BKV / KS; ++sub) {
      const int k0 = kb + tile * BKV + sub * KS;
      if (none_live(a, len, w0, 16, k0, KS)) continue;
      float s[NT][4], dp[NT][4];
      scores(s, dp, stage, sub);
      const bool full = all_live(a, len, w0, 16, k0, KS);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = softcap_tc(s[n][e] * a.sm_scale, a.softcap);
          if (!full && !live(a, len, w0 + g + 8 * (e >> 1), k0 + 8 * n + 2 * t4 + (e & 1)))
            x = -INFINITY;
          s[n][e] = x;
        }
      stats_step<NT>(s, dp, m, l, pd);
    }
  });
  float lse[2], dl[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    pd[hh] += __shfl_xor_sync(0xffffffffu, pd[hh], 1);
    pd[hh] += __shfl_xor_sync(0xffffffffu, pd[hh], 2);
    lse[hh] = l[hh] > 0.f ? m[hh] + logf(l[hh]) : kNoKey;
    dl[hh] = l[hh] > 0.f ? pd[hh] / l[hh] : 0.f;
    const int qi = w0 + g + 8 * hh;  // rows past Sq too, to the pitch: no key, P = 0
    if (t4 == 0 && qi < a.sq_pitch) {
      const int64_t row = ((int64_t)b * a.H + h) * a.sq_pitch + qi;
      a.lse[row] = lse[hh];
      a.delta[row] = dl[hh];
    }
  }

  // sweep 2: dS = P (dP - D) times the softcap's derivative, dQ += dS·K
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  pipeline<2>(ntiles, issue, [&](int tile) {
    const int stage = tile & 1;
#pragma unroll 1
    for (int sub = 0; sub < BKV / KS; ++sub) {
      const int k0 = kb + tile * BKV + sub * KS;
      if (none_live(a, len, w0, 16, k0, KS)) continue;
      float s[NT][4], dp[NT][4];
      scores(s, dp, stage, sub);
      const bool full = all_live(a, len, w0, 16, k0, KS);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hh = e >> 1;
          const float sc = softcap_tc(s[n][e] * a.sm_scale, a.softcap);
          float ds = cap_grad(a, sc, exp_tc(sc - lse[hh]) * (dp[n][e] - dl[hh]));
          if (!full && !live(a, len, w0 + g + 8 * hh, k0 + 8 * n + 2 * t4 + (e & 1))) ds = 0.f;
          s[n][e] = ds;
        }
      pv_step<NT, NO, PARITY_BWD_PARTS, PARITY_BWD_FRESH>(s, acc, sK + stage * BKV * D,
                                                          sub * KS, lane);
    }
  });

  bf16* dQ = at<bf16>(a, TDQ, a.dq, b, h);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qi = w0 + g + 8 * hh;
    if (qi >= a.Sq) continue;
    bf16* dst = dQ + (int64_t)qi * a.st[3 * TDQ + 2] + 2 * t4;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) = __floats2bfloat162_rn(
          acc[n][2 * hh] * a.sm_scale, acc[n][2 * hh + 1] * a.sm_scale);
  }
}

// ---- bf16 pass 2: dK and dV (one block per b, kv head, kv tile) ----
// Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ, so that Pᵀ and dSᵀ come out of the
// accumulators as the A fragments of dV += Pᵀ·dO and dK += dSᵀ·Q; Q and dO
// are read transposed by ldmatrix.trans (pv_step).  The G query heads of
// the kv head are summed in the block, one after the other.
template <int D>
__global__ void __launch_bounds__(NTH) bwd_dkv_bf16_kernel(BwdArgs a) {
  using Tl = KvTiles<D>;
  constexpr bool SPLIT = Tl::SPLIT;
  constexpr int BKV = Tl::BKV, BQ = Tl::BQ, QS = Tl::QS, NT = QS / 8, NO = D / 8;
  extern __shared__ __align__(16) unsigned char smem16[];
  bf16* sK = reinterpret_cast<bf16*>(smem16);
  bf16* sV = sK + BKV * D;
  bf16* sQ = sV + BKV * D;      // [2][BQ][D]
  bf16* sO = sQ + 2 * BQ * D;   // [2][BQ][D] dO
  float* sL = reinterpret_cast<float*>(sO + 2 * BQ * D);  // [2][BQ] lse
  float* sD = sL + 2 * BQ;                                 // [2][BQ] D
  // the grid is (K, B, kv tiles): every head's first (under causality the
  // longest) tiles first
  const int k0 = blockIdx.z * BKV, kvh = blockIdx.x, b = blockIdx.y, G = a.H / a.K;
  const int len = max(0, a.lengths ? min(a.lengths[b], a.Skv) : a.Skv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int kw = 16 * (SPLIT ? warp >> 1 : warp);  // this warp's keys k0 + kw ..
  const bool dk_warp = !SPLIT || (warp & 1);       // sums dK (and dV unless SPLIT)

  // the query rows that can see a live key of this tile: qi >= kj when
  // causal, qi < kj + window when windowed
  int qb = 0, qe = k0 < len ? a.Sq : 0;
  if (a.causal) qb = k0 - k0 % BQ;
  if (a.window > 0) qe = min(qe, min(k0 + BKV, len) - 1 + a.window);
  const int nq = qb < qe ? (qe - qb + BQ - 1) / BQ : 0;

  load_rows<D>(sK, at<bf16>(a, TK, a.k, b, kvh), a.st[3 * TK + 2], k0, BKV, a.Skv);
  load_rows<D>(sV, at<bf16>(a, TV, a.v, b, kvh), a.st[3 * TV + 2], k0, BKV, a.Skv);
  auto issue = [&](int i) {  // head kvh·G + i / nq, its query tile i % nq
    const int stage = i & 1, h = kvh * G + i / nq, q0 = qb + (i % nq) * BQ;
    load_rows<D>(sQ + stage * BQ * D, at<bf16>(a, TQ, a.q, b, h), a.st[3 * TQ + 2], q0, BQ,
                 a.Sq);
    load_rows<D>(sO + stage * BQ * D, at<bf16>(a, TDO, a.dout, b, h), a.st[3 * TDO + 2], q0,
                 BQ, a.Sq);
    const int64_t row = ((int64_t)b * a.H + h) * a.sq_pitch + q0;  // within the pitch
    for (int c = threadIdx.x; c < BQ / 2; c += NTH) {  // BQ / 4 chunks of lse, then of D
      const bool of_d = c >= BQ / 4;
      const int off = 4 * (c % (BQ / 4));
      cp_async16((of_d ? sD : sL) + stage * BQ + off, (of_d ? a.delta : a.lse) + row + off,
                 true);
    }
  };

  constexpr int N1 = SPLIT ? 1 : NO;
  float acc0[NO][4];  // dV; SPLIT: this warp's dK or dV
  float acc1[N1][4];  // dK (unused when SPLIT)
#pragma unroll
  for (int n = 0; n < NO; ++n) acc0[n][0] = acc0[n][1] = acc0[n][2] = acc0[n][3] = 0.f;
#pragma unroll
  for (int n = 0; n < N1; ++n) acc1[n][0] = acc1[n][1] = acc1[n][2] = acc1[n][3] = 0.f;

  pipeline<2>(G * nq, issue, [&](int i) {
    const int stage = i & 1, q0 = qb + (i % nq) * BQ;
    const bf16* tQ = sQ + stage * BQ * D;
    const bf16* tO = sO + stage * BQ * D;
#pragma unroll 1
    for (int sub = 0; sub < BQ / QS; ++sub) {
      const int qs = q0 + sub * QS;
      if (none_live(a, len, qs, QS, k0 + kw, 16)) continue;
      const bool full = all_live(a, len, qs, QS, k0 + kw, 16);
      const float* L = sL + stage * BQ + sub * QS + 2 * t4;  // + 8n + (e & 1)
      const float* Dl = sD + stage * BQ + sub * QS + 2 * t4;
      // Sᵀ, then Pᵀ (SPLIT: a dK warp's dSᵀ): rows keys g, g + 8; columns queries
      float s[NT][4], dp[NT][4];  // dPᵀ, then dSᵀ (dK warps)
      qk_step<NT, D>(s, sK, kw, tQ, sub * QS, lane);
      if (dk_warp) qk_step<NT, D>(dp, sV, kw, tO, sub * QS, lane);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * n + (e & 1);
          const float sc = softcap_tc(s[n][e] * a.sm_scale, a.softcap);
          float p = exp_tc(sc - L[c]);
          if (!full && !live(a, len, qs + 2 * t4 + c, k0 + kw + g + 8 * (e >> 1))) p = 0.f;
          if (dk_warp) {
            const float ds = cap_grad(a, sc, p * (dp[n][e] - Dl[c]));
            if constexpr (SPLIT) p = ds;
            else dp[n][e] = ds;
          }
          s[n][e] = p;
        }
      if constexpr (SPLIT) {  // one product a warp: dK += dSᵀ·Q or dV += Pᵀ·dO
        pv_step<NT, NO, PARITY_BWD_PARTS, PARITY_BWD_FRESH>(s, acc0, dk_warp ? tQ : tO,
                                                            sub * QS, lane);
      } else {
        pv_step<NT, NO, PARITY_BWD_PARTS, PARITY_BWD_FRESH>(s, acc0, tO, sub * QS, lane);
        pv_step<NT, NO, PARITY_BWD_PARTS, PARITY_BWD_FRESH>(dp, acc1, tQ, sub * QS, lane);
      }
    }
  });

  // write this warp's rows: dV from acc0 and dK from acc1 (SPLIT: its one)
  auto store = [&](int t, const float (&acc)[NO][4], float scale) {
    bf16* base = at<bf16>(a, t, t == TDK ? a.dk : a.dv, b, kvh);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int kj = k0 + kw + g + 8 * hh;
      if (kj >= a.Skv) continue;
      bf16* dst = base + (int64_t)kj * a.st[3 * t + 2] + 2 * t4;
#pragma unroll
      for (int n = 0; n < NO; ++n)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) =
            __floats2bfloat162_rn(acc[n][2 * hh] * scale, acc[n][2 * hh + 1] * scale);
    }
  };
  if constexpr (SPLIT) {
    store(dk_warp ? TDK : TDV, acc0, dk_warp ? a.sm_scale : 1.f);
  } else {
    store(TDV, acc0, 1.f);
    store(TDK, acc1, a.sm_scale);
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

template <int D>
cudaError_t launch_bf16(const BwdArgs& a, int B, cudaStream_t stream) {
  using QT = QTiles<D>;
  using KT = KvTiles<D>;
  constexpr size_t smem_q = (size_t)(2 * QT::BQ + 4 * QT::BKV) * D * sizeof(bf16);
  constexpr size_t smem_kv =
      (size_t)(2 * KT::BKV + 4 * KT::BQ) * D * sizeof(bf16) + 4 * KT::BQ * sizeof(float);
  static_assert(kStatsRows % QT::BQ == 0 && kStatsRows % KT::BQ == 0, "stats pitch");
  cudaError_t err = launch(bwd_dq_bf16_kernel<D>, dim3(a.H, B, (a.Sq + QT::BQ - 1) / QT::BQ),
                           NTH, smem_q, a, stream);
  if (err != cudaSuccess) return err;
  return launch(bwd_dkv_bf16_kernel<D>, dim3(a.K, B, (a.Skv + KT::BKV - 1) / KT::BKV), NTH,
                smem_kv, a, stream);
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
// that order; head dimensions contiguous and rows 16-byte aligned.  lse and
// delta: (B, H, ceil(Sq / 64)·64) fp32 scratch, 16-byte aligned.  dtype: 0 =
// float32 (three passes), 1 = bfloat16 (two).  The passes run in order on
// `stream`; each launch is checked.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* dout, void* dq, void* dk, void* dv, float* lse,
                                   float* delta, const int* lengths, const long long* strides,
                                   int B, int H, int K, int Sq, int Skv, int d, int dtype,
                                   int causal, int window, float softcap, float sm_scale,
                                   void* stream) {
  using namespace repro_torch;
  BwdArgs a;
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.dq = dq; a.dk = dk; a.dv = dv;
  a.lse = lse; a.delta = delta; a.lengths = lengths;
  for (int i = 0; i < 21; ++i) a.st[i] = strides[i];
  a.H = H; a.K = K; a.Sq = Sq; a.Skv = Skv; a.causal = causal; a.window = window;
  a.sq_pitch = (Sq + kStatsRows - 1) / kStatsRows * kStatsRows;
  a.softcap = softcap; a.sm_scale = sm_scale;
  return (int)launch_d(a, B, d, dtype, static_cast<cudaStream_t>(stream));
}
