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
// statistics' and the gradients' scores and dP, dV, dK, dQ), 10·d
// operations per unmasked (query, key) pair, far above the H100's 295
// operations per byte, so operations.  This first version runs them as
// IEEE fp32 FMA on the CUDA cores (67 TFLOP/s peak), not on the tensor
// cores, and recomputes the scores and dP in each of its three passes, so
// it does 9 products where the bound counts 5: right and simple first;
// mma.sync or wgmma is later work.
//
// Design: FlashAttention-2's backward in three passes, written simply.
// - Statistics (one block per b, h, query tile): each row's log-sum-exp of
//   its scaled, capped scores and D = sum_j P_ij dP_ij, both online over kv
//   tiles (D rescaled with the running max as the normaliser is).  D comes
//   from P and dP, not from rowsum(dO * O): K1's O is rounded to the input
//   type, and a bf16 O would put its rounding into every dS.
// - dQ (one block per b, h, query tile): over kv tiles, P = exp(s - lse),
//   dS = P (dP - D) times the softcap's derivative 1 - (s/cap)^2, dQ += dS K.
// - dK and dV (one block per b, kv head, kv tile): over the G query heads
//   of that kv head and their query tiles, dV += P^T dO and dK += dS^T Q.
//   The block sums the G heads itself, so no atomics and no second pass.
// Each block loops over the tiles itself (blocks run in no order); tiles
// that causality, the window or `lengths` mask whole are skipped, as in the
// forward.  Tiles sit in shared memory as fp32 with a padded row pitch
// (conflict-free column reads); 256 threads as 16 row groups x 16 column
// lanes, each owning rows rg + 16i and columns cg + 16j of a score tile and
// of its accumulators, so a row's reductions stay within 16 lanes.  Tiles
// are 64 x 64 at d = 64 and 128 and 32 x 32 at d = 256, where the dK and
// dV accumulators of 64 registers each would not fit beside larger ones.
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int NT = 256;             // 16 row groups x 16 column lanes
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
  float* lse;    // (B, H, Sq)
  float* delta;  // (B, H, Sq)
  const int* lengths;
  int64_t st[21];  // (b, head, seq) element strides of q, k, v, dout, dq, dk, dv
  int H, K, Sq, Skv, causal, window;
  float softcap, sm_scale;
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
__global__ void __launch_bounds__(NT) bwd_stats_kernel(BwdArgs a) {
  constexpr int BT = Tiles<D>::B, LD = D + 1, R = BT / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sO = sQ + BT * LD;
  float* sK = sO + BT * LD;
  float* sV = sK + BT * LD;
  const int q0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.K), rg = threadIdx.x >> 4, cg = threadIdx.x & 15;
  const int len = a.lengths ? min(a.lengths[b], a.Skv) : a.Skv;
  load_tile<T, D, LD, NT>(sQ, at<T>(a, TQ, a.q, b, h), a.st[3 * TQ + 2], q0, BT, a.Sq);
  load_tile<T, D, LD, NT>(sO, at<T>(a, TDO, a.dout, b, h), a.st[3 * TDO + 2], q0, BT, a.Sq);
  const T* Kp = at<T>(a, TK, a.k, b, kvh);
  const T* Vp = at<T>(a, TV, a.v, b, kvh);

  float m[R], l[R], acc[R];
#pragma unroll
  for (int i = 0; i < R; ++i) m[i] = kNegInf, l[i] = 0.f, acc[i] = 0.f;
  int kb, ke;
  kv_range<BT>(a, len, q0, kb, ke);
  for (int k0 = kb; k0 < ke; k0 += BT) {
    __syncthreads();
    load_tile<T, D, LD, NT>(sK, Kp, a.st[3 * TK + 2], k0, BT, a.Skv);
    load_tile<T, D, LD, NT>(sV, Vp, a.st[3 * TV + 2], k0, BT, a.Skv);
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
  for (int r = threadIdx.x; r < BT; r += NT) {
    const int64_t row = ((int64_t)b * a.H + h) * a.Sq + q0 + r;
    const bool in = q0 + r < a.Sq;
    sL[r] = in ? a.lse[row] : kNoKey;
    sD[r] = in ? a.delta[row] : 0.f;
  }
}

// ---- pass 2: dQ ----
template <typename T, int D>
__global__ void __launch_bounds__(NT) bwd_dq_kernel(BwdArgs a) {
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
  load_tile<T, D, LD, NT>(sQ, at<T>(a, TQ, a.q, b, h), a.st[3 * TQ + 2], q0, BT, a.Sq);
  load_tile<T, D, LD, NT>(sO, at<T>(a, TDO, a.dout, b, h), a.st[3 * TDO + 2], q0, BT, a.Sq);
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
    load_tile<T, D, LD, NT>(sK, Kp, a.st[3 * TK + 2], k0, BT, a.Skv);
    load_tile<T, D, LD, NT>(sV, Vp, a.st[3 * TV + 2], k0, BT, a.Skv);
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
__global__ void __launch_bounds__(NT) bwd_dkv_kernel(BwdArgs a) {
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
  load_tile<T, D, LD, NT>(sK, at<T>(a, TK, a.k, b, kvh), a.st[3 * TK + 2], k0, BT, a.Skv);
  load_tile<T, D, LD, NT>(sV, at<T>(a, TV, a.v, b, kvh), a.st[3 * TV + 2], k0, BT, a.Skv);

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
      load_tile<T, D, LD, NT>(sQ, Qp, a.st[3 * TQ + 2], q0, BT, a.Sq);
      load_tile<T, D, LD, NT>(sO, Op, a.st[3 * TDO + 2], q0, BT, a.Sq);
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

template <int D>
constexpr size_t tile_floats() { return (size_t)Tiles<D>::B * (D + 1); }
template <int D>
constexpr size_t score_floats() { return (size_t)Tiles<D>::B * (Tiles<D>::B + 1); }

template <typename K>
cudaError_t launch(K kernel, dim3 grid, size_t smem, const BwdArgs& a, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_all(const BwdArgs& a, int B, cudaStream_t stream) {
  constexpr int BT = Tiles<D>::B;
  const dim3 q_grid((a.Sq + BT - 1) / BT, a.H, B);
  const dim3 kv_grid((a.Skv + BT - 1) / BT, a.K, B);
  cudaError_t err = launch(bwd_stats_kernel<T, D>, q_grid,
                           4 * tile_floats<D>() * sizeof(float), a, stream);
  if (err != cudaSuccess) return err;
  err = launch(bwd_dq_kernel<T, D>, q_grid,
               (4 * tile_floats<D>() + score_floats<D>() + 2 * BT) * sizeof(float), a, stream);
  if (err != cudaSuccess) return err;
  return launch(bwd_dkv_kernel<T, D>, kv_grid,
                (4 * tile_floats<D>() + 2 * score_floats<D>() + 2 * BT) * sizeof(float), a,
                stream);
}

template <typename T>
cudaError_t launch_d(const BwdArgs& a, int B, int d, cudaStream_t stream) {
  switch (d) {
    case 64: return launch_all<T, 64>(a, B, stream);
    case 128: return launch_all<T, 128>(a, B, stream);
    case 256: return launch_all<T, 256>(a, B, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace repro_torch

// strides: 21 element strides (b, head, seq) of q, k, v, dout, dq, dk, dv in
// that order; head dimensions contiguous and rows 16-byte aligned.  lse and
// delta: (B, H, Sq) fp32 scratch.  dtype: 0 = float32, 1 = bfloat16.  The
// three passes run in order on `stream`; each launch is checked.
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
  a.softcap = softcap; a.sm_scale = sm_scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_d<float>(a, B, d, s);
  if (dtype == 1) return (int)launch_d<__nv_bfloat16>(a, B, d, s);
  return (int)cudaErrorInvalidValue;
}
