// Flash attention for prefill on Hopper (sm_90a), fp32 accumulation.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py ::
// flash_attention (_flash_kernel).  Same function: blockwise online-softmax
// GQA attention, causal, sliding window (0 = global) and tanh softcap, plus
// per-sequence `lengths` (keys >= lengths[b] masked) so that ragged prefill
// can use it, and ragged Sq/Skv edges with no divisibility required.  A
// query row with no live key gets 0.
//
// What bounds it on this card: at prefill lengths the work is operations,
// 4·d multiply-adds per unmasked (query, key) pair, far above the H100's
// 295 operations per byte, so the products belong on the tensor cores.  The
// TPU grid carried m/l/acc in VMEM scratch across its sequential kv axis; on
// Hopper blocks run in parallel with no carried scratch, so each block owns
// one (b, h, q tile) and loops over kv tiles itself.  Kv tiles that
// causality, the window or the length mask fully (the TPU kernel's block
// skip) are never loaded, which keeps local layers O(S·W).
//
// bf16 (flash_wgmma_kernel), warp-specialised on wgmma and TMA:
// - A block owns 128 query rows of one (b, head), longest causal rows
//   first: two consumer warpgroups of 64 rows and a producer warpgroup, one
//   thread of which issues every copy.  setmaxnreg moves registers from the
//   producer (24) to the consumers (240).
// - TMA, from tensor maps built on the host over the model's strided (B, S,
//   heads, d) views (head_map, cached) and passed as __grid_constant__
//   parameters: Q once, then K and V tiles of 64 keys (32 at d = 256) into
//   a ring of 3 stages, in boxes of 64 columns, one 128-byte swizzle row,
//   as wgmma reads them.  Rows past Sq or Skv arrive as zeros.  Full
//   mbarriers (K and V apart, so S = Q·Kᵀ starts before V lands) and empty
//   ones (a release from each consumer warp).
// - S = Q·Kᵀ is wgmma m64nBKVk16 with Q and K from shared memory, K-major.
//   O += P·V is wgmma m64n64k16 over 64-column slices with P from registers
//   (S's accumulator layout is the A fragment's, so P never touches shared
//   memory) and V read in its stored layout as an MN-major B: no transpose.
// - Overlap.  In tile n a warpgroup issues S(n) and then P(n-1)·V(n-1) in
//   its turn (named barriers 1 and 2: the two warpgroups alternate), then
//   runs the softmax of S(n) while P(n-1)·V(n-1) retires and the other
//   warpgroup's products run.  (Issuing S(n + 1) before the softmax of
//   S(n), with two score buffers, was 4-30% slower on every row and
//   spilled at d = 256.)  The first and last tiles are peeled off the loop,
//   so ptxas sees one shape of wgmma pipeline (with branches around either
//   half in the loop it serialized every wgmma), and fence_regs pins the
//   accumulators around the asynchronous products.
// - Lengths, causality and the window are masked in registers: each warp
//   tests its 16 rows against a tile and masks only a tile that crosses an
//   edge.  Kv tiles that no row of the block sees are never loaded (the TPU
//   kernel's block skip), and the rescale of O is skipped where a row's max
//   held.
// - Parity.  Held to one bf16 ulp of the float64 plain version on the
//   models' own activations (parity_probe.py on an H100, PERF.md), it keeps
//   three of common.cuh's measures: P in three bf16 parts, tanhf/expf, and
//   P·V summed from zero a tile (4 k16 steps; the whole 32-key tile at
//   d = 256) before it is added to O in IEEE fp32.  Each set otherwise
//   alone fails on gemma2-2b's activations: P·V chained into O by 1.75x
//   the limit (and on granite-moe-3b-a800m's by 1.78x), two parts by 1.17x,
//   the fast exponentials by 1.17x.  A fresh sum each k16 step, and Q·Kᵀ in
//   chains of 8 at d = 256, pass too, but are slower: Q·Kᵀ runs in one.
// - Registers: O is d/2 fp32 a thread (128 at d = 256); one fresh P·V
//   fragment of 32, so a tile's slices after the first wait for the one
//   before, and the last retires during the softmax.
// - The backward's state, when asked (flash_attention_bwd.cu): the
//   epilogue also writes each row's log-sum-exp m + log l and the output
//   before its bf16 rounding, in fp32, from the same registers; the bf16
//   output keeps its bits.
//
// fp32 (flash_f32_kernel) keeps IEEE FMA products: 32-key kv tiles converted
// into padded fp32 shared-memory tiles (conflict-free column reads), 2 rows
// x d/8 columns of the accumulator a thread, 137 KB at d = 256.
// common.cuh's parity switches as K1 ships them (see the header)
#ifndef PARITY_QK_CHAIN
#define PARITY_QK_CHAIN 16
#endif
#ifndef PARITY_PV_FRESH
#define PARITY_PV_FRESH 4
#endif
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int BQ = 64;         // query rows per block
constexpr int BK = 32;         // keys per kv tile, fp32
constexpr int NTHREADS = 256;  // fp32: 32 row pairs x 8 column groups

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  // bf16, when asked (the backward's state; else null): each row's
  // log-sum-exp of the scaled, capped scores, (B, H, stats_pitch), and the
  // output before its rounding, (B, H, Sq, d) fp32
  float* lse;
  float* o32;
  int stats_pitch;
  const int* lengths;  // (B,) or null
  int64_t q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss;
  int H, K, Sq, Skv, causal, window;
  float softcap, sm_scale;
};

template <int D>
constexpr size_t flash_smem_bytes() {
  return ((size_t)(BQ + 2 * BK) * (D + 1) + (size_t)BQ * (BK + 1)) * sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS) flash_f32_kernel(FlashArgs a) {
  constexpr int LD = D + 1;
  constexpr int LDP = BK + 1;
  constexpr int NC = D / 8;  // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * LD;
  float* sV = sK + BK * LD;
  float* sP = sV + BK * LD;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.K);
  const int len = a.lengths ? min(a.lengths[b], a.Skv) : a.Skv;
  const T* Q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* Kp = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* Vp = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  T* O = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;

  load_tile<T, D, LD, NTHREADS>(sQ, Q, a.q_ss, q0, BQ, a.Sq);

  // This thread owns rows r0, r0+1 of the tile; score columns cg + 8j and
  // output columns cg + 8j.  The 8 threads of a row are adjacent lanes.
  const int cg = threadIdx.x & 7;
  const int r0 = 2 * (threadIdx.x >> 3);
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[2][NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) acc[0][j] = acc[1][j] = 0.f;

  // The kv range that can hold an unmasked key for some row of this tile.
  const int q_last = min(q0 + BQ, a.Sq) - 1;
  int kv_end = len;
  if (a.causal) kv_end = min(kv_end, q_last + 1);
  int kv_begin = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  kv_begin -= kv_begin % BK;

  for (int k0 = kv_begin; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the previous tile's sK/sV/sP are no longer read
    load_tile<T, D, LD, NTHREADS>(sK, Kp, a.k_ss, k0, BK, a.Skv);
    load_tile<T, D, LD, NTHREADS>(sV, Vp, a.v_ss, k0, BK, a.Skv);
    __syncthreads();

    float s[2][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) s[0][j] = s[1][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      const float qa = sQ[r0 * LD + c], qb = sQ[(r0 + 1) * LD + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float kv = sK[(cg + 8 * j) * LD + c];
        s[0][j] = fmaf(qa, kv, s[0][j]);
        s[1][j] = fmaf(qb, kv, s[1][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qi = q0 + r0 + i;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + cg + 8 * j;
        s[i][j] = softcap_f(s[i][j] * a.sm_scale, a.softcap);
        ok[j] = kj < len && (!a.causal || kj <= qi) && (a.window <= 0 || kj > qi - a.window);
        if (ok[j]) mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += p;
        sP[(r0 + i) * LDP + cg + 8 * j] = p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float pa = sP[r0 * LDP + kk], pb = sP[(r0 + 1) * LDP + kk];
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const float vv = sV[kk * LD + cg + 8 * j];
        acc[0][j] = fmaf(pa, vv, acc[0][j]);
        acc[1][j] = fmaf(pb, vv, acc[1][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + r0 + i;
    if (qi >= a.Sq) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;  // a row with no key → 0
#pragma unroll
    for (int j = 0; j < NC; ++j) O[qi * a.o_ss + cg + 8 * j] = from_f<T>(acc[i][j] * inv);
  }
}

// bf16 kv tile: 64 keys, 32 at d = 256, where the accumulator's 128
// registers leave room for no more score and P registers.
template <int D>
__host__ __device__ constexpr int kv_tile() { return D == 256 ? 32 : 64; }

// ---- bf16 on wgmma (flash_wgmma_kernel) ----

constexpr int WG_ROWS = 64;              // query rows of a consumer warpgroup
constexpr int BQ_WG = 2 * WG_ROWS;       // query rows per block: two consumer warpgroups
constexpr int WG_THREADS = 3 * 128;      // and the producer's warpgroup
constexpr int WG_STAGES = 3;             // K/V tiles in the ring
constexpr int PINGPONG = 1;              // named barriers 1 and 2: warpgroup 0's, 1's turn
template <int D>
struct WgTiles {
  static constexpr int BKV = kv_tile<D>();
  static constexpr int Q_BYTES = BQ_WG * D * 2;  // D / 64 boxes of BQ_WG rows x 128 bytes
  static constexpr int KV_BYTES = BKV * D * 2;   // a K or a V tile: D / 64 boxes of BKV rows
  static constexpr int BARS = 1 + 3 * WG_STAGES; // Q; K full, V full and empty a stage
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * WG_STAGES * KV_BYTES + 8 * BARS;
};

// S = Q·Kᵀ for one warpgroup: its 64 rows of the Q tile q against the BKV
// keys of the K tile k, in chains of PARITY_QK_CHAIN k16 steps, each from
// zero: the first into s, a second (where the chain is shorter than d / 16)
// into u, which the caller adds to s once the group has retired.  One
// wgmma group.
template <int D, int BKV>
__device__ __forceinline__ void qk_issue(float (&s)[BKV / 2], float (&u)[BKV / 2],
                                         const uint8_t* q, const uint8_t* k) {
  constexpr int QS = D / 16, C = QS < PARITY_QK_CHAIN ? QS : PARITY_QK_CHAIN;
  static_assert(QS <= 2 * C, "Q·Kᵀ in at most two chains");
  // Step kk's descriptors are these plus its offset (in 16-byte units).  Q's
  // is hidden from the compiler, so that it does not keep all D / 16 of
  // them (loop-invariant) in registers: at d = 256 they spilled.
  uint64_t dq = kmajor_desc(q);
  const uint64_t dk = kmajor_desc(k);
  asm volatile("" : "+l"(dq));
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < QS; ++kk) {
    const uint64_t da = dq + (kk / 4) * BQ_WG * 128 / 16 + 2 * (kk % 4);
    const uint64_t db = dk + (kk / 4) * BKV * 128 / 16 + 2 * (kk % 4);
    if (kk < C) {
      wgmma_ss<BKV>(s, da, db, kk > 0);
    } else {
      wgmma_ss<BKV>(u, da, db, kk > C);
    }
  }
  wgmma_commit();
  fence_regs(s);
  if constexpr (QS > C) fence_regs(u);
}

// acc += P·V for one warpgroup: P of BKV keys in NP bf16 parts (pa[j] the A
// fragments of keys 16j..16j+15, smallest part first), V the tile v; acc[c]
// holds columns 64c..64c+63.  PARITY_PV_FRESH = F > 0: for each slice of
// 64 columns, chains of F k16 steps (their NP parts chained) summed from
// zero in a fresh fragment t, one group each, added to acc in IEEE fp32
// once it retires; the last group is left in flight for pv_finish.  F = 0:
// every step chained into acc in one group.
template <int D, int BKV>
__device__ __forceinline__ void pv_issue(float (&acc)[D / 64][32],
                                         const uint32_t (&pa)[BKV / 16][PARITY_P_PARTS][4],
                                         float (&t)[32], const uint8_t* v) {
  constexpr int KS = BKV / 16, NS = D / 64, NP = PARITY_P_PARTS;
  if constexpr (PARITY_PV_FRESH > 0) {
    constexpr int F = PARITY_PV_FRESH < KS ? PARITY_PV_FRESH : KS;  // k16 steps a chain
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
            wgmma_rs<64>(t, pa[j][i], mn_desc(v + sl * BKV * 128 + j * 2048),
                         j > c * F || i > 0);
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
          wgmma_rs<64>(acc[sl], pa[j][i], mn_desc(v + sl * BKV * 128 + j * 2048), 1);
    wgmma_commit();
    fence_regs(acc);
  }
}

// Once pv_issue's groups have retired: the last fresh group's sums (the
// last slice's), or the chained sums in acc pinned after the wait.
template <int D>
__device__ __forceinline__ void pv_finish(float (&acc)[D / 64][32], float (&t)[32]) {
  if constexpr (PARITY_PV_FRESH > 0) {
    fence_regs(t);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[D / 64 - 1][i] += t[i];
  } else {
    fence_regs(acc);
  }
}

// One online-softmax step over a warpgroup's scores in the wgmma layout
// (s[4n + e]: rows g, g + 8 for e / 2 = 0, 1 of keys 8n + 2t4 + e % 2;
// masked entries already -inf), the scaled scores being sc·s (sc the
// softmax scale, or 1 where the softcap applied it): updates the running
// max m of sc·s and this thread's share of the row sums l, leaves
// exp(sc·s - m) in s (fmaf: one rounding before the exponential), and
// gives the factor alpha by which the caller rescales acc (1 where a row's
// max held) once the products in flight into it have retired.  A row with
// no live key so far keeps m = -inf, l = 0.
template <int NT>
__device__ __forceinline__ void softmax_stats(float (&s)[NT * 4], float sc, float (&m)[2],
                                              float (&l)[2], float (&alpha)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = -INFINITY;
#pragma unroll
    for (int n = 0; n < NT; ++n) mx = fmaxf(mx, fmaxf(s[4 * n + 2 * h], s[4 * n + 2 * h + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_old = m[h], m_new = fmaxf(m_old, mx * sc);
    const float m_use = m_new == -INFINITY ? 0.f : m_new;  // exp(-inf - 0) = 0
    alpha[h] = m_new == m_old ? 1.f : exp_tc(m_old - m_use);
    m[h] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      s[4 * n + 2 * h] = exp_tc(fmaf(s[4 * n + 2 * h], sc, -m_use));
      s[4 * n + 2 * h + 1] = exp_tc(fmaf(s[4 * n + 2 * h + 1], sc, -m_use));
      sum += s[4 * n + 2 * h] + s[4 * n + 2 * h + 1];
    }
    l[h] = l[h] * alpha[h] + sum;
  }
}

template <int D>
__global__ void __launch_bounds__(WG_THREADS, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v, FlashArgs a) {
  using bf16 = __nv_bfloat16;
  using Tiles = WgTiles<D>;
  constexpr int BKV = Tiles::BKV, NT = BKV / 8, NS = D / 64, KS = BKV / 16;
  constexpr int NP = PARITY_P_PARTS, ST = WG_STAGES;
  constexpr int QC = PARITY_QK_CHAIN < D / 16 ? PARITY_QK_CHAIN : D / 16;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sK = sQ + Tiles::Q_BYTES;
  uint8_t* sV = sK + ST * Tiles::KV_BYTES;
  uint64_t* qbar = reinterpret_cast<uint64_t*>(sV + ST * Tiles::KV_BYTES);
  uint64_t* full_k = qbar + 1;
  uint64_t* full_v = full_k + ST;
  uint64_t* empty = full_v + ST;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ_WG;  // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.K);
  const int len = max(0, a.lengths ? min(a.lengths[b], a.Skv) : a.Skv);
  // The kv range that can hold an unmasked key for some row of this block.
  const int q_last = min(q0 + BQ_WG, a.Sq) - 1;
  int kv_end = len;
  if (a.causal) kv_end = min(kv_end, q_last + 1);
  int kv_begin = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  kv_begin -= kv_begin % BKV;
  const int ntiles = kv_begin < kv_end ? (kv_end - kv_begin + BKV - 1) / BKV : 0;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty[s], 8);  // one release a consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {  // the producer: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256 && ntiles > 0) {
      mbar_expect_tx(qbar, Tiles::Q_BYTES);
      for (int c = 0; c < NS; ++c)
        tma_load_4d(sQ + c * BQ_WG * 128, &tm_q, qbar, 64 * c, q0, h, b);
      for (int i = 0; i < ntiles; ++i) {
        const int st = i % ST, k0 = kv_begin + i * BKV;
        mbar_wait(&empty[st], ((i / ST) & 1) ^ 1);  // the first round passes
        uint8_t* kt = sK + st * Tiles::KV_BYTES;
        uint8_t* vt = sV + st * Tiles::KV_BYTES;
        mbar_expect_tx(&full_k[st], Tiles::KV_BYTES);
        for (int c = 0; c < NS; ++c)
          tma_load_4d(kt + c * BKV * 128, &tm_k, &full_k[st], 64 * c, k0, kvh, b);
        mbar_expect_tx(&full_v[st], Tiles::KV_BYTES);
        for (int c = 0; c < NS; ++c)
          tma_load_4d(vt + c * BKV * 128, &tm_v, &full_v[st], 64 * c, k0, kvh, b);
      }
    }
  } else {  // consumers: rows q0 + 64 wg .. + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int w0 = q0 + WG_ROWS * wg + 16 * warp;  // this warp's rows: w0 + g and w0 + g + 8
    // acc[c][4j + e]: rows g, g + 8 (e / 2) of columns 64c + 8j + 2t4 + e % 2
    float acc[NS][32], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int c = 0; c < NS; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
    uint32_t pa[KS][NP][4];  // P of the tile before, in bf16 parts
    const uint8_t* q = sQ + wg * WG_ROWS * 128;

    // S(n) = Q·K(n)ᵀ: wait for K(n), issue in this warpgroup's turn
    auto issue_qk = [&](int n, float (&s)[BKV / 2], float (&u)[BKV / 2]) {
      mbar_wait(&full_k[n % ST], (n / ST) & 1);
      named_sync(PINGPONG + wg);
      qk_issue<D, BKV>(s, u, q, sK + (n % ST) * Tiles::KV_BYTES);
    };
    auto issue_pv = [&](int n, float (&t)[32]) {
      mbar_wait(&full_v[n % ST], (n / ST) & 1);
      pv_issue<D, BKV>(acc, pa, t, sV + (n % ST) * Tiles::KV_BYTES);
    };
    // S(n) retired (fenced): the chains summed, scaled and capped where the
    // softcap is on, masked, then the online softmax (the scale, where it
    // is still due, in its exponent; alpha for acc)
    auto softmax = [&](int n, float (&s)[BKV / 2], float (&u)[BKV / 2], float (&alpha)[2]) {
      if constexpr (D / 16 > QC) {
#pragma unroll
        for (int i = 0; i < BKV / 2; ++i) s[i] += u[i];
      }
      float sc = a.sm_scale;  // what the scores still want; the softcap takes it
      if (a.softcap > 0.f) {
#pragma unroll
        for (int i = 0; i < BKV / 2; ++i) s[i] = capped_tc(s[i] * a.sm_scale, a.softcap);
        sc = 1.f;
      }
      const int kb = kv_begin + n * BKV;
      // every (row, key) of this tile live for this warp's rows?
      const bool full = kb + BKV <= len && (!a.causal || kb + BKV - 1 <= w0) &&
                        (a.window <= 0 || kb > w0 + 15 - a.window);
      if (!full) {
#pragma unroll
        for (int i = 0; i < BKV / 2; ++i) {
          const int qi = w0 + g + 8 * ((i >> 1) & 1), kj = kb + 8 * (i >> 2) + 2 * t4 + (i & 1);
          if (!(kj < len && (!a.causal || kj <= qi) && (a.window <= 0 || kj > qi - a.window)))
            s[i] = -INFINITY;
        }
      }
      softmax_stats<NT>(s, sc, m, l, alpha);
    };
    // P(n) into bf16 parts: the A registers of key step j, rows g, g + 8 of
    // keys 16j + 2t4.., then of 16j + 8 + 2t4..
    auto to_parts = [&](const float (&s)[BKV / 2]) {
#pragma unroll
      for (int j = 0; j < KS; ++j) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          uint32_t part[NP];
          const int i = 8 * j + 4 * (r >> 1) + 2 * (r & 1);
          split_bf16<NP>(s[i], s[i + 1], part);
#pragma unroll
          for (int p = 0; p < NP; ++p) pa[j][p][r] = part[p];
        }
      }
    };
    auto release = [&](int n) {
      if (lane == 0) mbar_arrive(&empty[n % ST]);  // K(n) and V(n) read
    };

    if (ntiles > 0) {
      mbar_wait(qbar, 0);
      if (wg == 1) named_arrive(PINGPONG);  // warpgroup 0 issues first
      {  // tile 0: S(0) alone
        float s[BKV / 2], u[BKV / 2], alpha[2];
        issue_qk(0, s, u);
        named_arrive(PINGPONG + 1 - wg);  // the other's turn
        wgmma_wait<0>();
        fence_regs(s);
        if constexpr (D / 16 > QC) fence_regs(u);
        softmax(0, s, u, alpha);  // acc is zero: nothing to rescale
        to_parts(s);
      }
      // Tile n: S(n) issued, then P(n - 1)·V(n - 1), in this warpgroup's
      // turn; the softmax of S(n) runs while P(n - 1)·V(n - 1) retires and
      // the other warpgroup's products run.
#pragma unroll 1
      for (int n = 1; n < ntiles; ++n) {
        float s[BKV / 2], u[BKV / 2], t[32], alpha[2];
        issue_qk(n, s, u);
        issue_pv(n - 1, t);
        named_arrive(PINGPONG + 1 - wg);
        wgmma_wait<1>();
        fence_regs(s);
        if constexpr (D / 16 > QC) fence_regs(u);
        softmax(n, s, u, alpha);
        wgmma_wait<0>();
        fence_regs(pa);
        pv_finish<D>(acc, t);
        release(n - 1);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          if (alpha[hh] != 1.f) {
#pragma unroll
            for (int c = 0; c < NS; ++c)
#pragma unroll
              for (int j = 0; j < 8; ++j) {
                acc[c][4 * j + 2 * hh] *= alpha[hh];
                acc[c][4 * j + 2 * hh + 1] *= alpha[hh];
              }
          }
        }
        to_parts(s);
      }
      {  // P(last)·V(last) alone
        float t[32];
        named_sync(PINGPONG + wg);
        issue_pv(ntiles - 1, t);
        if (wg == 0) named_arrive(PINGPONG + 1);
        wgmma_wait<0>();
        pv_finish<D>(acc, t);
        release(ntiles - 1);
      }
    }
    bf16* O = static_cast<bf16*>(a.o) + b * a.o_sb + h * a.o_sh;
    const int64_t head = (int64_t)b * a.H + h;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
      const int qi = w0 + g + 8 * hh;
      // every row of the block, to the pitch: a row with no key P = 0
      if (a.lse && t4 == 0)
        a.lse[head * a.stats_pitch + qi] = l[hh] > 0.f ? m[hh] + logf(l[hh]) : kNoKey;
      if (qi >= a.Sq) continue;
      const float inv = l[hh] > 0.f ? 1.f / l[hh] : 0.f;  // a row with no key → 0
      bf16* dst = O + (int64_t)qi * a.o_ss + 2 * t4;
      float* dst32 = a.o32 ? a.o32 + (head * a.Sq + qi) * D + 2 * t4 : nullptr;
#pragma unroll
      for (int c = 0; c < NS; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float x0 = acc[c][4 * j + 2 * hh] * inv, x1 = acc[c][4 * j + 2 * hh + 1] * inv;
          *reinterpret_cast<__nv_bfloat162*>(dst + 64 * c + 8 * j) = __floats2bfloat162_rn(x0, x1);
          if (dst32) *reinterpret_cast<float2*>(dst32 + 64 * c + 8 * j) = make_float2(x0, x1);
        }
    }
  }
}

template <int D>
cudaError_t launch_f32(const FlashArgs& a, int B, cudaStream_t stream) {
  const size_t smem = flash_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_f32_kernel<float, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + BQ - 1) / BQ, a.H, B);
  flash_f32_kernel<float, D><<<grid, NTHREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_wgmma(const FlashArgs& a, int B, cudaStream_t stream) {
  using Tiles = WgTiles<D>;
  CUtensorMap tq, tk, tv;
  if (!head_map(&tq, a.q, D, a.Sq, a.H, B, a.q_ss, a.q_sh, a.q_sb, BQ_WG) ||
      !head_map(&tk, a.k, D, a.Skv, a.K, B, a.k_ss, a.k_sh, a.k_sb, Tiles::BKV) ||
      !head_map(&tv, a.v, D, a.Skv, a.K, B, a.v_ss, a.v_sh, a.v_sb, Tiles::BKV))
    return cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, Tiles::SMEM);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((a.Sq + BQ_WG - 1) / BQ_WG, a.H, B);
  flash_wgmma_kernel<D><<<grid, WG_THREADS, Tiles::SMEM, stream>>>(tq, tk, tv, a);
  return cudaGetLastError();
}

cudaError_t launch_d(const FlashArgs& a, int B, int d, int dtype, cudaStream_t stream) {
  if (dtype == 0) {
    switch (d) {
      case 64: return launch_f32<64>(a, B, stream);
      case 128: return launch_f32<128>(a, B, stream);
      case 256: return launch_f32<256>(a, B, stream);
    }
  } else if (dtype == 1) {
    switch (d) {
      case 64: return launch_wgmma<64>(a, B, stream);
      case 128: return launch_wgmma<128>(a, B, stream);
      case 256: return launch_wgmma<256>(a, B, stream);
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace repro_torch

// strides: 12 element strides (b, head, seq) of q, k, v, out in that order;
// the head dimension must be contiguous and rows 16-byte aligned.
// dtype: 0 = float32, 1 = bfloat16.  o32 and lse (bf16 only, both or
// neither): the backward's state, (B, H, Sq, d) and (B, H, ceil(Sq / 128)
// · 128) fp32, contiguous; out keeps its bits either way.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   float* o32, float* lse, const int* lengths,
                                   const long long* strides, int B, int H, int K, int Sq,
                                   int Skv, int d, int dtype, int causal, int window,
                                   float softcap, float sm_scale, void* stream) {
  using namespace repro_torch;
  if ((o32 || lse) && (dtype != 1 || !o32 || !lse)) return (int)cudaErrorInvalidValue;
  FlashArgs a;
  a.q = q; a.k = k; a.v = v; a.o = o; a.lengths = lengths;
  a.o32 = o32; a.lse = lse; a.stats_pitch = (Sq + BQ_WG - 1) / BQ_WG * BQ_WG;
  a.q_sb = strides[0]; a.q_sh = strides[1]; a.q_ss = strides[2];
  a.k_sb = strides[3]; a.k_sh = strides[4]; a.k_ss = strides[5];
  a.v_sb = strides[6]; a.v_sh = strides[7]; a.v_ss = strides[8];
  a.o_sb = strides[9]; a.o_sh = strides[10]; a.o_ss = strides[11];
  a.H = H; a.K = K; a.Sq = Sq; a.Skv = Skv; a.causal = causal; a.window = window;
  a.softcap = softcap; a.sm_scale = sm_scale;
  return (int)launch_d(a, B, d, dtype, static_cast<cudaStream_t>(stream));
}
