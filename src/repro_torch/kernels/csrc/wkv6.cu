// RWKV6 WKV recurrence on Hopper (sm_90a), per (batch, head) with head size
// N = 64 or 32 and an N x N fp32 state:
//
//   o_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
//   S_t = diag(e^{w_t}) S_{t-1} + k_t v_t^T
//
// Replaces the Pallas TPU kernel src/repro/kernels/wkv6.py :: wkv6
// (_wkv_kernel).  Same function: r, k, v (B, S, H, N) in bf16 or fp32, logw
// (B, S, H, N), u (H, N) and s0 (B, H, N, N) in fp32; out (B, S, H, N) in the
// type of r and the final state (B, H, N, N) in fp32.  Any S, with no
// S % chunk condition.
//
// What bounds it on this card.  The sequential recurrence does 5N^2 + 4N
// fp32 operations a step, 80 a byte read, above the H100's 67 fp32 TFLOP/s /
// 3.35 TB/s = 20, and its steps are serial.  The chunked form (the TPU
// kernel's algorithm) puts most of those operations on the tensor cores and
// makes the chunks parallel, after which the bytes (r, k, v, logw and out
// once) are the bound.
//
// The chunked form, within a chunk of T steps with incoming state S, values
// V and e_j = e^{w_j}:
//   o  = (r ⊙ Π_{j<t} e_j) S  +  A V
//   S' = e^{Σ_j w_j} ⊙ S  +  (k ⊙ Π_{j>s} e_j)^T V
//   A[t, s] = Σ_d r_td k_sd Π_{s<j<t} e_jd (s < t),  A[t, t] = Σ_d r_td u_d k_td.
// Every decay is a running product of factors e_j ≤ 1 (no e^{-Σ w}, no
// division), so none exceeds 1; a product below fp32's range underflows to
// 0, as the true decay does.  Only the chunk's own decay, carried from chunk
// to chunk, is e^{Σ w} of a double sum rounded once, so that its error does
// not grow with T.  Parallel over the sequence: each (b, h) is cut into P
// segments of Lc chunks (wkv6.py's planners).  Up to three launches: a
// segment pass runs every segment but the last from a zero state to its
// contribution U_p and its decay d_p = e^{Σ w}; wkv6_chain_kernel chains
// them per (b, h), S_{p+1} = d_p ⊙ S_p + U_p, elementwise on N x N and
// sequential over P; an output pass runs every segment from its incoming
// state, writing the outputs, and the last one the final state.
//
// bf16 at N = 64 (rwkv6-7b's heads): wkv6_wgmma_kernel, T = 64.  The tf32
// kernel below took 1.35 ms at rwkv6-7b's prefill against a 0.37 ms bound,
// latency-bound at two blocks of 4 warps an SM: every phase of a 32-step
// chunk (the conversion to fp32, the serial column walks on half the
// threads, A, the products, the state update) waited on the one before it
// behind a block-wide barrier, and the segment pass read k, v and logw a
// second time.  This kernel runs the phases of successive chunks on warps of
// their own, one block of 16 warps an SM:
// - A producer thread keeps two rings in flight by TMA, from tensor maps
//   over the (B, S, H, 64) views, steps past S read as zeros: r, k (bf16, as
//   stored, 128-byte swizzle) and logw (fp32), released by the prep warps,
//   and v, released by the MMA warpgroup once its products retire.
// - Eight prep warps take e^w in place and the chunk's Σ w (double), then
//   the column walks, a thread a column and a half of the chunk (rd: r ⊙ Π e
//   from the half's start; kd: k ⊙ Π e to the half's end; the halves'
//   decays e0 and e1), then A within each half on the CUDA cores: lane (s,
//   column group of 8) walks the steps t of the half from s's block of 8 on
//   with k_s ⊙ Π_{s<j<t} e_j, the groups' sums added across lanes; a warp
//   takes four s of the blocks b and 3 - b (40 steps).  They fill one of
//   two slots of fp32 tiles for the MMA warpgroup.
// - The MMA warpgroup first forms A below the halves (rows 32.. against
//   columns ..31) on mma.sync tf32 in three passes as rd (second half) · kd
//   (first half)ᵀ, the pair's decay cut at step 32 into two factors ≤ 1,
//   then runs the three products as wgmma m64n64k16 in bf16: kdᵀ·V and A·V
//   with A from registers (the fp32 factor in three bf16 parts, 24 bits, as
//   K1 splits P) and V read from its stage as an MN-major B (exact in bf16);
//   rd·S with rd in three parts from registers and S in three bf16 parts in
//   shared memory (the six products of order ≥ 2^-18; the three dropped sum
//   below 2^-26 of |rd|·|S|, u/4).  The first half's kd is decayed by e1 and
//   the second half's rd by e0 as the fragments are loaded.  The state stays
//   in its registers across chunks, S = dT ⊙ S + P in IEEE fp32 with P =
//   kdᵀ·V summed from zero a chunk, and is split into its parts for the next
//   chunk's product.
// - Full and empty mbarriers for the rings and the slots, named barriers
//   within the prep warps and within the MMA warpgroup.  setmaxnreg: 216
//   registers an MMA thread, 136 a prep thread, 24 the producer's; no spill.
//   At rwkv6-7b's prefill (B·H = 256 ≥ 132 SMs) the planner takes one
//   segment a (b, h), so no input is read twice.
// What bounds it now (the clock64 stamps of a WKV_PROF build of one block at
// rwkv6-7b's row, parity_probe.py --kernel wkv6; PERF.md): a chunk takes
// ~12.7k cycles, set by the prep warps, of which A's walk within the halves
// takes ~9.0k; the MMA warpgroup is busy ~10.2k of them (A below the halves
// and the fragments ~5.9k, the state's parts and the outputs ~2.4k, its 48
// wgmma retiring within ~0.26k of the last issue).  CUDA-core work on few
// warps binds, not the tensor cores or the bytes.
//
// fp32 and N = 32 (the calibration sweep; the ~100M config's heads of 16,
// padded): the tf32 kernels, T = 32.  The three products run on mma.sync
// m16n8k8 tf32 with each fp32 operand split into a tf32 part and the tf32
// rounding of what it leaves: three products a step (WKV_TF32_PASSES), two
// where the other operand is a bf16 v, which tf32 holds exactly; each k8
// step summed from zero and added in IEEE fp32.  One tf32 product keeps 11
// bits, short of the fp32 state carried over 147 chunks.  A: its four
// diagonal 8 x 8 blocks on the CUDA cores, N/4 columns d a warp, lane s
// walking the 8 steps t of its block with k_s ⊙ Π_{s<j<t} e_j (one multiply
// a pair and column, no exponential); every block below them on the tensor
// cores, as (r_t Π_{b<=j<t} e_j)(k_s Π_{s<j<b} e_j)^T at a block boundary b
// between s and t, both factors ≤ 1; the four warps' partial sums added.
// Resources (ptxas, N = 64 fp32): the output kernel 4 warps, 246 registers
// a thread, no spills, 109 KiB of shared memory (a chunk's r, k, v, logw,
// e^w, decayed r and k, the factors of A's lower blocks, A and its per-warp
// partial sums, and the state), two blocks an SM; the next chunk's inputs
// are loaded into registers while the current one is computed.  Loads that
// follow shared-memory stores are issued ahead of them in batches: the
// compiler cannot tell the arrays apart, and each load would otherwise wait
// for the store before it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

// tf32 products per operand product: 1 (big·big), 2 (+ small_a·big_b) or 3
// (+ big_a·small_b), smallest first; WKV_OUT_TF32_PASSES for the two
// products that give the outputs (r_dec·S and A·V) alone
#ifndef WKV_TF32_PASSES
#define WKV_TF32_PASSES 3
#endif
#ifndef WKV_OUT_TF32_PASSES
#define WKV_OUT_TF32_PASSES WKV_TF32_PASSES
#endif
static_assert(WKV_TF32_PASSES >= 1 && WKV_TF32_PASSES <= 3, "1, 2 or 3 tf32 passes");
static_assert(WKV_OUT_TF32_PASSES >= 1 && WKV_OUT_TF32_PASSES <= 3, "1, 2 or 3 tf32 passes");

namespace repro_torch {
namespace {

constexpr int T = 32;       // steps per chunk
constexpr int Q = 8;        // A's diagonal blocks: Q x Q, walked on the CUDA cores
constexpr int H2 = T / 2;
constexpr int WARPS = 4, THREADS = 32 * WARPS;

// Row pitches (floats) make the mma fragment reads conflict-free: arrays
// read as A operands row by row (rd, a) have pitch ≡ 4 (mod 32), those read
// as B operands or transposed A operands (kd, v, s) ≡ 8 (mod 32).
template <int N>
struct Smem {
  float r[T][N + 4];          // r, [t][d]
  float rd[T][N + 4];         // r_t ⊙ Π_{j<t} e^{w_j}
  float rh[H2][N + 4];        // r_t ⊙ Π_{H2<=j<t} e^{w_j}, t = H2 + row
  float rq[H2][N + 4];        // r_t ⊙ Π_{b<=j<t} e^{w_j}, t = Q + row (b = Q) and
                              // t = 3Q + row - Q (b = 3Q)
  float k[T][N + 4];          // k, [s][d]; then k_s ⊙ Π_{s<j<b} e^{w_j}, b the end
                              // of s's block of Q (of H2 for Q <= s < H2)
  float p8[N];                // Π_{Q<=j<H2} e^{w_j}
  float kd[T][N + 8];         // k_s ⊙ Π_{j>s} e^{w_j}
  float v[T][N + 8];          // v, [s][e]
  float w[T][N + 4];          // logw
  float ew[T][N + 4];         // e^{logw}
  float ap[WARPS][T][T + 1];  // A's partial sums, one set per warp
  float a[T][T + 4];          // A, [t][s]
  float s[N][N + 8];          // the state, [d][e]
  float dT[N];                // the chunk's decay e^{Σ_j w_j}
  float u[N];                 // the head's bonus u
};

// acc += a · b for one k8 step: a (16 x 8) given as its four fp32 fragment
// values, b (8 x 8) as its two; the product is summed from zero in PASSES
// tf32 products, smallest first, and added to acc in IEEE fp32.  With B_EXACT, b holds bf16 values, which tf32 represents exactly:
// the pass on b's small part is 0 and is skipped.  Fragments
// (g = lane / 4, q = lane % 4): a = {(g, q), (g + 8, q), (g, q + 4),
// (g + 8, q + 4)}, b = {(k q, n g), (k q + 4, n g)}, acc = {(g, 2q),
// (g, 2q + 1), (g + 8, 2q), (g + 8, 2q + 1)}.
template <bool B_EXACT = false, int PASSES = WKV_TF32_PASSES>
__device__ __forceinline__ void mma3(float (&acc)[4], const FragA& a, float b0f, float b1f) {
  uint32_t bb0, bs0, bb1, bs1;
  if constexpr (B_EXACT) {  // b holds a bf16 value: its tf32 rounding is itself
    bb0 = __float_as_uint(b0f);
    bb1 = __float_as_uint(b1f);
  } else {
    tf32_split(b0f, bb0, bs0);
    tf32_split(b1f, bb1, bs1);
  }
  float d[4];
  constexpr int SMALL = PASSES - 1 - (B_EXACT && PASSES == 3 ? 1 : 0);
  if constexpr (SMALL == 0) {
    mma_tf32_fresh(d, a.big, bb0, bb1);
  } else {
    if constexpr (SMALL == 2) {
      mma_tf32_fresh(d, a.big, bs0, bs1);
      mma_tf32(d, a.small, bb0, bb1);
    } else {
      mma_tf32_fresh(d, a.small, bb0, bb1);
    }
    mma_tf32(d, a.big, bb0, bb1);
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += d[e];
}

// A chunk's inputs in flight: r (when R), k, v and logw of steps t0 ..
// t0 + T - 1, 16 bytes a load, zeros past S.
template <typename Tin, int N, bool R>
struct Chunk {
  static constexpr int VEC = 16 / sizeof(Tin);     // elements of r, k, v a load
  static constexpr int NV = T * N / VEC / THREADS;  // loads of r, k or v a thread
  static constexpr int NW = T * N / 4 / THREADS;    // loads of logw a thread
  uint4 r[R ? NV : 1], k[NV], v[NV], w[NW];

  // element (t, d) of the head at `head` ([b, 0, h, 0]), rows H·N apart
  __device__ __forceinline__ void fetch(const Tin* rp, const Tin* kp, const Tin* vp,
                                        const float* wp, int64_t head, int64_t row, int t0,
                                        int S) {
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int idx = threadIdx.x + i * THREADS, t = idx / (N / VEC), d = idx % (N / VEC) * VEC;
      const int64_t off = head + (int64_t)(t0 + t) * row + d;
      const bool ok = t0 + t < S;
      if constexpr (R) r[i] = ok ? *reinterpret_cast<const uint4*>(rp + off) : zero;
      k[i] = ok ? *reinterpret_cast<const uint4*>(kp + off) : zero;
      v[i] = ok ? *reinterpret_cast<const uint4*>(vp + off) : zero;
    }
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      const int idx = threadIdx.x + i * THREADS, t = idx / (N / 4), d = idx % (N / 4) * 4;
      w[i] = t0 + t < S ? *reinterpret_cast<const uint4*>(wp + head + (int64_t)(t0 + t) * row + d)
                        : zero;
    }
  }

  __device__ __forceinline__ void stash(Smem<N>& sm) const {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int idx = threadIdx.x + i * THREADS, t = idx / (N / VEC), d = idx % (N / VEC) * VEC;
      if constexpr (R) put(&sm.r[t][d], r[i]);
      put(&sm.k[t][d], k[i]);
      put(&sm.v[t][d], v[i]);
    }
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      const int idx = threadIdx.x + i * THREADS, t = idx / (N / 4), d = idx % (N / 4) * 4;
      const float4 x = *reinterpret_cast<const float4*>(&w[i]);
      *reinterpret_cast<float4*>(&sm.w[t][d]) = x;
      *reinterpret_cast<float4*>(&sm.ew[t][d]) =
          make_float4(expf(x.x), expf(x.y), expf(x.z), expf(x.w));
    }
  }

  // VEC elements of r, k or v as floats, 16 bytes a store
  static __device__ __forceinline__ void put(float* dst, const uint4& raw) {
    const Tin* e = reinterpret_cast<const Tin*>(&raw);
#pragma unroll
    for (int j = 0; j < VEC; j += 4)
      *reinterpret_cast<float4*>(dst + j) =
          make_float4(to_f(e[j]), to_f(e[j + 1]), to_f(e[j + 2]), to_f(e[j + 3]));
  }
};

// Column d walked from the chunk's end: kd[s] = k[s] Π_{j>s} e^{w_j}, a
// running product.
template <int N>
__device__ __forceinline__ void suffix_column(Smem<N>& sm, int d) {
  float f = 1.f;
  for (int s0 = T - 8; s0 >= 0; s0 -= 8) {  // loads of 8 steps, then their stores
    float k[8], ew[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      k[i] = sm.k[s0 + i][d];
      ew[i] = sm.ew[s0 + i][d];
    }
#pragma unroll
    for (int i = 7; i >= 0; --i) {
      sm.kd[s0 + i][d] = k[i] * f;
      f *= ew[i];
    }
  }
}

// Column d's chunk decay dT = e^{Σ_j w_j}, the sum taken in double (exact
// for fp32 inputs of any realistic spread, so its order is free: a tree of
// 8 steps at a time) and rounded once, as the state carries it from chunk
// to chunk.  Returns the sum.
template <int N>
__device__ __forceinline__ double decay_column(Smem<N>& sm, int d) {
  double ls = 0.0;
  for (int t0 = 0; t0 < T; t0 += 8) {
    double w2[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w2[i] = (double)sm.w[t0 + 2 * i][d] + (double)sm.w[t0 + 2 * i + 1][d];
    ls += (w2[0] + w2[1]) + (w2[2] + w2[3]);
  }
  sm.dT[d] = expf((float)ls);
  return ls;
}

// Column d walked from the chunk's start, running products of e^{w}:
// rd[t] = r[t] Π_{j<t}; for t >= H2, rh[t - H2] = r[t] Π_{H2<=j<t}; for t in
// the second and fourth block of Q, rq = r[t] Π_{b<=j<t} from the block's
// start b; and p8 = Π_{Q<=j<H2}.
template <int N>
__device__ __forceinline__ void prefix_column(Smem<N>& sm, int d) {
  float e = 1.f, eh = 1.f;
#pragma unroll
  for (int t0 = 0; t0 < T; t0 += Q) {  // loads of Q steps, then their stores
    float r[Q], ew[Q];
#pragma unroll
    for (int i = 0; i < Q; ++i) {
      r[i] = sm.r[t0 + i][d];
      ew[i] = sm.ew[t0 + i][d];
    }
    float eq = 1.f;
#pragma unroll
    for (int i = 0; i < Q; ++i) {
      sm.rd[t0 + i][d] = r[i] * e;
      e *= ew[i];
      if (t0 >= H2) {
        sm.rh[t0 + i - H2][d] = r[i] * eh;
        eh *= ew[i];
      }
      if (t0 % H2 == Q) {
        sm.rq[t0 / H2 * Q + i][d] = r[i] * eq;
        eq *= ew[i];
      }
    }
    if (t0 == Q) sm.p8[d] = eq;
  }
}

// A[t][s] for the chunk into sm.a.  The diagonal blocks of Q x Q on the
// CUDA cores: warp wp takes columns d of [wp DW, (wp + 1) DW), and lane s
// walks the Q steps t of its own block with kD = k_s ⊙ Π_{s<j<t} e^{w_j}
// (0 until t = s, so the t < s half comes out 0, and the bonus Σ_d r u k
// at t = s).  Every block below the diagonal on the tensor cores, as a
// product of two factors that are both ≤ 1, so it cannot overflow: with b a
// block boundary between s and t, A[t][s] = Σ_d (r_t Π_{b<=j<t} e^w)
// (k_s Π_{s<j<b} e^w), the second factor what lane s's walk ends with
// (times p8 for s < Q against rows past H2).  The four warps' partial sums
// are then added, and the entries above the diagonal set to 0.
template <int N>
__device__ __forceinline__ void intra_chunk(Smem<N>& sm, int warp, int lane) {
  constexpr int DW = N / WARPS;
  const int d0 = warp * DW, s = lane, t0 = lane & ~(Q - 1);
  float kr[DW], kD[DW], bonus = 0.f;
#pragma unroll
  for (int i = 0; i < DW; ++i) {
    kr[i] = sm.k[s][d0 + i];
    kD[i] = 0.f;
    bonus = fmaf(sm.r[s][d0 + i], sm.u[d0 + i] * kr[i], bonus);  // Σ r u k, t = s
  }
  float res[Q];  // stored after the walk, so no store stalls its loads
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    const int t = t0 + i;
    const float4* r4 = reinterpret_cast<const float4*>(&sm.r[t][d0]);
    const float4* e4 = reinterpret_cast<const float4*>(&sm.ew[t][d0]);
    float dot[4] = {0.f, 0.f, 0.f, 0.f};  // four chains for latency
    const float on = t == s ? 1.f : 0.f;
#pragma unroll
    for (int i4 = 0; i4 < DW / 4; ++i4) {
      const float4 x = r4[i4], e = e4[i4];
      dot[0] = fmaf(x.x, kD[4 * i4], dot[0]);
      dot[1] = fmaf(x.y, kD[4 * i4 + 1], dot[1]);
      dot[2] = fmaf(x.z, kD[4 * i4 + 2], dot[2]);
      dot[3] = fmaf(x.w, kD[4 * i4 + 3], dot[3]);
      kD[4 * i4] = fmaf(on, kr[4 * i4], kD[4 * i4] * e.x);
      kD[4 * i4 + 1] = fmaf(on, kr[4 * i4 + 1], kD[4 * i4 + 1] * e.y);
      kD[4 * i4 + 2] = fmaf(on, kr[4 * i4 + 2], kD[4 * i4 + 2] * e.z);
      kD[4 * i4 + 3] = fmaf(on, kr[4 * i4 + 3], kD[4 * i4 + 3] * e.w);
    }
    res[i] = t == s ? bonus : (dot[0] + dot[1]) + (dot[2] + dot[3]);
  }
#pragma unroll
  for (int i = 0; i < Q; ++i) sm.ap[warp][t0 + i][s] = res[i];
#pragma unroll
  for (int i = 0; i < DW; ++i) sm.k[s][d0 + i] = kD[i];  // k_s Π_{s<j<t0+Q} e^w
  __syncwarp();
  const int g = lane >> 2, q = lane & 3;
  // rows H2.. (rh) against s < Q (k row s times p8) and Q <= s < H2
  float lo[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  // rows Q.. and 3Q.. (rq) against s < Q and 2Q <= s < 3Q: half of each
  // product is wanted
  float hi[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
  for (int ks = 0; ks < DW / 8; ++ks) {
    const int d = d0 + 8 * ks + q;
    const float p0 = sm.p8[d], p4 = sm.p8[d + 4];
    const float x[4] = {sm.rh[g][d], sm.rh[g + 8][d], sm.rh[g][d + 4], sm.rh[g + 8][d + 4]};
    const float xp[4] = {x[0] * p0, x[1] * p0, x[2] * p4, x[3] * p4};
    mma3(lo[0], FragA(xp), sm.k[g][d], sm.k[g][d + 4]);
    mma3(lo[1], FragA(x), sm.k[Q + g][d], sm.k[Q + g][d + 4]);
    const float y[4] = {sm.rq[g][d], sm.rq[g + 8][d], sm.rq[g][d + 4], sm.rq[g + 8][d + 4]};
    const FragA b(y);
    mma3(hi[0], b, sm.k[g][d], sm.k[g][d + 4]);
    mma3(hi[1], b, sm.k[2 * Q + g][d], sm.k[2 * Q + g][d + 4]);
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = 8 * j + 2 * q + (c & 1), h = c >> 1;
      sm.ap[warp][H2 + g + 8 * h][col] = lo[j][c];
    }
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    sm.ap[warp][Q + g][2 * q + c] = hi[0][c];                  // rows Q.., s < Q
    sm.ap[warp][3 * Q + g][2 * Q + 2 * q + c] = hi[1][2 + c];  // rows 3Q.., 2Q <= s
  }
  __syncthreads();
  constexpr int PER = T * T / THREADS;
  float sum[PER];  // every load before the first store
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int idx = threadIdx.x + i * THREADS, t = idx / T, c = idx % T;
    sum[i] = sm.ap[0][t][c];
#pragma unroll
    for (int p = 1; p < WARPS; ++p) sum[i] += sm.ap[p][t][c];
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int idx = threadIdx.x + i * THREADS, t = idx / T, c = idx % T;
    sm.a[t][c] = c <= t ? sum[i] : 0.f;  // nothing was written above the diagonal
  }
}

// The state's increment kd^T V (N x N, K = T) in mma accumulators: warp wp
// takes row tile MT_ of 16 d and NPW column tiles of 8 e from NT0.
template <int N, bool V_EXACT>
struct StateTiles {
  static constexpr int WPM = WARPS / (N / 16);    // warps on one row tile
  static constexpr int NPW = N / 8 / WPM;         // column tiles a warp
  float p[NPW][4];
  int mt, nt0;

  __device__ __forceinline__ void compute(const Smem<N>& sm, int warp, int lane) {
    const int g = lane >> 2, q = lane & 3;
    mt = warp / WPM;
    nt0 = warp % WPM * NPW;
#pragma unroll
    for (int j = 0; j < NPW; ++j) p[j][0] = p[j][1] = p[j][2] = p[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < T / 8; ++ks) {
      const int s = 8 * ks + q, d = 16 * mt + g;
      const float x[4] = {sm.kd[s][d], sm.kd[s][d + 8], sm.kd[s + 4][d], sm.kd[s + 4][d + 8]};
      const FragA a(x);
#pragma unroll
      for (int j = 0; j < NPW; ++j) {
        const int e = 8 * (nt0 + j) + g;
        mma3<V_EXACT>(p[j], a, sm.v[s][e], sm.v[s + 4][e]);
      }
    }
  }

  // S = dT ⊙ S + p, entry by entry (every read of S in this chunk is done)
  __device__ __forceinline__ void update(Smem<N>& sm, int lane) const {
    const int g = lane >> 2, q = lane & 3, d = 16 * mt + g;
    const float dt[2] = {sm.dT[d], sm.dT[d + 8]};
    float2 old[NPW][2];  // every load before the first store
#pragma unroll
    for (int j = 0; j < NPW; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        old[j][h] = *reinterpret_cast<const float2*>(&sm.s[d + 8 * h][8 * (nt0 + j) + 2 * q]);
#pragma unroll
    for (int j = 0; j < NPW; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(&sm.s[d + 8 * h][8 * (nt0 + j) + 2 * q]) =
            make_float2(fmaf(dt[h], old[j][h].x, p[j][2 * h]),
                        fmaf(dt[h], old[j][h].y, p[j][2 * h + 1]));
  }
};

// The chunk's outputs o = rd S + A V (T x N) into out: warp wp takes row
// tile wp % 2 of 16 t and N / 16 column tiles of 8 e.
template <typename Tin, int N>
__device__ __forceinline__ void outputs(const Smem<N>& sm, Tin* __restrict__ out, int64_t head,
                                        int64_t row, int t0, int S, int warp, int lane) {
  constexpr int NJ = N / 16;
  const int g = lane >> 2, q = lane & 3, mt = warp & 1, nt0 = (warp >> 1) * NJ;
  float o[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < N / 8; ++ks) {  // rd · S
    const int t = 16 * mt + g, d = 8 * ks + q;
    const float x[4] = {sm.rd[t][d], sm.rd[t + 8][d], sm.rd[t][d + 4], sm.rd[t + 8][d + 4]};
    const FragA a(x);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int e = 8 * (nt0 + j) + g;
      mma3<false, WKV_OUT_TF32_PASSES>(o[j], a, sm.s[d][e], sm.s[d + 4][e]);
    }
  }
#pragma unroll
  for (int ks = 0; ks < T / 8; ++ks) {  // A · V; A is 0 above its diagonal
    if (ks > 2 * mt + 1) break;
    const int t = 16 * mt + g, s = 8 * ks + q;
    const float x[4] = {sm.a[t][s], sm.a[t + 8][s], sm.a[t][s + 4], sm.a[t + 8][s + 4]};
    const FragA a(x);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int e = 8 * (nt0 + j) + g;
      mma3<sizeof(Tin) == 2, WKV_OUT_TF32_PASSES>(o[j], a, sm.v[s][e], sm.v[s + 4][e]);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = 16 * mt + g + 8 * h;
    if (t0 + t >= S) continue;
    Tin* dst = out + head + (int64_t)(t0 + t) * row;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int e = 8 * (nt0 + j) + 2 * q;
      if constexpr (sizeof(Tin) == 4) {
        *reinterpret_cast<float2*>(dst + e) = make_float2(o[j][2 * h], o[j][2 * h + 1]);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(dst + e) =
            __floats2bfloat162_rn(o[j][2 * h], o[j][2 * h + 1]);
      }
    }
  }
}

template <int N>
__device__ __forceinline__ void load_state(Smem<N>& sm, const float* __restrict__ src) {
  for (int idx = threadIdx.x; idx < N * N / 4; idx += THREADS) {
    const int d = idx / (N / 4), e = idx % (N / 4) * 4;
    *reinterpret_cast<float4*>(&sm.s[d][e]) = reinterpret_cast<const float4*>(src)[idx];
  }
}
template <int N>
__device__ __forceinline__ void store_state(const Smem<N>& sm, float* __restrict__ dst) {
  for (int idx = threadIdx.x; idx < N * N / 4; idx += THREADS) {
    const int d = idx / (N / 4), e = idx % (N / 4) * 4;
    reinterpret_cast<float4*>(dst)[idx] = *reinterpret_cast<const float4*>(&sm.s[d][e]);
  }
}

// Pass 1: segment p < P - 1 of (b, h) = (blockIdx.y, blockIdx.x) from a
// zero state → its contribution U_p (seg_state[b, h, p]) and its total decay
// d_p (seg_decay[b, h, p]).
template <typename Tin, int N>
__global__ void __launch_bounds__(THREADS, 2)
    wkv6_segment_kernel(const Tin* __restrict__ k, const Tin* __restrict__ v,
                        const float* __restrict__ logw, float* __restrict__ seg_state,
                        float* __restrict__ seg_decay, int S, int H, int P, int Lc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<N>& sm = *reinterpret_cast<Smem<N>*>(smem_raw);
  const int h = blockIdx.x, b = blockIdx.y, p = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t row = (int64_t)H * N, head = ((int64_t)b * S * H + h) * N;
  const int64_t slot = ((int64_t)b * H + h) * (P - 1) + p;
  for (int idx = threadIdx.x; idx < N * (N + 8); idx += THREADS) (&sm.s[0][0])[idx] = 0.f;
  double seg = 0.0;
  const int c0 = p * Lc, c1 = c0 + Lc;
  Chunk<Tin, N, false> in;
  in.fetch(nullptr, k, v, logw, head, row, c0 * T, S);
  for (int c = c0; c < c1; ++c) {
    in.stash(sm);
    __syncthreads();
    if (c + 1 < c1) in.fetch(nullptr, k, v, logw, head, row, (c + 1) * T, S);
    if (threadIdx.x < N) suffix_column(sm, threadIdx.x);
    else if (threadIdx.x < 2 * N) seg += decay_column(sm, threadIdx.x - N);
    __syncthreads();
    StateTiles<N, sizeof(Tin) == 2> st;
    st.compute(sm, warp, lane);
    st.update(sm, lane);  // no warp reads S before the update here
    __syncthreads();
  }
  store_state(sm, seg_state + slot * N * N);
  if (threadIdx.x >= N && threadIdx.x < 2 * N)
    seg_decay[slot * N + threadIdx.x - N] = expf((float)seg);
}

// Pass 2: the incoming state of every segment of (b, h), in place of the
// contributions: S_1 = d_0 ⊙ s0 + U_0, S_{p+1} = d_p ⊙ S_p + U_p.
template <int N>
__global__ void __launch_bounds__(256)
    wkv6_chain_kernel(const float* __restrict__ s0, float* __restrict__ seg_state,
                      const float* __restrict__ seg_decay, int H, int P) {
  constexpr int PER = N * N / 256;
  const int64_t bh = (int64_t)blockIdx.y * H + blockIdx.x;
  float s[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) s[i] = s0[bh * N * N + threadIdx.x + 256 * i];
  for (int p = 0; p < P - 1; ++p) {
    float* u = seg_state + (bh * (P - 1) + p) * N * N;
    const float* dec = seg_decay + (bh * (P - 1) + p) * N;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int idx = threadIdx.x + 256 * i;
      s[i] = fmaf(dec[idx / N], s[i], u[idx]);
      u[idx] = s[i];
    }
  }
}

// Pass 3: segment p of (b, h) from its incoming state (s0 for p = 0): the
// outputs of its steps, and after the last segment the final state.
template <typename Tin, int N>
__global__ void __launch_bounds__(THREADS, 2)
    wkv6_output_kernel(const Tin* __restrict__ r, const Tin* __restrict__ k,
                       const Tin* __restrict__ v, const float* __restrict__ logw,
                       const float* __restrict__ u, const float* __restrict__ s0,
                       const float* __restrict__ seg_state, Tin* __restrict__ out,
                       float* __restrict__ sf, int S, int H, int P, int Lc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<N>& sm = *reinterpret_cast<Smem<N>*>(smem_raw);
  const int h = blockIdx.x, b = blockIdx.y, p = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t row = (int64_t)H * N, head = ((int64_t)b * S * H + h) * N;
  const int64_t bh = (int64_t)b * H + h;
  load_state(sm, p == 0 ? s0 + bh * N * N : seg_state + (bh * (P - 1) + p - 1) * N * N);
  const int nchunks = (S + T - 1) / T;
  const int c0 = p * Lc, c1 = min(c0 + Lc, nchunks);
  if (threadIdx.x < N) sm.u[threadIdx.x] = u[(int64_t)h * N + threadIdx.x];
  Chunk<Tin, N, true> in;
  if (c0 < c1) in.fetch(r, k, v, logw, head, row, c0 * T, S);
  for (int c = c0; c < c1; ++c) {
    in.stash(sm);
    __syncthreads();
    if (c + 1 < c1) in.fetch(r, k, v, logw, head, row, (c + 1) * T, S);
    if (threadIdx.x < N) {
      prefix_column(sm, threadIdx.x);
    } else if (threadIdx.x < 2 * N) {
      suffix_column(sm, threadIdx.x - N);
      decay_column(sm, threadIdx.x - N);
    }
    __syncthreads();
    intra_chunk(sm, warp, lane);
    __syncthreads();
    outputs<Tin, N>(sm, out, head, row, c * T, S, warp, lane);
    StateTiles<N, sizeof(Tin) == 2> st;
    st.compute(sm, warp, lane);
    __syncthreads();  // every warp is done reading S
    st.update(sm, lane);
    __syncthreads();
  }
  if (p == P - 1) store_state(sm, sf + bh * N * N);
}

// ---- bf16 at N = 64 on wgmma fed by TMA (wkv6_wgmma_kernel) ----

constexpr int TW = 64;               // steps a chunk
constexpr int NW = 64;               // the head size
constexpr int WG_THREADS = 512;      // MMA warpgroup, two prep warpgroups, producer warpgroup
constexpr int PREP = 128, PREP_THREADS = 256, PRODUCER = 384;
constexpr int RKW_STAGES = 2;        // chunks of r, k and logw in their ring
constexpr int V_STAGES = 2;          // chunks of v in its ring (held until the products retire)
// named barriers: the prep warps', the MMA warpgroup's
constexpr int BAR_PREP = 1, BAR_MMA = 2;
// registers a thread after setmaxnreg (512 threads start with 128): the
// prep warps spill at 128; 136 for them leaves 216 for the MMA warpgroup,
// and neither spills
constexpr int PREP_REGS = 136, MMA_REGS = 216, PRODUCER_REGS = 24;
static_assert(128 * (MMA_REGS + PRODUCER_REGS) + 256 * PREP_REGS == 65536,
              "the SM's registers");
// Row pitches (floats) of the fp32 tiles: the MMA warpgroup reads rd and a
// as wgmma A fragments (a float2 of row g: pitch ≡ 8 mod 32 keeps a half
// warp on distinct banks) and kd transposed (column g of rows 2q..: pitch
// ≡ 4), which also serves the level-32 mma.sync reads of kd.
constexpr int LDR = NW + 8, LDK = NW + 4, LDA = TW + 8;

struct alignas(1024) RkwStage {
  uint8_t r[TW * 128], k[TW * 128];  // bf16 [t][d], 128-byte swizzle (TMA)
  float w[TW][NW];                    // logw, then e^{logw} in place
};
struct WgSlot {           // one chunk's operands, from the prep warps to the MMA warpgroup
  float rd[TW][LDR];      // r_t Π_{h<=j<t} e^{w_j}, h the start of t's half
  float kd[TW][LDK];      // k_s Π_{s<j<h'} e^{w_j}, h' the end of s's half; [s][d]
  float a[TW][LDA];       // A [t][s], 0 above the diagonal
  float e0[NW], e1[NW];   // Π e^{w_j} over the first half, over the second
  float dt[NW];           // the chunk's decay e^{Σ_j w_j}
};
struct alignas(1024) WgSmem {
  RkwStage st[RKW_STAGES];
  uint8_t v[V_STAGES][TW * 128];  // bf16 [s][e], 128-byte swizzle (TMA): wgmma's MN-major B
  uint8_t spart[3][NW * 128];     // the state S in three bf16 parts (smallest first), [d][e]
  WgSlot slot[2];
  double wsum[4][NW];             // a chunk's Σ logw over four quarters of its steps
  float u[NW];
  uint64_t rkw_full[RKW_STAGES], rkw_empty[RKW_STAGES], v_full[V_STAGES], v_empty[V_STAGES];
  uint64_t slot_full[2], slot_empty[2];
};
constexpr int WG_SMEM = sizeof(WgSmem) + 1024;  // and the 1024-byte alignment
static_assert(WG_SMEM <= 232448, "one block an SM");

// The state (the MMA warpgroup's accumulator layout, rows d, columns e) into
// its three bf16 parts in shared memory, each [d][e] in the 128-byte swizzle
// that wgmma reads as an MN-major B.
__device__ __forceinline__ void state_parts(WgSmem& sm, const float (&s)[32], int w, int g,
                                            int t4) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int d = 16 * w + g + 8 * h;
      uint32_t part[3];
      split_bf16<3>(s[4 * j + 2 * h], s[4 * j + 2 * h + 1], part);
      const int off = d * 128 + ((j ^ (d & 7)) << 4) + 4 * t4;
#pragma unroll
      for (int p = 0; p < 3; ++p) *reinterpret_cast<uint32_t*>(&sm.spart[p][off]) = part[p];
    }
}

// The wgmma A fragments (bf16 parts, smallest first) of a 64 x 64 fp32 tile
// read through x(row, col), a float2 of columns col and col + 1: for k16
// step j, rows 16w + g (+ 8) and columns 16j + 2t4 (+ 8).
template <typename Read>
__device__ __forceinline__ void a_parts(uint32_t (&frag)[4][3][4], int w, int g, int t4,
                                        Read&& x) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float2 v = x(16 * w + g + 8 * (r & 1), 16 * j + 2 * t4 + 8 * (r >> 1));
      uint32_t part[3];
      split_bf16<3>(v.x, v.y, part);
#pragma unroll
      for (int p = 0; p < 3; ++p) frag[j][p][r] = part[p];
    }
}

// Eight steps t0 .. t0 + 7 of A's walk within a half for lane (s, column
// group): with kD = k_s ⊙ Π_{s<j<t} e^{w_j} over its 8 columns, the partial
// sums Σ_d r_td kD_d, the bonus partial at t = s (DIAG: the lane's own
// block, where kD starts at t = s), then those of the 8 column groups added
// across lanes (xor 4, 8, 16) and stored by group 0.
template <bool DIAG>
__device__ __forceinline__ void walk8(const RkwStage& in, WgSlot& so, int t0, int s, int dg,
                                      float (&kD)[8], const float (&kr)[8], float bonus) {
  float res[8];  // stored after the 8 steps, so no store holds up their loads
#pragma unroll
  for (int jt = 0; jt < 8; ++jt) {
    const int t = t0 + jt;
    float r[8];
    bf16x8_at(in.r, t, dg, r);
    const float4 ea = *reinterpret_cast<const float4*>(&in.w[t][8 * dg]);
    const float4 eb = *reinterpret_cast<const float4*>(&in.w[t][8 * dg + 4]);
    const float e[8] = {ea.x, ea.y, ea.z, ea.w, eb.x, eb.y, eb.z, eb.w};
    float dot[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      dot[j & 1] = fmaf(r[j], kD[j], dot[j & 1]);
      kD[j] = DIAG ? fmaf(t == s ? 1.f : 0.f, kr[j], kD[j] * e[j]) : kD[j] * e[j];
    }
    res[jt] = DIAG && t == s ? bonus : dot[0] + dot[1];
  }
#pragma unroll
  for (int jt = 0; jt < 8; ++jt) {
    res[jt] += __shfl_xor_sync(0xffffffffu, res[jt], 4);
    res[jt] += __shfl_xor_sync(0xffffffffu, res[jt], 8);
    res[jt] += __shfl_xor_sync(0xffffffffu, res[jt], 16);
  }
  if (dg == 0) {
#pragma unroll
    for (int jt = 0; jt < 8; ++jt) so.a[t0 + jt][s] = res[jt];
  }
}

// WKV_PROF (parity_probe.py's build): clock64 stamps of the first
// PROF_CHUNKS chunks of block (0, 0, 0), read back by wkv6_prof: 0 the
// producer's issue; the prep warps' 1 inputs landed, 2 e^w done, 3 slot
// free, 4 column walks done, 5 A's walk done; the MMA warpgroup's 6 inputs
// ready, 7 rd·S issued, 8 A·V issued, 9 products retired, 10 chunk done.
#ifdef WKV_PROF
constexpr int PROF_CHUNKS = 16, PROF_STAMPS = 11;
__device__ long long prof_stamps[PROF_CHUNKS][PROF_STAMPS];
#define PROF(i, k)                                                                     \
  do {                                                                                 \
    if ((i) < PROF_CHUNKS && blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0)    \
      prof_stamps[i][k] = clock64();                                                   \
  } while (0)
#else
#define PROF(i, k) ((void)0)
#endif

// One (b, h, segment) a block.  OUT: the outputs of the segment's chunks
// from its incoming state (s0 for p = 0), and after the last segment the
// final state; else (the segment pass) the segment's own contribution from
// a zero state and its decay.
template <bool OUT>
__global__ void __launch_bounds__(WG_THREADS, 1)
    wkv6_wgmma_kernel(const __grid_constant__ CUtensorMap tm_r,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_w, const float* __restrict__ u,
                      const float* __restrict__ s0, float* __restrict__ seg_state,
                      float* __restrict__ seg_decay, __nv_bfloat16* __restrict__ out,
                      float* __restrict__ sf, int S, int H, int P, int Lc) {
  extern __shared__ uint8_t smem_raw[];
  WgSmem& sm = *reinterpret_cast<WgSmem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int h = blockIdx.x, b = blockIdx.y, p = blockIdx.z;
  const int64_t bh = (int64_t)b * H + h;
  const int nchunks = (S + TW - 1) / TW;
  const int c0 = p * Lc, n = max(0, min(c0 + Lc, nchunks) - c0);
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < RKW_STAGES; ++s) {
      mbar_init(&sm.rkw_full[s], 1);
      mbar_init(&sm.rkw_empty[s], 8);  // the prep warps
    }
    for (int s = 0; s < V_STAGES; ++s) {
      mbar_init(&sm.v_full[s], 1);
      mbar_init(&sm.v_empty[s], 4);    // the MMA warps
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(&sm.slot_full[s], 8);
      mbar_init(&sm.slot_empty[s], 4);
    }
    mbar_init_fence();
  }
  if (OUT) {
    for (int i = tid; i < 2 * TW * LDA; i += WG_THREADS)  // A's upper part stays 0
      (&sm.slot[i / (TW * LDA)].a[0][0])[i % (TW * LDA)] = 0.f;
    if (tid < NW) sm.u[tid] = u[(int64_t)h * NW + tid];
  }
  __syncthreads();

  if (tid >= PRODUCER) {  // one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (tid == PRODUCER) {
      constexpr uint32_t RKW_BYTES = (OUT ? 2 : 1) * TW * 128 + TW * NW * 4;
      for (int i = 0; i < n; ++i) {
        const int st = i % RKW_STAGES, sv = i % V_STAGES, t0 = (c0 + i) * TW;
        mbar_wait(&sm.rkw_empty[st], ((i / RKW_STAGES) & 1) ^ 1);  // the first round passes
        PROF(i, 0);
        mbar_expect_tx(&sm.rkw_full[st], RKW_BYTES);
        if (OUT) tma_load_4d(sm.st[st].r, &tm_r, &sm.rkw_full[st], 0, t0, h, b);
        tma_load_4d(sm.st[st].k, &tm_k, &sm.rkw_full[st], 0, t0, h, b);
        tma_load_4d(&sm.st[st].w[0][0], &tm_w, &sm.rkw_full[st], 0, t0, h, b);
        mbar_wait(&sm.v_empty[sv], ((i / V_STAGES) & 1) ^ 1);
        mbar_expect_tx(&sm.v_full[sv], TW * 128);
        tma_load_4d(sm.v[sv], &tm_v, &sm.v_full[sv], 0, t0, h, b);
      }
    }
  } else if (tid >= PREP) {  // the prep warps: e^w, the column walks and A
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(PREP_REGS));
    const int pt = tid - PREP, pw = pt >> 5, lane = pt & 31;
    double seg = 0.0;  // the segment's Σ logw of column pt (pt < 64)
    for (int i = 0; i < n; ++i) {
      const int st = i % RKW_STAGES, sl = i & 1;
      RkwStage& in = sm.st[st];
      WgSlot& so = sm.slot[sl];
      mbar_wait(&sm.rkw_full[st], (i / RKW_STAGES) & 1);
      if (pt == 0) PROF(i, 1);
      {  // e^w in place, and Σ w in double over a quarter of the steps
        const int d = pt & 63, q = pt >> 6;
        float x[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) x[j] = in.w[16 * q + j][d];
        double sum = 0.0;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          sum += (double)x[j];
          in.w[16 * q + j][d] = expf(x[j]);
        }
        sm.wsum[q][d] = sum;
      }
      bar_sync(BAR_PREP, PREP_THREADS);
      if (pt == 0) PROF(i, 2);
      mbar_wait(&sm.slot_empty[sl], ((i >> 1) & 1) ^ 1);  // the MMA warps are done with it
      if (pt == 0) PROF(i, 3);
      {  // the column walks, a thread a column and a half of the chunk, every
         // load before the first store: rd (running products from the half's
         // start) or kd (from its end)
        const int d = pt & 63, grp = pt >> 6, half = grp & 1, h0 = 32 * half;
        if (OUT || grp >= 2) {
          float x[32], e[32], f = 1.f;
#pragma unroll
          for (int j = 0; j < 32; ++j) {
            x[j] = bf16_at(grp < 2 ? in.r : in.k, h0 + j, d);
            e[j] = in.w[h0 + j][d];
          }
          if (grp < 2) {
#pragma unroll
            for (int j = 0; j < 32; ++j) {
              so.rd[h0 + j][d] = x[j] * f;
              f *= e[j];
            }
            if (half == 0) so.e0[d] = f;
          } else {
#pragma unroll
            for (int j = 31; j >= 0; --j) {
              so.kd[h0 + j][d] = x[j] * f;
              f *= e[j];
            }
            if (half == 1) so.e1[d] = f;
          }
        }
        if (grp == 0) {  // the chunk's decay from a double sum rounded once
          const double x = (sm.wsum[0][d] + sm.wsum[1][d]) + (sm.wsum[2][d] + sm.wsum[3][d]);
          so.dt[d] = expf((float)x);
          seg += x;
        }
      }
      if (pt == 0) PROF(i, 4);
      if (OUT) {
        // A within each half (rows and columns h0 .. h0 + 31) on the CUDA
        // cores (it reads only the stage): lane (s, column group dg) walks
        // the steps t of the half from s's block of 8 on, with kD = k_s ⊙
        // Π_{s<j<t} e^{w_j} over its 8 columns (0 until t = s; the bonus
        // Σ_d r u k at t = s).  Warp pw takes half pw / 4, four of the eight
        // s of the blocks pr and 3 - pr (pr = pw / 2 % 2): 40 steps each.
        const int h0 = 32 * (pw >> 2), pr = (pw >> 1) & 1, dg = lane >> 2, d0 = 8 * dg;
#pragma unroll 1
        for (int bi = 0; bi < 2; ++bi) {
          const int blk = bi == 0 ? pr : 3 - pr, t0 = h0 + 8 * blk;
          const int s = t0 + 4 * (pw & 1) + (lane & 3);
          float kr[8], kD[8], bonus = 0.f;
          bf16x8_at(in.k, s, dg, kr);
          {
            float rs[8];
            bf16x8_at(in.r, s, dg, rs);
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              bonus = fmaf(rs[j], sm.u[d0 + j] * kr[j], bonus);
              kD[j] = 0.f;
            }
          }
          walk8<true>(in, so, t0, s, dg, kD, kr, bonus);
#pragma unroll 1
          for (int t8 = t0 + 8; t8 < h0 + 32; t8 += 8) walk8<false>(in, so, t8, s, dg, kD, kr, 0.f);
        }
      }
      if (pt == 0) PROF(i, 5);
      fence_proxy_async();  // e^w written into the stage before TMA refills it
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(&sm.rkw_empty[st]);
        mbar_arrive(&sm.slot_full[sl]);
      }
    }
    if (!OUT && pt < NW) seg_decay[(bh * (P - 1) + p) * NW + pt] = expf((float)seg);
  } else {  // the MMA warpgroup: the three products, the state and the outputs
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(MMA_REGS));
    const int w = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
    // s[4j + e]: rows d = 16w + g + 8(e / 2), columns 8j + 2t4 + e % 2
    float s[32];
    const float* src = !OUT ? nullptr
                       : p == 0 ? s0 + bh * NW * NW
                                : seg_state + (bh * (P - 1) + p - 1) * NW * NW;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float2 x = src ? *reinterpret_cast<const float2*>(
                                   src + (16 * w + g + 8 * hh) * NW + 8 * j + 2 * t4)
                             : make_float2(0.f, 0.f);
        s[4 * j + 2 * hh] = x.x;
        s[4 * j + 2 * hh + 1] = x.y;
      }
    if (OUT) {
      state_parts(sm, s, w, g, t4);
      fence_proxy_async();
      bar_sync(BAR_MMA, 128);
    }
    const int64_t row = (int64_t)H * NW, head = ((int64_t)b * S * H + h) * NW;
    for (int i = 0; i < n; ++i) {
      const int sv = i % V_STAGES, sl = i & 1;
      WgSlot& so = sm.slot[sl];
      const uint8_t* vt = sm.v[sv];
      mbar_wait(&sm.v_full[sv], (i / V_STAGES) & 1);
      mbar_wait(&sm.slot_full[sl], (i >> 1) & 1);
      if (tid == 0) PROF(i, 6);
      if (OUT) {
        // A's block below the halves, rows 32.. against columns ..31, on
        // mma.sync tf32 in three passes as rd (second half) · kd (first
        // half)ᵀ: the pair's decay cut at step 32 into two factors ≤ 1.  Warp
        // w takes row tile w / 2 of 16 and column tiles 2(w % 2), 2(w % 2) + 1.
        const int q = t4, t0 = 32 + 16 * (w >> 1), n0 = 2 * (w & 1);
        float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int ks = 0; ks < NW / 8; ++ks) {
          const int d = 8 * ks + q;
          const float x[4] = {so.rd[t0 + g][d], so.rd[t0 + g + 8][d], so.rd[t0 + g][d + 4],
                              so.rd[t0 + g + 8][d + 4]};
          const FragA fa(x);
#pragma unroll
          for (int jn = 0; jn < 2; ++jn) {
            const int s = 8 * (n0 + jn) + g;
            mma3(acc[jn], fa, so.kd[s][d], so.kd[s][d + 4]);
          }
        }
#pragma unroll
        for (int jn = 0; jn < 2; ++jn)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            *reinterpret_cast<float2*>(&so.a[t0 + g + 8 * hh][8 * (n0 + jn) + 2 * q]) =
                make_float2(acc[jn][2 * hh], acc[jn][2 * hh + 1]);
      }
      // P = (k ⊙ decay to the chunk's end)ᵀ V: A = kdᵀ (rows d, K = s), B = V
      // as stored
      float pacc[32];
      uint32_t kp[4][3][4];
      {  // the first half's kd times the second half's decay e1
        const float e1a = so.e1[16 * w + g], e1b = so.e1[16 * w + g + 8];
        a_parts(kp, w, g, t4, [&](int d, int c) {
          const float f = c < 32 ? ((d & 8) ? e1b : e1a) : 1.f;
          return make_float2(so.kd[c][d] * f, so.kd[c + 1][d] * f);
        });
      }
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 3; ++q) wgmma_rs<64>(pacc, kp[j][q], mn_desc(vt + j * 2048), j | q);
      wgmma_commit();
      fence_regs(pacc);
      float o[32];
      if (OUT) {
        // o = (r ⊙ decay from the chunk's start) S: the 6 products of the
        // parts of rd and S whose part indices sum to 2, 3 or 4, smallest
        // first (the three dropped are below 2^-26 of the largest)
        uint32_t rp[4][3][4];
        a_parts(rp, w, g, t4, [&](int t, int c) {  // the second half's times e0
          const float2 x = *reinterpret_cast<const float2*>(&so.rd[t][c]);
          return t < 32 ? x : make_float2(x.x * so.e0[c], x.y * so.e0[c + 1]);
        });
        wgmma_fence();
        constexpr int PAIRS[6][2] = {{0, 2}, {1, 1}, {2, 0}, {1, 2}, {2, 1}, {2, 2}};
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int q = 0; q < 6; ++q)
            wgmma_rs<64>(o, rp[j][PAIRS[q][0]], mn_desc(sm.spart[PAIRS[q][1]] + j * 2048),
                         j | q);
        wgmma_commit();
        fence_regs(o);
        if (tid == 0) PROF(i, 7);
        bar_sync(BAR_MMA, 128);  // A's block below the halves written by every warp
        wgmma_wait<1>();  // P retired: kp is free
        fence_regs(pacc);
        fence_regs(kp);
        // o += A V, A in three parts
        uint32_t ap[4][3][4];
        a_parts(ap, w, g, t4, [&](int t, int c) {
          return *reinterpret_cast<const float2*>(&so.a[t][c]);
        });
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int q = 0; q < 3; ++q) wgmma_rs<64>(o, ap[j][q], mn_desc(vt + j * 2048), 1);
        wgmma_commit();
        if (tid == 0) PROF(i, 8);
        wgmma_wait<0>();
        if (tid == 0) PROF(i, 9);
        fence_regs(o);
        fence_regs(rp);
        fence_regs(ap);
      } else {
        wgmma_wait<0>();
        fence_regs(pacc);
        fence_regs(kp);
      }
      const float dta = so.dt[16 * w + g], dtb = so.dt[16 * w + g + 8];
      __syncwarp();
      if (lane == 0) {  // the slot and V read
        mbar_arrive(&sm.slot_empty[sl]);
        mbar_arrive(&sm.v_empty[sv]);
      }
      // S = dT ⊙ S + P, entry by entry in IEEE fp32
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[4 * j] = fmaf(dta, s[4 * j], pacc[4 * j]);
        s[4 * j + 1] = fmaf(dta, s[4 * j + 1], pacc[4 * j + 1]);
        s[4 * j + 2] = fmaf(dtb, s[4 * j + 2], pacc[4 * j + 2]);
        s[4 * j + 3] = fmaf(dtb, s[4 * j + 3], pacc[4 * j + 3]);
      }
      if (OUT) {
        state_parts(sm, s, w, g, t4);  // every wgmma reading the parts has retired
        fence_proxy_async();
        const int t0 = (c0 + i) * TW;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int t = t0 + 16 * w + g + 8 * hh;
          if (t >= S) continue;
          __nv_bfloat16* dst = out + head + (int64_t)t * row + 2 * t4;
#pragma unroll
          for (int j = 0; j < 8; ++j)
            *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
                __floats2bfloat162_rn(o[4 * j + 2 * hh], o[4 * j + 2 * hh + 1]);
        }
        bar_sync(BAR_MMA, 128);  // every warp's parts written before the next product
      }
      if (tid == 0) PROF(i, 10);
    }
    float* dst = OUT ? (p == P - 1 ? sf + bh * NW * NW : nullptr)
                     : seg_state + (bh * (P - 1) + p) * NW * NW;
    if (dst) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          *reinterpret_cast<float2*>(dst + (16 * w + g + 8 * hh) * NW + 8 * j + 2 * t4) =
              make_float2(s[4 * j + 2 * hh], s[4 * j + 2 * hh + 1]);
    }
  }
}

// Tensor map of the fp32 logw, (B, S, H, 64) contiguous: boxes of 64
// columns by 64 steps of one head, no swizzle; steps past S read as zeros
// (e^0 = 1 and k = 0 there keep the state).
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
                         const float* u, const float* s0, void* out, float* sf,
                         float* seg_state, float* seg_decay, int B, int S, int H, int P, int Lc,
                         cudaStream_t stream) {
  static const cudaError_t attr = [] {
    const cudaError_t e1 = cudaFuncSetAttribute(
        wkv6_wgmma_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, WG_SMEM);
    const cudaError_t e2 = cudaFuncSetAttribute(
        wkv6_wgmma_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, WG_SMEM);
    return e1 != cudaSuccess ? e1 : e2;
  }();
  if (attr != cudaSuccess) return attr;
  if (S == 0)  // no step: the final state is s0 (and a map of no steps has no strides)
    return cudaMemcpyAsync(sf, s0, sizeof(float) * B * H * NW * NW, cudaMemcpyDeviceToDevice,
                           stream);
  CUtensorMap tr, tk, tv, tw;
  const int64_t rs = (int64_t)H * NW, hs = NW, bs = (int64_t)S * H * NW;
  if (!head_map(&tr, r, NW, S, H, B, rs, hs, bs, TW) ||
      !head_map(&tk, k, NW, S, H, B, rs, hs, bs, TW) ||
      !head_map(&tv, v, NW, S, H, B, rs, hs, bs, TW) || !logw_map(&tw, logw, S, H, B))
    return cudaErrorInvalidValue;
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  if (P > 1) {
    wkv6_wgmma_kernel<false><<<dim3(H, B, P - 1), WG_THREADS, WG_SMEM, stream>>>(
        tr, tk, tv, tw, u, s0, seg_state, seg_decay, o, sf, S, H, P, Lc);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    wkv6_chain_kernel<NW><<<dim3(H, B), 256, 0, stream>>>(s0, seg_state, seg_decay, H, P);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  wkv6_wgmma_kernel<true><<<dim3(H, B, P), WG_THREADS, WG_SMEM, stream>>>(
      tr, tk, tv, tw, u, s0, seg_state, seg_decay, o, sf, S, H, P, Lc);
  return cudaGetLastError();
}

template <typename Tin, int N>
cudaError_t launch(const void* r, const void* k, const void* v, const float* logw,
                   const float* u, const float* s0, void* out, float* sf, float* seg_state,
                   float* seg_decay, int B, int S, int H, int P, int Lc, cudaStream_t stream) {
  constexpr int SMEM = sizeof(Smem<N>);
  static const cudaError_t attr = [] {
    const cudaError_t e1 = cudaFuncSetAttribute(
        wkv6_segment_kernel<Tin, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    const cudaError_t e2 = cudaFuncSetAttribute(
        wkv6_output_kernel<Tin, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    return e1 != cudaSuccess ? e1 : e2;
  }();
  if (attr != cudaSuccess) return attr;
  const Tin* kk = static_cast<const Tin*>(k);
  const Tin* vv = static_cast<const Tin*>(v);
  if (P > 1) {
    wkv6_segment_kernel<Tin, N><<<dim3(H, B, P - 1), THREADS, SMEM, stream>>>(
        kk, vv, logw, seg_state, seg_decay, S, H, P, Lc);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    wkv6_chain_kernel<N><<<dim3(H, B), 256, 0, stream>>>(s0, seg_state, seg_decay, H, P);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  wkv6_output_kernel<Tin, N><<<dim3(H, B, P), THREADS, SMEM, stream>>>(
      static_cast<const Tin*>(r), kk, vv, logw, u, s0, seg_state, static_cast<Tin*>(out), sf,
      S, H, P, Lc);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

#ifdef WKV_PROF
// The stamps of the last profiled launch: PROF_CHUNKS x PROF_STAMPS clock64.
extern "C" int wkv6_prof(long long* host) {
  return (int)cudaMemcpyFromSymbol(host, repro_torch::prof_stamps,
                                   sizeof(repro_torch::prof_stamps));
}
#endif

// r, k, v, out: (B, S, H, N) contiguous, dtype 0 = fp32, 1 = bf16; logw:
// (B, S, H, N) fp32; u: (H, N) fp32; s0, sf: (B, H, N, N) fp32; N = 32 or
// 64; P segments of Lc chunks ((P - 1) Lc < ceil(S / chunk) <= P Lc, or
// P = 1 for S = 0) of 64 steps in bf16 at N = 64 (wkv6_wgmma_kernel), of
// 32 otherwise; seg_state (B, H, P - 1, N, N) and seg_decay (B, H, P - 1, N)
// fp32 scratch.  All 16-byte aligned.
extern "C" int wkv6_fwd(const void* r, const void* k, const void* v, const float* logw,
                        const float* u, const float* s0, void* out, float* sf,
                        float* seg_state, float* seg_decay, int B, int S, int H, int N,
                        int dtype, int P, int Lc, void* stream) {
  using namespace repro_torch;
  const bool wg = dtype == 1 && N == NW;
  const int nchunks = (S + (wg ? TW : T) - 1) / (wg ? TW : T);
  if (B < 0 || S < 0 || H < 0 || B > 65535 || P < 1 || P > 65535 || Lc < 0 ||
      (dtype != 0 && dtype != 1) || (N != 32 && N != 64) ||
      (S > 0 ? (int64_t)(P - 1) * Lc >= nchunks || (int64_t)P * Lc < nchunks : P != 1))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0) return (int)cudaSuccess;
  if (wg)
    return (int)launch_wgmma(r, k, v, logw, u, s0, out, sf, seg_state, seg_decay, B, S, H, P, Lc,
                             static_cast<cudaStream_t>(stream));
  using Launch = cudaError_t (*)(const void*, const void*, const void*, const float*,
                                 const float*, const float*, void*, float*, float*, float*, int,
                                 int, int, int, int, cudaStream_t);
  const Launch fn = dtype == 0 ? (N == 64 ? &launch<float, 64> : &launch<float, 32>)
                              : &launch<__nv_bfloat16, 32>;
  return (int)fn(r, k, v, logw, u, s0, out, sf, seg_state, seg_decay, B, S, H, P, Lc,
                 static_cast<cudaStream_t>(stream));
}
