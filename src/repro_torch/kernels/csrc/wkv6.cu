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
// once) are the bound.  Measured, the kernel is bound by neither: it is
// latency-bound at two blocks of 4 warps an SM, its phases separated by
// barriers.
//
// Algorithm, within a chunk of T = 32 steps with incoming state S, values V
// and e_j = e^{w_j}:
//   o  = (r ⊙ Π_{j<t} e_j) S  +  A V
//   S' = e^{Σ_j w_j} ⊙ S  +  (k ⊙ Π_{j>s} e_j)^T V
//   A[t, s] = Σ_d r_td k_sd Π_{s<j<t} e_jd (s < t),  A[t, t] = Σ_d r_td u_d k_td.
// - The three products ((T x N)(N x N), (T x T)(T x N), (N x T)(T x N)) run
//   on the tensor cores, mma.sync m16n8k8 tf32 with each fp32 operand split
//   into a tf32 part and the tf32 rounding of what it leaves: three products
//   a step (WKV_TF32_PASSES), two where the other operand is a bf16 v, which
//   tf32 holds exactly; each k8 step summed from zero and added in IEEE
//   fp32.  One tf32 product keeps 11 bits, short of the fp32 state carried
//   over 147 chunks.
// - Overflow: every decay is a running product of factors e_j ≤ 1 (no
//   e^{-Σ w}, no division), so none exceeds 1; a product below fp32's range
//   underflows to 0, as the true decay does.  Only the chunk's own decay,
//   carried from chunk to chunk, is e^{Σ w} of a double sum rounded once, so
//   that its error does not grow with T.
// - A: its four diagonal 8 x 8 blocks on the CUDA cores, N/4 columns d a
//   warp, lane s walking the 8 steps t of its block with k_s ⊙ Π_{s<j<t} e_j
//   (one multiply a pair and column, no exponential); every block below them
//   on the tensor cores, as (r_t Π_{b<=j<t} e_j)(k_s Π_{s<j<b} e_j)^T at a
//   block boundary b between s and t, both factors ≤ 1; the four warps'
//   partial sums added.
//
// Parallel over the sequence: each (b, h) is cut into P segments of Lc
// chunks (plan_segments in wkv6.py, B·H·P ≈ 2048 blocks).  Three launches:
// wkv6_segment_kernel runs every segment but the last from a zero state to
// its contribution U_p and its decay d_p = e^{Σ w}; wkv6_chain_kernel chains
// them per (b, h), S_{p+1} = d_p ⊙ S_p + U_p, elementwise on N x N and
// sequential over P; wkv6_output_kernel runs every segment from its
// incoming state, writing the outputs, and the last one the final state.
//
// Resources (ptxas, N = 64): the output kernel 4 warps, 222 registers a
// thread in bf16 and 246 in fp32, no spills, 109 KiB of shared memory (a
// chunk's r, k, v, logw, e^w, decayed r and k, the factors of A's lower
// blocks, A and its per-warp partial sums, and the state), two blocks an
// SM; the next chunk's inputs are loaded into registers while the current
// one is computed.  Loads that follow shared-memory stores are
// issued ahead of them in batches: the compiler cannot tell the arrays
// apart, and each load would otherwise wait for the store before it.
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

// r, k, v, out: (B, S, H, N) contiguous, dtype 0 = fp32, 1 = bf16; logw:
// (B, S, H, N) fp32; u: (H, N) fp32; s0, sf: (B, H, N, N) fp32; N = 32 or
// 64; P segments of Lc chunks of 32 steps ((P - 1) Lc < ceil(S / 32) <=
// P Lc, or P = 1 for S = 0); seg_state (B, H, P - 1, N, N) and seg_decay
// (B, H, P - 1, N) fp32 scratch.  All 16-byte aligned.
extern "C" int wkv6_fwd(const void* r, const void* k, const void* v, const float* logw,
                        const float* u, const float* s0, void* out, float* sf,
                        float* seg_state, float* seg_decay, int B, int S, int H, int N,
                        int dtype, int P, int Lc, void* stream) {
  using namespace repro_torch;
  const int nchunks = (S + T - 1) / T;
  if (B < 0 || S < 0 || H < 0 || B > 65535 || P < 1 || P > 65535 || Lc < 0 ||
      (dtype != 0 && dtype != 1) || (N != 32 && N != 64) ||
      (S > 0 ? (int64_t)(P - 1) * Lc >= nchunks || (int64_t)P * Lc < nchunks : P != 1))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0) return (int)cudaSuccess;
  using Launch = cudaError_t (*)(const void*, const void*, const void*, const float*,
                                 const float*, const float*, void*, float*, float*, float*, int,
                                 int, int, int, int, cudaStream_t);
  const Launch fn = dtype == 0
                        ? (N == 64 ? &launch<float, 64> : &launch<float, 32>)
                        : (N == 64 ? &launch<__nv_bfloat16, 64> : &launch<__nv_bfloat16, 32>);
  return (int)fn(r, k, v, logw, u, s0, out, sf, seg_state, seg_decay, B, S, H, P, Lc,
                 static_cast<cudaStream_t>(stream));
}
