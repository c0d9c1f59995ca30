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
// one (b, h, 64-row q tile) and loops over kv tiles itself.  Kv tiles that
// causality, the window or the length mask fully (the TPU kernel's block
// skip) are never loaded, which keeps local layers O(S·W).
//
// bf16 (flash_bf16_kernel), the FlashAttention-2 shape on mma.sync:
// - 4 warps, each owning 16 query rows; m/l and the 16 x d fp32 accumulator
//   stay in registers (d/2 a thread: 128 at d = 256).
// - Q (64 rows) and K/V tiles of 64 keys (32 at d = 256) stay bf16 in
//   shared memory, XOR-swizzled in 16-byte chunks (swz) so ldmatrix reads
//   are conflict-free; K/V are double-buffered with 16-byte cp.async, tile
//   n + 1 loading while tile n is multiplied.
// - S = Q·Kᵀ and O += P·V run on mma.sync.m16n8k16 (bf16 in, fp32 out), V
//   read transposed by ldmatrix.trans.  Scale, softcap, mask and the online
//   softmax act on the fp32 score fragments in registers, and P becomes the
//   A fragments of P·V without shared memory.
// - Parity.  Held to one bf16 ulp of the float64 plain version on the
//   models' own activations, it keeps three of common.cuh's parity
//   measures and drops the fourth (parity_probe.py on an H100): P·V summed
//   from zero at each k16 step and added in IEEE fp32, P in three bf16
//   parts, and tanhf/expf; Q·Kᵀ runs in chains of 8 k16 steps.  P·V
//   chained into the accumulator failed the check on gemma2-2b's
//   activations (2.1x the limit), and so did dropping any two of the
//   others; the chains of 8 alone passed and took ~20% off K1's time.
// - Occupancy.  One warp per SM sub-partition hides little latency (a
//   first version, one block of 160 KB per SM at d = 256, was markedly
//   slower).  At d = 256 the kv tile is 32 keys, so Q and two stages take
//   96 KB and two blocks share an SM, and the softmax steps over 16 keys
//   at a time, so the score registers fit beside the accumulator's 128
//   (80 KB and 64-key tiles and steps below d = 256).
// - The softmax skips rescaling the accumulator where a row's max held.
// - Warps test their own rows against the causal, window and length edges
//   and mask only tiles that cross one; q tiles are issued longest-first.
// wgmma, TMA and warp specialisation are later work.
//
// fp32 (flash_f32_kernel) keeps IEEE FMA products: 32-key kv tiles converted
// into padded fp32 shared-memory tiles (conflict-free column reads), 2 rows
// x d/8 columns of the accumulator a thread, 137 KB at d = 256.
// common.cuh's parity switches as K1 ships them (see the header)
#ifndef PARITY_QK_CHAIN
#define PARITY_QK_CHAIN 8
#endif
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int BQ = 64;         // query rows per block
constexpr int BK = 32;         // keys per kv tile, fp32
constexpr int NTHREADS = 256;  // fp32: 32 row pairs x 8 column groups
constexpr int NTH16 = 128;     // bf16: 4 warps of 16 query rows

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
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

// bf16 kv tile: 64 keys, 32 at d = 256, where the 96 KB of Q and two
// stages of K and V let two blocks share an SM.  Softmax step: the whole
// tile, 16 keys at d = 256, where the score registers and the short
// product chains' sums must fit beside the accumulator's 128.
template <int D>
__host__ __device__ constexpr int kv_tile() { return D == 256 ? 32 : 64; }
template <int D>
__host__ __device__ constexpr int kv_step() { return D == 256 ? 16 : 64; }

template <int D>
constexpr size_t flash_bf16_smem_bytes() {
  return (size_t)(BQ + 4 * kv_tile<D>()) * D * sizeof(__nv_bfloat16);  // Q, K and V x 2
}

template <int D>
__global__ void __launch_bounds__(NTH16) flash_bf16_kernel(FlashArgs a) {
  using bf16 = __nv_bfloat16;
  constexpr int CPR = D / 8, BKV = kv_tile<D>(), KS = kv_step<D>(), NT = KS / 8, NO = D / 8;
  extern __shared__ __align__(16) unsigned char smem16[];
  bf16* sQ = reinterpret_cast<bf16*>(smem16);
  bf16* sK = sQ + BQ * D;  // [2][BKV][D]
  bf16* sV = sK + 2 * BKV * D;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.K);
  const int len = max(0, a.lengths ? min(a.lengths[b], a.Skv) : a.Skv);
  const bf16* Q = static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const bf16* Kp = static_cast<const bf16*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const bf16* Vp = static_cast<const bf16*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  bf16* O = static_cast<bf16*>(a.o) + b * a.o_sb + h * a.o_sh;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;

  // The kv range that can hold an unmasked key for some row of this tile.
  const int q_last = min(q0 + BQ, a.Sq) - 1;
  int kv_end = len;
  if (a.causal) kv_end = min(kv_end, q_last + 1);
  int kv_begin = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  kv_begin -= kv_begin % BKV;
  const int ntiles = kv_begin < kv_end ? (kv_end - kv_begin + BKV - 1) / BKV : 0;

  for (int i = tid; i < BQ * CPR; i += NTH16) {  // joins the first copy group
    const int r = i / CPR, c = i % CPR;
    const bool ok = q0 + r < a.Sq;
    cp_async16(sQ + swz<CPR, 8>(r, c), Q + (ok ? (int64_t)(q0 + r) * a.q_ss : 0) + c * 8, ok);
  }
  auto issue = [&](int tile) {
    const int stage = tile & 1, k0 = kv_begin + tile * BKV;
#pragma unroll 1  // unrolled, its hoisted addresses spill at d = 256
    for (int i = tid; i < BKV * CPR; i += NTH16) {
      const int r = i / CPR, c = i % CPR, t = k0 + r;
      const bool ok = t < kv_end;  // keys no row of the tile may see are not read
      const int64_t row = ok ? t : 0;
      cp_async16(sK + stage * BKV * D + swz<CPR, 8>(r, c), Kp + row * a.k_ss + c * 8, ok);
      cp_async16(sV + stage * BKV * D + swz<CPR, 8>(r, c), Vp + row * a.v_ss + c * 8, ok);
    }
  };

  float acc[NO][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const int w0 = q0 + 16 * warp;  // this warp's rows: w0 + g and w0 + g + 8

  pipeline<2>(ntiles, issue, [&](int tile) {
    const int stage = tile & 1;
#pragma unroll 1
    for (int sub = 0; sub < BKV / KS; ++sub) {
      const int kb = kv_begin + tile * BKV + sub * KS;
      float s[NT][4];
      qk_step<NT, D>(s, sQ, 16 * warp, sK + stage * BKV * D, sub * KS, lane);
      // every (row, key) of this step live for this warp's rows?
      const bool full = kb + KS <= len && (!a.causal || kb + KS - 1 <= w0) &&
                        (a.window <= 0 || kb > w0 + 15 - a.window);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = softcap_tc(s[n][e] * a.sm_scale, a.softcap);
          if (!full) {
            const int qi = w0 + g + 8 * (e >> 1), kj = kb + 8 * n + 2 * t4 + (e & 1);
            if (!(kj < len && (!a.causal || kj <= qi) && (a.window <= 0 || kj > qi - a.window)))
              x = -INFINITY;
          }
          s[n][e] = x;
        }
      }
      softmax_step<NT, NO>(s, m, l, acc);
      pv_step<NT, NO>(s, acc, sV + stage * BKV * D, sub * KS, lane);
    }
  });

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    const int qi = w0 + g + 8 * hh;
    if (qi >= a.Sq) continue;
    const float inv = l[hh] > 0.f ? 1.f / l[hh] : 0.f;  // a row with no key → 0
    bf16* dst = O + (int64_t)qi * a.o_ss + 2 * t4;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) =
          __floats2bfloat162_rn(acc[n][2 * hh] * inv, acc[n][2 * hh + 1] * inv);
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
cudaError_t launch_bf16(const FlashArgs& a, int B, cudaStream_t stream) {
  constexpr size_t smem = flash_bf16_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + BQ - 1) / BQ, a.H, B);
  flash_bf16_kernel<D><<<grid, NTH16, smem, stream>>>(a);
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
      case 64: return launch_bf16<64>(a, B, stream);
      case 128: return launch_bf16<128>(a, B, stream);
      case 256: return launch_bf16<256>(a, B, stream);
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace repro_torch

// strides: 12 element strides (b, head, seq) of q, k, v, out in that order;
// the head dimension must be contiguous and rows 16-byte aligned.
// dtype: 0 = float32, 1 = bfloat16.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   const int* lengths, const long long* strides, int B,
                                   int H, int K, int Sq, int Skv, int d, int dtype,
                                   int causal, int window, float softcap, float sm_scale,
                                   void* stream) {
  using namespace repro_torch;
  FlashArgs a;
  a.q = q; a.k = k; a.v = v; a.o = o; a.lengths = lengths;
  a.q_sb = strides[0]; a.q_sh = strides[1]; a.q_ss = strides[2];
  a.k_sb = strides[3]; a.k_sh = strides[4]; a.k_ss = strides[5];
  a.v_sb = strides[6]; a.v_sh = strides[7]; a.v_ss = strides[8];
  a.o_sb = strides[9]; a.o_sh = strides[10]; a.o_ss = strides[11];
  a.H = H; a.K = K; a.Sq = Sq; a.Skv = Skv; a.causal = causal; a.window = window;
  a.softcap = softcap; a.sm_scale = sm_scale;
  return (int)launch_d(a, B, d, dtype, static_cast<cudaStream_t>(stream));
}
