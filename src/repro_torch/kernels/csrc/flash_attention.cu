// Flash attention for prefill on Hopper (sm_90a), fp32 accumulation.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py ::
// flash_attention (_flash_kernel).  Same function: blockwise online-softmax
// GQA attention, causal, sliding window (0 = global) and tanh softcap, plus
// per-sequence `lengths` (keys >= lengths[b] masked) so that ragged prefill
// can use it, and ragged Sq/Skv edges with no divisibility required.
//
// What bounds it on this card: at prefill lengths the work is operations,
// 4·d multiply-adds per unmasked (query, key) pair, far above the H100's
// 295 operations per byte.  The TPU grid carried m/l/acc in VMEM scratch
// across its sequential kv axis; on Hopper blocks run in parallel with no
// carried scratch, so each block owns one (b, h, 64-row q tile) and loops
// over 32-row kv tiles itself, keeping m/l and the 64 x d fp32 accumulator
// in registers (2 rows x d/8 columns per thread).  Kv tiles that causality,
// the window or the length mask fully (the TPU kernel's block skip) are
// never loaded, which keeps local layers O(S·W).  Q, K and V tiles are held
// in shared memory as fp32 with a padded row pitch (conflict-free column
// reads): 137 KB at d = 256, one block per SM, set through
// cudaFuncAttributeMaxDynamicSharedMemorySize.  The products run on the
// fp32 FMA units, not the tensor cores: this first kernel is plain and
// right; mma/wgmma tiles with TMA loads are later work.
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int BQ = 64;         // query rows per block
constexpr int BK = 32;         // keys per kv tile
constexpr int NTHREADS = 256;  // 32 row pairs x 8 column groups

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
__global__ void __launch_bounds__(NTHREADS) flash_kernel(FlashArgs a) {
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

template <typename T, int D>
cudaError_t launch(const FlashArgs& a, int B, cudaStream_t stream) {
  const size_t smem = flash_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + BQ - 1) / BQ, a.H, B);
  flash_kernel<T, D><<<grid, NTHREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const FlashArgs& a, int B, int d, cudaStream_t stream) {
  switch (d) {
    case 64: return launch<T, 64>(a, B, stream);
    case 128: return launch<T, 128>(a, B, stream);
    case 256: return launch<T, 256>(a, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro_torch

// strides: 12 element strides (b, head, seq) of q, k, v, out in that order;
// the head dimension must be contiguous.  dtype: 0 = float32, 1 = bfloat16.
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_d<float>(a, B, d, st);
  if (dtype == 1) return (int)launch_d<__nv_bfloat16>(a, B, d, st);
  return (int)cudaErrorInvalidValue;
}
