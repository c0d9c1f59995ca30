// Decode attention on Hopper (sm_90a): one query token per sequence against
// the KV cache, fp32 accumulation.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py ::
// decode_attention (_decode_kernel).  Same function: the G = H/K query heads
// of a kv head share each K/V row, online softmax, tanh softcap and a
// per-sequence `lengths` bound.  It also takes what decoding against the
// model's cache needs and the TPU kernel lacks: a window and, optionally,
// the position each cache slot holds (`slot_pos`, -1 = empty) with the
// query's position `q_pos`.  The mask is pos >= 0 && pos <= q_pos &&
// pos > q_pos - window (window 0 = global) && t < lengths[b]; without
// slot_pos, slot t holds position t and q_pos = lengths[b] - 1.
//
// What bounds it on this card: bytes.  Every live K/V row is read once and
// used for 4·G·d operations, far below the H100's 295 operations per byte.
// The TPU grid walked the cache sequentially with m/l/acc in VMEM scratch;
// here one block owns one (b, kv head) and at most 8 of its query heads,
// its 8 warps stride over the cache four rows at a time (so each warp has 8
// row loads in flight), each warp keeps its own online-softmax state for
// its heads in registers, and the warps merge through shared memory at the
// end.  Nothing but the output is written.  q and acc take 2·G·D/32 fp32
// registers a thread, 128 at G = 8 and d = 256, so G = 16 (recurrentgemma's
// 16 query heads on one kv head) would pass the 255-register limit: it runs
// as two blocks of 8 heads per kv head, each re-reading that head's K/V
// rows.  B·K·⌈G/8⌉ blocks (32 for gemma2-2b at batch 8, 16 for
// recurrentgemma) under-fill the 132 SMs; splitting the cache across blocks
// with a combine pass is later work.
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int NWARPS = 8;
constexpr int U = 4;  // cache rows per warp per step

struct DecodeArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int* lengths;   // (B,)
  const int* q_pos;     // (B,) or null
  const int* slot_pos;  // (B, T) contiguous, or null
  int64_t q_sb, q_sh, k_sb, k_sh, k_st, v_sb, v_sh, v_st, o_sb, o_sh;
  int T, window;
  int group;  // query heads per kv head (H / K)
  int nsub;   // blocks per kv head: group / G, G the heads a block owns
  float softcap, sm_scale;
};

template <int D, int G>
constexpr size_t decode_smem_bytes() {
  return (size_t)NWARPS * G * (D + 2) * sizeof(float);
}

template <typename T, int D, int G>
__global__ void __launch_bounds__(NWARPS * 32) decode_kernel(DecodeArgs a) {
  constexpr int EPL = D / 32;  // elements per lane: lane + 32e
  const int kvh = blockIdx.x / a.nsub, b = blockIdx.y;
  const int64_t head0 = (int64_t)kvh * a.group + (blockIdx.x % a.nsub) * G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int len = min(a.lengths[b], a.T);
  const int qp = a.q_pos ? a.q_pos[b] : len - 1;
  const int* sp = a.slot_pos ? a.slot_pos + (int64_t)b * a.T : nullptr;
  // Without slot_pos, slot t holds position t: the window bounds the scan.
  const int begin = (!sp && a.window > 0) ? max(0, qp - a.window + 1) : 0;

  const T* Q = static_cast<const T*>(a.q) + b * a.q_sb + head0 * a.q_sh;
  const T* Kp = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* Vp = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;

  float q[G][EPL], acc[G][EPL], m[G], l[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      q[g][e] = to_f(Q[g * a.q_sh + lane + 32 * e]);
      acc[g][e] = 0.f;
    }
  }

  for (int base = begin + warp * U; base < len; base += NWARPS * U) {
    float kr[U][EPL], vr[U][EPL];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = base + u;
      const bool live = t < len;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        kr[u][e] = live ? to_f(Kp[t * a.k_st + lane + 32 * e]) : 0.f;
        vr[u][e] = live ? to_f(Vp[t * a.v_st + lane + 32 * e]) : 0.f;
      }
      const int pos = sp ? (live ? sp[t] : -1) : t;
      ok[u] = live && pos >= 0 && pos <= qp && (a.window <= 0 || pos > qp - a.window);
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float s[U];
      float mx = kNegInf;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) dot = fmaf(q[g][e], kr[u][e], dot);
        s[u] = softcap_f(warp_sum(dot) * a.sm_scale, a.softcap);
        if (ok[u]) mx = fmaxf(mx, s[u]);
      }
      const float m_new = fmaxf(m[g], mx);
      const float alpha = expf(m[g] - m_new);
      float p[U], sum = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        p[u] = ok[u] ? expf(s[u] - m_new) : 0.f;
        sum += p[u];
      }
      l[g] = l[g] * alpha + sum;
      m[g] = m_new;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        float x = acc[g][e] * alpha;
#pragma unroll
        for (int u = 0; u < U; ++u) x = fmaf(p[u], vr[u][e], x);
        acc[g][e] = x;
      }
    }
  }

  // Merge the warps' partial softmax states.
  extern __shared__ float smem[];
  float* sAcc = smem;                    // [NWARPS][G][D]
  float* sM = sAcc + NWARPS * G * D;     // [NWARPS][G]
  float* sL = sM + NWARPS * G;           // [NWARPS][G]
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int e = 0; e < EPL; ++e) sAcc[(warp * G + g) * D + lane + 32 * e] = acc[g][e];
    if (lane == 0) {
      sM[warp * G + g] = m[g];
      sL[warp * G + g] = l[g];
    }
  }
  __syncthreads();
  T* O = static_cast<T*>(a.o) + b * a.o_sb + head0 * a.o_sh;
  for (int i = threadIdx.x; i < G * D; i += NWARPS * 32) {
    const int g = i / D, c = i % D;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) M = fmaxf(M, sM[w * G + g]);
    float L = 0.f, acc_c = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      const float f = expf(sM[w * G + g] - M);
      L = fmaf(sL[w * G + g], f, L);
      acc_c = fmaf(sAcc[(w * G + g) * D + c], f, acc_c);
    }
    O[g * a.o_sh + c] = from_f<T>(L > 0.f ? acc_c / L : 0.f);  // no live key → 0
  }
}

template <typename T, int D, int G>
cudaError_t launch(const DecodeArgs& a, int B, int K, cudaStream_t stream) {
  const size_t smem = decode_smem_bytes<D, G>();
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<T, D, G>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  decode_kernel<T, D, G><<<dim3(K * a.nsub, B), NWARPS * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_g(DecodeArgs& a, int B, int K, int G, cudaStream_t stream) {
  a.group = G;
  a.nsub = G > 8 ? G / 8 : 1;
  switch (G) {
    case 1: return launch<T, D, 1>(a, B, K, stream);
    case 2: return launch<T, D, 2>(a, B, K, stream);
    case 4: return launch<T, D, 4>(a, B, K, stream);
    case 8: return launch<T, D, 8>(a, B, K, stream);
    case 16: return launch<T, D, 8>(a, B, K, stream);  // two blocks per kv head
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_d(DecodeArgs& a, int B, int K, int G, int d, cudaStream_t stream) {
  switch (d) {
    case 64: return launch_g<T, 64>(a, B, K, G, stream);
    case 128: return launch_g<T, 128>(a, B, K, G, stream);
    case 256: return launch_g<T, 256>(a, B, K, G, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro_torch

// strides: 10 element strides — q (b, head), k (b, head, slot), v (b, head,
// slot), out (b, head); the head dimension must be contiguous.
// dtype: 0 = float32, 1 = bfloat16.
extern "C" int decode_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                    const int* lengths, const int* q_pos,
                                    const int* slot_pos, const long long* strides, int B,
                                    int H, int K, int T, int d, int dtype, int window,
                                    float softcap, float sm_scale, void* stream) {
  using namespace repro_torch;
  DecodeArgs a;
  a.q = q; a.k = k; a.v = v; a.o = o;
  a.lengths = lengths; a.q_pos = q_pos; a.slot_pos = slot_pos;
  a.q_sb = strides[0]; a.q_sh = strides[1];
  a.k_sb = strides[2]; a.k_sh = strides[3]; a.k_st = strides[4];
  a.v_sb = strides[5]; a.v_sh = strides[6]; a.v_st = strides[7];
  a.o_sb = strides[8]; a.o_sh = strides[9];
  a.T = T; a.window = window; a.softcap = softcap; a.sm_scale = sm_scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = H / K;
  if (dtype == 0) return (int)launch_d<float>(a, B, K, G, d, st);
  if (dtype == 1) return (int)launch_d<__nv_bfloat16>(a, B, K, G, d, st);
  return (int)cudaErrorInvalidValue;
}
