// Helpers shared by the kernels: element conversion, tile loads, the PTX
// wrappers (cp.async, ldmatrix, mma.sync) of the tensor-core attention
// kernels, the tf32 products of the WKV kernels, and the Hopper wrappers
// (mbarriers, bulk and TMA copies, wgmma descriptors, products and groups,
// named barriers, the driver's tensor-map encoder and K1's head maps) of
// the RG-LRU ring, K1, K1′ and K5.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include <algorithm>

namespace repro_torch {

constexpr float kNegInf = -1e30f;
constexpr float kNoKey = 1e30f;  // the log-sum-exp of a row with no live key: P = 0

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float softcap_f(float x, float cap) {
  return cap > 0.f ? cap * tanhf(x / cap) : x;
}

// Sum over the 32 lanes of a warp; every lane gets the total.
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Max over the 32 lanes of a warp; every lane gets it.
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// Copy `rows` rows of D elements (row r at src + (row0 + r) * stride) into a
// float tile with row pitch LD, 16 bytes per thread per load.  Rows at or past
// `valid` are zero-filled.  Needs src and stride 16-byte aligned (checked by
// the Python wrapper).
template <typename T, int D, int LD, int NTHREADS>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int64_t stride,
                                          int row0, int rows, int valid) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CPR = D / VEC;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < rows * CPR; i += NTHREADS) {
    const int r = i / CPR, c = (i % CPR) * VEC;
    float* d = dst + r * LD + c;
    if (row0 + r < valid) {
      const uint4 raw = *reinterpret_cast<const uint4*>(src + (int64_t)(row0 + r) * stride + c);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int u = 0; u < VEC; ++u) d[u] = to_f(e[u]);
    } else {
#pragma unroll
      for (int u = 0; u < VEC; ++u) d[u] = 0.f;
    }
  }
}

// ---- tensor-core attention: asynchronous copies, swizzled tiles, mma ----

// 16-byte asynchronous copy global -> shared.  With `valid` false nothing is
// read and the 16 bytes are zero-filled (src must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Element offset of 16-byte chunk c of row r in a tile of rows of CPR chunks
// (CPR a power of two >= 8), each chunk EPC elements.  The chunk index is
// XORed with r % 8, so the 8 rows that one ldmatrix phase (or one quarter of
// a warp's 16-byte loads) reads at one logical chunk land on 8 different
// bank groups; a row's chunks are only permuted, so the cp.async stores of
// consecutive chunks stay conflict-free too.
template <int CPR, int EPC>
__device__ __forceinline__ int swz(int r, int c) {
  return (r * CPR + (c ^ (r & 7))) * EPC;
}

// ldmatrix: four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of
// matrix i, which lands in r[i].  .trans delivers each matrix transposed.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// c += a * b on the tensor cores: a 16x16 bf16 (row), b 16x8 bf16 (col),
// c 16x8 fp32.  Fragments (g = lane / 4, t = lane % 4): a = {(g, 2t..2t+1),
// (g+8, 2t..), (g, 2t+8..), (g+8, 2t+8..)}; b = {(k 2t..2t+1, n g),
// (k 2t+8.., n g)}; c = {(g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)}.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a * b, from zero: a chain of one product (see qk_mma).
__device__ __forceinline__ void mma_bf16_fresh(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f), "f"(0.f),
        "f"(0.f), "f"(0.f));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two fp32 values x0 (low half) and x1 as N bf16 pairs, largest last:
// part[N - 1] = round(x), each lower part the rounding of what the parts
// above it leave (N = 3: 24 significant bits, the fp32 value to within its
// own rounding).  P·V takes P in parts (PARITY_P_PARTS): P rounded once to
// bf16 moves the output of P·V past one bf16 ulp
// (tests/test_torch_kernels.py::test_split_p_holds_one_bf16_ulp).
template <int N>
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t (&part)[N]) {
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    part[i] = bf16x2_bits(h);
    const float2 f = __bfloat1622float2(h);
    x0 -= f.x;
    x1 -= f.y;
  }
}

// A ring of ST tiles loaded with cp.async: tile i is issued ST - 1 tiles
// ahead of its use, so its load overlaps the products of the tiles before
// it.  issue(i) starts tile i's copies; compute(i) reads it once every
// thread's copies have landed.  Copies a caller issues before this call join
// the first group.  Ends with no copy in flight.
template <int ST, typename Issue, typename Compute>
__device__ __forceinline__ void pipeline(int ntiles, Issue&& issue, Compute&& compute) {
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < ntiles) issue(s);
    cp_async_commit();
  }
  for (int i = 0; i < ntiles; ++i) {
    if (i + ST - 1 < ntiles) issue(i + ST - 1);  // into the stage read at i - 1
    cp_async_commit();
    cp_async_wait<ST - 1>();
    __syncthreads();
    compute(i);
    __syncthreads();  // the stage is free for the next issue
  }
  cp_async_wait<0>();
}

// ---- parity switches of the bf16 tensor-core paths (K1, K1's backward, K2) ----
// The bf16 kernels are held to one bf16 ulp of the float64 plain version on
// the models' own activations (chip_smoke.py phases 3 and 4; K1's backward
// to phase 18's limit).  These build-time switches name the measures that
// bear on that check.  Each kernel sets them before including this file
// (flash_attention.cu, flash_attention_bwd.cu and decode_attention.cu say
// why); a -D on nvcc's command line overrides
// them, which is how parity_probe.py builds variants.  The defaults below
// are the most exact settings.
// - PARITY_QK_CHAIN: k16 steps of Q·Kᵀ summed in one mma (or wgmma)
//   accumulator before the sum is added to the scores in IEEE fp32.  The
//   tensor cores' fp32 accumulation is not IEEE: each mma truncates its sum
//   toward zero, so a long chain drifts; 1 starts every mma from zero.  K1's
//   and K1′'s wgmma builds take at most two chains a tile (K1′ for S and dP
//   alike).
// - PARITY_PV_FRESH: 1 sums each k16 step of P·V from zero and adds it to
//   the accumulator in IEEE fp32; 0 chains every step into the accumulator
//   (588 mma a 4700-key row).  K1 reads it as the k16 steps a fresh sum
//   spans (4: a 64-key tile, or the whole 32-key tile at d = 256).
// - PARITY_P_PARTS: bf16 parts of P in P·V (split_bf16), 2 or 3.
// - PARITY_IEEE_EXP: 1 takes the softcap's tanh and the softmax's
//   exponentials from tanhf/expf, as the plain version computes them; 0 from
//   the fast MUFU forms (__expf, and the softcap as cap - 2cap/(e^(2x/cap) + 1)).
// - PARITY_BWD_PARTS: bf16 parts of P and dS in K1's backward's gradient
//   products dV += Pᵀ·dO, dK += dSᵀ·Q and dQ += dS·K, 1 (rounded once), 2
//   or 3.
// - PARITY_BWD_FRESH: F > 0 sums chains of F k16 steps of those products
//   from zero (wgmma groups with scale-d 0) and adds each to the
//   accumulator in IEEE fp32 (1: every step); 0 chains every step into it.
#ifndef PARITY_QK_CHAIN
#define PARITY_QK_CHAIN 1
#endif
#ifndef PARITY_PV_FRESH
#define PARITY_PV_FRESH 1
#endif
#ifndef PARITY_P_PARTS
#define PARITY_P_PARTS 3
#endif
#ifndef PARITY_IEEE_EXP
#define PARITY_IEEE_EXP 1
#endif
#ifndef PARITY_BWD_PARTS
#define PARITY_BWD_PARTS 3
#endif
#ifndef PARITY_BWD_FRESH
#define PARITY_BWD_FRESH 1
#endif
static_assert(PARITY_P_PARTS == 2 || PARITY_P_PARTS == 3, "P in 2 or 3 bf16 parts");
static_assert(PARITY_BWD_PARTS >= 1 && PARITY_BWD_PARTS <= 3, "P and dS in 1 to 3 parts");

__device__ __forceinline__ float exp_tc(float x) {
#if PARITY_IEEE_EXP
  return expf(x);
#else
  return __expf(x);
#endif
}
__device__ __forceinline__ float softcap_tc(float x, float cap) {
#if PARITY_IEEE_EXP
  return softcap_f(x, cap);
#else
  return cap > 0.f ? cap - __fdividef(2.f * cap, __expf(2.f * x / cap) + 1.f) : x;
#endif
}

// softcap_tc of a cap known to be positive (K1 tests the cap once a tile).
__device__ __forceinline__ float capped_tc(float x, float cap) {
#if PARITY_IEEE_EXP
  return cap * tanhf(x / cap);
#else
  return cap - __fdividef(2.f * cap, __expf(2.f * x / cap) + 1.f);
#endif
}

// Step `step` of STEPS k16 steps of Q·Kᵀ into the scores s (zero at step
// 0), in chains of PARITY_QK_CHAIN steps: a chain's running sum lives in u,
// started from zero, and is added to s when the chain ends (at the last
// step too).  One chain over all the steps runs in s itself.
template <int STEPS>
__device__ __forceinline__ void qk_mma(float (&s)[4], float (&u)[4], int step,
                                       const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  if constexpr (PARITY_QK_CHAIN >= STEPS) {
    mma_bf16(s, a, b0, b1);
  } else {
    if (step % PARITY_QK_CHAIN == 0) {
      mma_bf16_fresh(u, a, b0, b1);
    } else {
      mma_bf16(u, a, b0, b1);
    }
    if (step % PARITY_QK_CHAIN == PARITY_QK_CHAIN - 1 || step == STEPS - 1) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[e] += u[e];
    }
  }
}

// acc += (P in NP bf16 parts, smallest first) · B for one k16 step of
// P·V, from zero and added in IEEE fp32 (FRESH) or chained (K2).
template <int NP = PARITY_P_PARTS, bool FRESH = (PARITY_PV_FRESH != 0), typename PartA,
          typename PartB>
__device__ __forceinline__ void pv_mma(float (&acc)[4], PartA&& a, PartB&& b) {
  if constexpr (FRESH) {
    float t[4];
    mma_bf16_fresh(t, a(0), b(0, 0), b(0, 1));
#pragma unroll
    for (int i = 1; i < NP; ++i) mma_bf16(t, a(i), b(i, 0), b(i, 1));
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] += t[e];
  } else {
#pragma unroll
    for (int i = 0; i < NP; ++i) mma_bf16(acc, a(i), b(i, 0), b(i, 1));
  }
}

// ---- tf32 tensor-core products of fp32 operands (K4 and its backward) ----

// x as its tf32 rounding (big) and the tf32 rounding of what that leaves.
__device__ __forceinline__ void tf32_split(float x, uint32_t& big, uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(x));
  const float rest = x - __uint_as_float(big);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small) : "f"(rest));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An A fragment (four fp32 values) split into its tf32 parts.
struct FragA {
  uint32_t big[4], small[4];
  __device__ __forceinline__ explicit FragA(const float (&x)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) tf32_split(x[i], big[i], small[i]);
  }
};
// d = a · b from zero: the accumulator's zeros are constants, not moves
__device__ __forceinline__ void mma_tf32_fresh(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f), "f"(0.f),
        "f"(0.f), "f"(0.f));
}

// ---- Hopper: mbarriers, bulk and TMA copies, wgmma (K3's ring, K1, K5) ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
// Make the initialised mbarriers visible to the other threads and to the
// asynchronous proxy (then __syncthreads).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// One arrival that also expects `bytes` more of asynchronous copies.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}
// `bytes` (a multiple of 16; both addresses 16-byte aligned) from global to
// shared memory, counted on `bar` as they land.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
// TMA: the box at coordinates (c0, c1) of a 2-D `map` into dst, counted on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}
// The same for a 4-D map, coordinates innermost first.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}
// wgmma descriptor of a K-major tile of 128-byte rows in the 128-byte swizzle
// TMA writes (tile 1024-byte aligned): start address, stride 1024 bytes
// between 8-row groups.  Steps of 32 bytes along K add 2 to the start address.
__device__ __forceinline__ uint64_t kmajor_desc(const void* tile) {
  return (uint64_t)((smem_u32(tile) & 0x3FFFF) >> 4) | (uint64_t)1 << 16 |
         (uint64_t)(1024 >> 4) << 32 | (uint64_t)1 << 62;
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N of this warpgroup's committed wgmma groups are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accesses of registers across the wgmma
// instructions and waits that read or write them asynchronously.
template <int R>
__device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <typename T, int R, int C>
__device__ __forceinline__ void fence_regs(T (&d)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i) fence_regs(d[i]);
}
template <typename T, int R, int C, int E>
__device__ __forceinline__ void fence_regs(T (&d)[R][C][E]) {
#pragma unroll
  for (int i = 0; i < R; ++i) fence_regs(d[i]);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, from the libcuda the process has loaded.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (!lib) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib ? reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// ---- wgmma products, named barriers and tensor maps (K1 and K1′ on wgmma) ----

// d (+)= a·b, 64 rows by N columns by 16, bf16 in and fp32 sums out: ss with
// A and B from shared memory (K-major descriptors), rs with A from registers
// (the mma.sync A fragment of each warp's 16 rows) and B MN-major.  acc 0
// starts d from zero.
template <int N>
__device__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int acc);
template <int N>
__device__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b, int acc);

template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                             int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

// Descriptor of an MN-major B operand: 16 keys (K) by 64 columns (N) of a V
// tile as TMA wrote it, a key a 128-byte swizzled row, 8-key groups 1024
// bytes apart.  One 64-column atom: the leading offset is never stepped (set
// to the same 1024).
__device__ __forceinline__ uint64_t mn_desc(const void* tile) {
  return (uint64_t)((smem_u32(tile) & 0x3FFFF) >> 4) | (uint64_t)(1024 >> 4) << 16 |
         (uint64_t)(1024 >> 4) << 32 | (uint64_t)1 << 62;
}

// Byte offset of element (row, col) of a [64][64] bf16 tile in TMA's
// 128-byte swizzle: 16-byte chunk col / 8 of the row, XORed with row % 8.
__device__ __forceinline__ int swz128(int row, int col) {
  return row * 128 + (((col >> 3) ^ (row & 7)) << 4) + ((col & 7) << 1);
}
__device__ __forceinline__ float bf16_at(const uint8_t* tile, int row, int col) {
  return __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(tile + swz128(row, col)));
}
// Columns 8·c8 .. 8·c8 + 7 of a row of a swizzled bf16 tile as floats.
__device__ __forceinline__ void bf16x8_at(const uint8_t* tile, int row, int c8, float (&x)[8]) {
  const uint4 raw =
      *reinterpret_cast<const uint4*>(tile + row * 128 + ((c8 ^ (row & 7)) << 4));
  const uint32_t word[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(word[i] << 16);
    x[2 * i + 1] = __uint_as_float(word[i] & 0xffff0000u);
  }
}
// Generic-proxy writes to shared memory ordered before the asynchronous
// proxy's accesses (TMA's next write into a stage, wgmma's reads).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// A named barrier over `count` threads.
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// Tensor map of a bf16 operand of D columns laid out (B, S, heads, D) by its
// element strides (the head dimension contiguous): boxes of 64 columns (one
// 128-byte swizzle row) by `rows` rows of one head of one sequence; rows
// past S read as zeros.  A dimension of extent 1 is never stepped, so its
// stride, whatever the view holds, is given as D.  A map is a function of
// these numbers alone, so the last MAP_CACHE that this host thread encoded
// are kept and reused: a model calls with the same shapes layer after
// layer, and PyTorch's caching allocator hands the same addresses back
// (K1's forward takes 3 maps a call, its backward 8).
struct MapEntry {
  CUtensorMap map;
  const void* ptr;
  int64_t key[8];
};
constexpr int MAP_CACHE = 32;
inline thread_local MapEntry map_cache[MAP_CACHE];
inline thread_local int map_next = 0;

inline bool head_map(CUtensorMap* map, const void* ptr, int D, int S, int heads, int B,
                     int64_t ss, int64_t sh, int64_t sb, int rows) {
  const int64_t key[8] = {D, S, heads, B, ss, sh, sb, rows};
  for (const MapEntry& e : map_cache)
    if (e.ptr == ptr && std::equal(key, key + 8, e.key)) {
      *map = e.map;
      return true;
    }
  const EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  auto bytes = [&](int64_t stride, int extent) {
    return (cuuint64_t)((extent == 1 ? D : stride) * 2);
  };
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)std::max(S, 1), (cuuint64_t)heads,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {bytes(ss, std::max(S, 1)), bytes(sh, heads), bytes(sb, B)};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  if (fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
         elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  MapEntry& e = map_cache[map_next];
  e.map = *map;
  e.ptr = ptr;
  std::copy(key, key + 8, e.key);
  map_next = (map_next + 1) % MAP_CACHE;
  return true;
}

}  // namespace repro_torch
