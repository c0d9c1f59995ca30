// Int8 x int8 -> fp32 quantized matrix product on Hopper (sm_90a):
//
//   out[m, n] = (fp32(sum_k x_q[m, k] * w_q[k, n]) * sx[m]) * sw[n]
//
// Replaces the Pallas TPU kernel src/repro/kernels/int8_matmul.py ::
// int8_matmul (_int8_mm_kernel).  Same function: x_q (M, K) and w_q (K, N)
// int8, both row-major, sx (M,) and sw (N,) fp32 in; out (M, N) fp32.  The
// sum is exact in int32, converted to fp32 with round-to-nearest-even
// (__int2float_rn) and scaled by two separately rounded products, the
// epilogue of the TPU kernel, so the result is bitwise that of the plain
// version (ref.int8_matmul_exact).  Not its block structure: any M and N,
// any K that is a multiple of 4 (zero-filled past the edges), where the TPU
// kernel asked M, N and K to be multiples of its blocks.
//
// What bounds it on this card: operations.  At the calibration's and the
// smoke run's shapes the product does 2MNK integer operations on MK + KN
// bytes, hundreds of operations per byte, far above the H100's 1,979 int8
// TOP/s / 3.35 TB/s = 590.  The TPU kernel walked (bm, bn) output tiles with
// K innermost in grid order, accumulating in VMEM scratch.  Here one block
// owns a 128 x 128 output tile and walks K in 64-byte steps, the int32 sums
// in registers; 8 warps, each a 64 x 32 part of the tile, run
// mma.sync.m16n8k32 (s8 x s8 -> s32) on the tensor cores.  The int8
// tensor-core product takes both operands with K contiguous, so w_q, which
// is K-major in memory only across rows, is transposed on its way into
// shared memory: each thread loads a 4 (k) x 8 (n) block as four 8-byte
// rows (a warp reads 128 contiguous bytes of each row) and regroups the
// bytes with __byte_perm into eight words of four consecutive k.  Tiles
// are staged through registers into a double buffer, so the next tile's
// loads are in flight while the current one is multiplied, with one
// barrier per step.  Shared-memory words are XOR-swizzled so that the
// fragment reads are free of bank conflicts (the transposing stores of w
// are 2-way).  The wgmma/TMA form is the later speed-up.
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {
namespace {

constexpr int BM = 128, BN = 128, BK = 64;  // block tile; BK in bytes of K
constexpr int THREADS = 256;                 // 8 warps: 2 (rows) x 4 (columns)
constexpr int WM = 64, WN = 32;              // warp tile
constexpr int MT = WM / 16, NT = WN / 8;     // mma tiles per warp: 4 x 4
constexpr int KW = BK / 4;                   // 32-bit words of K per tile row

// Word index of (row, word kw) in a tile of rows of KW words.  Fragment
// reads touch rows r..r+7 (r a multiple of 8) and words w0..w0+3 (w0 a
// multiple of 4); bits 1-2 of the row move the four-word group so those
// 32 reads land on 32 banks.  B's rows also XOR in row / 8, which spreads
// the transposing stores (rows 8 apart) over the banks.
__device__ __forceinline__ int swz_a(int row, int kw) {
  return row * KW + (kw ^ (((row >> 1) & 3) << 2));
}
__device__ __forceinline__ int swz_b(int row, int kw) {
  return row * KW + (kw ^ (((row >> 1) & 3) << 2) ^ ((row >> 3) & 15));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 4 x 4 byte transpose: in[i] holds row i's bytes 0..3; out[j] holds byte j
// of rows 0..3.
__device__ __forceinline__ void transpose4(const uint32_t (&in)[4], uint32_t* out) {
  const uint32_t t0 = __byte_perm(in[0], in[1], 0x5140);  // r0.b0 r1.b0 r0.b1 r1.b1
  const uint32_t t1 = __byte_perm(in[0], in[1], 0x7362);  // r0.b2 r1.b2 r0.b3 r1.b3
  const uint32_t t2 = __byte_perm(in[2], in[3], 0x5140);
  const uint32_t t3 = __byte_perm(in[2], in[3], 0x7362);
  out[0] = __byte_perm(t0, t2, 0x5410);
  out[1] = __byte_perm(t0, t2, 0x7632);
  out[2] = __byte_perm(t1, t3, 0x5410);
  out[3] = __byte_perm(t1, t3, 0x7632);
}

__global__ void __launch_bounds__(THREADS)
    int8_mm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ sx, const float* __restrict__ sw,
                   float* __restrict__ out, int M, int N, int K) {
  __shared__ uint32_t As[2][BM * KW];  // [buf][row m][k word], swizzled
  __shared__ uint32_t Bs[2][BN * KW];  // [buf][col n][k word], swizzled
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // mma groupID, threadID_in_group
  const int wm = warp & 1, wn = warp >> 1;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const bool n_vec = (N % 8) == 0;

  // staging: A as BM x KW words, thread tid takes words tid + 256 i (a
  // warp covers two rows); B as (BK / 4) x (BN / 8) blocks of 4 k x 8 n,
  // thread tid takes block kg = tid / 16, ng = tid % 16
  uint32_t ra[BM * KW / THREADS];
  uint32_t rb[8];
  const int kg = tid >> 4, ng = tid & 15;
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < BM * KW / THREADS; ++i) {
      const int idx = tid + i * THREADS, row = idx / KW, kk = k0 + 4 * (idx % KW);
      const int m = m0 + row;
      ra[i] = (m < M && kk < K)
                  ? *reinterpret_cast<const uint32_t*>(x + (int64_t)m * K + kk)
                  : 0u;
    }
    const int kk = k0 + 4 * kg, n = n0 + 8 * ng;
    uint32_t lo[4], hi[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      lo[i] = hi[i] = 0u;
      if (kk < K && n < N) {
        const int8_t* src = w + (int64_t)(kk + i) * N + n;
        if (n_vec) {
          const uint2 v = *reinterpret_cast<const uint2*>(src);
          lo[i] = v.x;
          hi[i] = v.y;
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const uint32_t byte = n + j < N ? (uint32_t)(uint8_t)src[j] : 0u;
            if (j < 4) lo[i] |= byte << (8 * j);
            else hi[i] |= byte << (8 * (j - 4));
          }
        }
      }
    }
    transpose4(lo, rb);
    transpose4(hi, rb + 4);
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < BM * KW / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      As[buf][swz_a(idx / KW, idx % KW)] = ra[i];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) Bs[buf][swz_b(8 * ng + j, kg)] = rb[j];
  };

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int nk = (K + BK - 1) / BK;
  load(0);
  store(0);
  __syncthreads();
  for (int kt = 0, cur = 0; kt < nk; ++kt, cur ^= 1) {
    const bool more = kt + 1 < nk;
    if (more) load((kt + 1) * BK);  // in flight while this tile is multiplied
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      const int w0 = ks * 8;  // first word of this 32-byte step of K
      uint32_t a[MT][4], b[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int r = wm * WM + i * 16 + g;
        a[i][0] = As[cur][swz_a(r, w0 + t)];
        a[i][1] = As[cur][swz_a(r + 8, w0 + t)];
        a[i][2] = As[cur][swz_a(r, w0 + 4 + t)];
        a[i][3] = As[cur][swz_a(r + 8, w0 + 4 + t)];
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c = wn * WN + j * 8 + g;
        b[j][0] = Bs[cur][swz_b(c, w0 + t)];
        b[j][1] = Bs[cur][swz_b(c, w0 + 4 + t)];
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_s8(acc[i][j], a[i], b[j]);
    }
    if (more) store(cur ^ 1);  // that half was last read before the previous barrier
    __syncthreads();
  }

  // epilogue: c0, c1 at (row g, columns 2t, 2t + 1), c2, c3 at row g + 8
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * WM + i * 16 + g + 8 * h;
      if (m >= M) continue;
      const float s = sx[m];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn * WN + j * 8 + 2 * t + e;
          if (n < N)
            out[(int64_t)m * N + n] =
                __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][2 * h + e]), s), sw[n]);
        }
      }
    }
  }
}

}  // namespace
}  // namespace repro_torch

// x: (M, K) int8 and w: (K, N) int8, row-major and contiguous, K % 4 == 0,
// x 4-byte and w 8-byte aligned; sx: (M,), sw: (N,), out: (M, N) fp32.
extern "C" int int8_matmul_fwd(const int8_t* x, const int8_t* w, const float* sx,
                               const float* sw, float* out, int M, int N, int K,
                               void* stream) {
  using namespace repro_torch;
  if (M < 0 || N < 0 || K < 0 || K % 4 != 0 || (M + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return (int)cudaSuccess;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  int8_mm_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(x, w, sx, sw,
                                                                          out, M, N, K);
  return (int)cudaGetLastError();
}
