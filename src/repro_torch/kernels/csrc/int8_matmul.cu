// Int8 x int8 -> fp32 quantized matrix product on Hopper (sm_90a):
//
//   out[m, n] = (fp32(sum_k x_q[m, k] * w_q[k, n]) * sx[m]) * sw[n]
//
// Replaces the Pallas TPU kernel src/repro/kernels/int8_matmul.py ::
// int8_matmul (_int8_mm_kernel).  Same function: x_q (M, K) and w_q (K, N)
// int8, sx (M,) and sw (N,) fp32 in; out (M, N) fp32.  The sum is exact in
// int32, converted to fp32 with round-to-nearest-even (__int2float_rn) and
// scaled by two separately rounded products, the epilogue of the TPU kernel,
// so the result is bitwise that of the plain version (ref.int8_matmul_exact).
// Not its block structure: any M and N, any K that is a multiple of 4, where
// the TPU kernel asked M, N and K to be multiples of its blocks.
//
// What bounds it on this card: operations.  The product does 2MNK integer
// operations on MK + KN bytes, hundreds of operations per byte at the
// calibration's and the smoke run's shapes, above the H100's 1,979 int8
// TOP/s / 3.35 TB/s = 590.  Only wgmma reaches that rate, and its 8-bit form
// takes both operands K-major (no transposed form for 8-bit types).  So:
// - w arrives (K, N) row-major, N-major.  transpose_kernel first writes a
//   K-major copy, wt (N, Kp), into scratch the wrapper allocates: 64 x 64-byte
//   tiles through shared memory, 16-byte loads and stores, zeros past K.  A w
//   that arrives column-major (w.T contiguous, K a multiple of 16) is used as
//   it is, and the pass is skipped.
// - x (M, K) is K-major already.  TMA needs 16-byte row strides, so the
//   wrapper zero-pads x to Kp = K rounded up to 16 when K is not a multiple
//   of 16 (a copy of M x Kp bytes; no shape of the model paths needs it).
// - int8_mm_kernel: one block owns a BM x BN = 128 x 128 output tile and
//   walks K in BK = 128-byte steps, one 128-byte swizzle row.  Warpgroup 2
//   is the producer: one thread keeps a ring of STAGES = 6 tiles in flight
//   with TMA (cp.async.bulk.tensor.2d, 128-byte swizzle, OOB rows and K past
//   Kp zero-filled), each stage's arrival counted on a "full" mbarrier.
//   Warpgroups 0 and 1 are consumers, 64 rows each: per stage four
//   wgmma.m64n128k32.s32.s8.s8 straight from the swizzled tiles, the int32
//   sums in registers (64 a thread); a stage goes back to the producer
//   through an "empty" mbarrier (one arrival per consumer warp) once the
//   next stage's wgmma group is issued and this one's has retired, so one
//   group is always in flight.  The first wgmma overwrites the sums, so no
//   other instruction defines them (ptxas would serialize the wgmmas).
//   setmaxnreg moves registers from the producer (40) to the consumers
//   (232).  The epilogue converts and scales each sum in registers and
//   stores it; zeros keep the sums over padded K exact.
// - The tile: 128 x 128 against 128 x 256, both timed on an H100 at
//   chip_smoke.py's two K5 rows (PERF.md), is 1-2% slower at gemma2-2b's
//   down-projection, 4096 x 9216 x 2304 (576 tiles, 4.4 waves of 132 SMs,
//   against 288), and faster on the calibration sweep, K5's only caller,
//   whose largest point, 1024 x 512 x 512, fills 32 of the 132 SMs.
// Shared memory: STAGES x (BM + BN) x 128 bytes = 192 KB and 2 x STAGES
// mbarriers; one block per SM, 168 registers a thread (ptxas), no spills.
// The tensor maps are built on the host in int8_matmul_fwd
// (cuTensorMapEncodeTiled, found in the already loaded driver with dlsym),
// kept per operand for the calls that follow (make_map), and passed as
// __grid_constant__ parameters.
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int BM = 128, BN = 128, BK = 128;  // BK in bytes of K
constexpr int STAGES = 6;
constexpr int A_BYTES = BM * BK, B_BYTES = BN * BK, STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int CONSUMERS = 2;                     // warpgroups of 64 rows
constexpr int THREADS = 128 * (CONSUMERS + 1);   // + the producer warpgroup
constexpr int SMEM_BYTES = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * 8;
constexpr int ACC = BN / 2;                      // int32 sums a consumer thread holds

// d (+)= a * b: 64 rows of A (K-major, descriptor a) times 128 rows of B (K-major, descriptor b), 32 bytes of K, int32 sums; accumulate 0
// overwrites d, so no other instruction defines the sums (which would
// serialize the wgmma pipeline).
__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}


__global__ void __launch_bounds__(THREADS, 1)
    int8_mm_kernel(const __grid_constant__ CUtensorMap tm_x,
                   const __grid_constant__ CUtensorMap tm_w, const float* __restrict__ sx,
                   const float* __restrict__ sw, float* __restrict__ out, int M, int N, int nk) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* tiles = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(tiles + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS * 4);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == CONSUMERS) {  // the producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % STAGES;
        mbar_wait(&empty[s], ((kt / STAGES) & 1) ^ 1);  // the first round passes
        uint8_t* a = tiles + s * STAGE_BYTES;
        mbar_expect_tx(&full[s], STAGE_BYTES);
        tma_load(a, &tm_x, &full[s], kt * BK, m0);
        tma_load(a + A_BYTES, &tm_w, &full[s], kt * BK, n0);
      }
    }
  } else {  // consumers: rows 64 wg .. 64 wg + 63 of the tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    int acc[ACC];
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % STAGES;
      mbar_wait(&full[s], (kt / STAGES) & 1);
      const uint8_t* a = tiles + s * STAGE_BYTES + wg * 64 * BK;
      const uint64_t da = kmajor_desc(a);
      const uint64_t db = kmajor_desc(tiles + s * STAGE_BYTES + A_BYTES);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk)
        wgmma_s8_n128(acc, da + 2 * kk, db + 2 * kk, kt > 0 || kk > 0);
      wgmma_commit();
      fence_regs(acc);
      wgmma_wait<1>();  // the previous stage's group has retired: release it
      if (kt > 0 && (tid & 31) == 0) mbar_arrive(&empty[(kt - 1) % STAGES]);
    }
    wgmma_wait<0>();
    fence_regs(acc);

    // epilogue: sum 4j + e sits at row 16 (warp) + lane / 4 (+ 8 for e >= 2),
    // column 8j + 2 (lane % 4) (+ 1 for odd e)
    const int lane = tid & 31, g = lane >> 2, q = lane & 3;
    const bool pairs = (N % 2) == 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wg * 64 + (tid >> 5) * 16 + g + 8 * h;
      if (m >= M) continue;
      const float s = sx[m];
      float* row = out + (int64_t)m * N;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int n = n0 + 8 * j + 2 * q;
        if (n >= N) continue;
        const float v0 = __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * h]), s), sw[n]);
        if (n + 1 < N) {
          const float v1 =
              __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * h + 1]), s), sw[n + 1]);
          if (pairs) {
            *reinterpret_cast<float2*>(row + n) = make_float2(v0, v1);
          } else {
            row[n] = v0;
            row[n + 1] = v1;
          }
        } else {
          row[n] = v0;
        }
      }
    }
  }
}

// wt[n, k] = w[k, n] for k < K, 0 for K <= k < Kp: 64 (k) x 64 (n) bytes a
// block, loaded 16 bytes a thread along n, stored 16 bytes a thread along k.
__global__ void __launch_bounds__(256)
    transpose_kernel(const int8_t* __restrict__ w, int8_t* __restrict__ wt, int K, int N,
                     int Kp, int vec) {
  __shared__ uint8_t tile[64][65];  // [n][k]
  const int t = threadIdx.x, k0 = blockIdx.y * 64, n0 = blockIdx.x * 64;
  {
    const int kr = t >> 2, nc = (t & 3) * 16, k = k0 + kr, n = n0 + nc;
    uint8_t b[16];
    if (k < K && vec && n + 16 <= N) {
      const uint4 v = *reinterpret_cast<const uint4*>(w + (int64_t)k * N + n);
      const uint8_t* p = reinterpret_cast<const uint8_t*>(&v);
#pragma unroll
      for (int j = 0; j < 16; ++j) b[j] = p[j];
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j)
        b[j] = (k < K && n + j < N) ? (uint8_t)w[(int64_t)k * N + n + j] : 0;
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) tile[nc + j][kr] = b[j];
  }
  __syncthreads();
  const int nr = t >> 2, kc = (t & 3) * 16, n = n0 + nr, k = k0 + kc;
  if (n < N && k < Kp) {
    uint32_t word[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      word[i] = (uint32_t)tile[nr][kc + 4 * i] | (uint32_t)tile[nr][kc + 4 * i + 1] << 8 |
                (uint32_t)tile[nr][kc + 4 * i + 2] << 16 |
                (uint32_t)tile[nr][kc + 4 * i + 3] << 24;
    *reinterpret_cast<uint4*>(wt + (int64_t)n * Kp + k) =
        make_uint4(word[0], word[1], word[2], word[3]);
  }
}

// Tensor map of a K-major (rows, Kp) int8 matrix, boxes of box_rows x BK
// bytes.  A map is a function of these four numbers alone, so the last few
// that this host thread encoded are kept and reused: the calibration sweep
// calls with the same operands again and again, and PyTorch's caching
// allocator hands the wrapper's scratch back at the same address.
struct MapEntry {
  CUtensorMap map;
  const int8_t* ptr;
  int rows, Kp, box_rows;
};
constexpr int MAP_CACHE = 8;
thread_local MapEntry map_cache[MAP_CACHE];
thread_local int map_next = 0;

bool make_map(CUtensorMap* map, const int8_t* ptr, int rows, int Kp, int box_rows) {
  for (const MapEntry& e : map_cache)
    if (e.ptr == ptr && e.rows == rows && e.Kp == Kp && e.box_rows == box_rows) {
      *map = e.map;
      return true;
    }
  const EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)Kp, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)Kp};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  if (fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<int8_t*>(ptr), dims, strides, box,
         elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  map_cache[map_next] = {*map, ptr, rows, Kp, box_rows};
  map_next = (map_next + 1) % MAP_CACHE;
  return true;
}

}  // namespace
}  // namespace repro_torch

// x: (M, Kp) int8 row-major, zero past K, Kp a multiple of 16 (>= 16);
// w_kmajor 1: w is (N, Kp) K-major and used as it is; 0: w is (K, N)
// row-major and transposed into wt, (N, Kp) scratch; sx: (M,), sw: (N,),
// out: (M, N) fp32.  x, w and wt 16-byte aligned.
extern "C" int int8_matmul_fwd(const int8_t* x, const int8_t* w, int8_t* wt, const float* sx,
                               const float* sw, float* out, int M, int N, int K, int Kp,
                               int w_kmajor, void* stream_ptr) {
  using namespace repro_torch;
  if (M < 0 || N < 0 || K < 0 || K % 4 != 0 || Kp % 16 != 0 || Kp < K || Kp < 16 ||
      (M + BM - 1) / BM > 65535 || (Kp + 63) / 64 > 65535)
    return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return (int)cudaSuccess;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int8_t* wk = w;
  if (!w_kmajor) {
    const int vec = (N % 16 == 0) && (reinterpret_cast<uintptr_t>(w) % 16 == 0);
    transpose_kernel<<<dim3((N + 63) / 64, (Kp + 63) / 64), 256, 0, stream>>>(w, wt, K, N, Kp,
                                                                             vec);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    wk = wt;
  }
  CUtensorMap tm_x, tm_w;
  if (!make_map(&tm_x, x, M, Kp, BM) || !make_map(&tm_w, wk, N, Kp, BN))
    return (int)cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      int8_mm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (attr != cudaSuccess) return (int)attr;
  int8_mm_kernel<<<dim3((N + BN - 1) / BN, (M + BM - 1) / BM), THREADS, SMEM_BYTES, stream>>>(
      tm_x, tm_w, sx, sw, out, M, N, (Kp + BK - 1) / BK);
  return (int)cudaGetLastError();
}
