// Decode attention on Hopper (sm_90a): one query token per sequence against
// the KV cache, the cache split across blocks (split-KV), fp32 accumulation.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py ::
// decode_attention (_decode_kernel).  Same function: the G = H/K query heads
// of a kv head share each K/V row, online softmax, tanh softcap and a
// per-sequence `lengths` bound.  It also takes what decoding against the
// model's cache needs and the TPU kernel lacks: a window and, optionally,
// the position each cache slot holds (`slot_pos`, -1 = empty) with the
// query's position `q_pos`.  The mask is pos >= 0 && pos <= q_pos &&
// pos > q_pos - window (window 0 = global) && t < lengths[b]; without
// slot_pos, slot t holds position t and q_pos = lengths[b] - 1.  A head
// with no live slot gets 0.
//
// What bounds it on this card: bytes.  Every live K/V row is read once and
// used for 4·G·d operations, far below the H100's 295 operations per byte,
// so the kernel has to keep the card's 3.35 TB/s busy.  The TPU grid walked
// the cache sequentially with m/l/acc in VMEM scratch; a first port gave one
// block to each (b, kv head), 16-32 blocks on 132 SMs at batch 8 reading
// single elements per lane, about 0.2 TB/s.  This design:
// - Split-KV.  The grid is (split, kv head, b); the wrapper's planner
//   (decode_attention.plan_splits) cuts each (b, kv head)'s cache into
//   contiguous ranges of `chunk` slots, a multiple of 64, so the grid holds
//   about 2 x 132 blocks where T allows.  A split with no live slot (past
//   `len`, or, without slot_pos, before the window) returns at once.
// - Loads.  q and the K/V tiles move 16 bytes a thread through cp.async,
//   the tiles into a ring of 2-3 stages (64 KB at d = 256 in bf16), so the
//   next tiles' loads are in flight while the current one is multiplied,
//   and q's load overlaps the first tiles'.  Rows are XOR-swizzled in
//   16-byte chunks (swz), which keeps ldmatrix and the copies free of bank
//   conflicts.  Slots past `len` are zero-filled, not read.
// - bf16 products on the tensor cores (mma.sync.m16n8k16, fp32
//   accumulation).  Each warp takes 16 slots of the tile on the M side and
//   the G query heads, padded to 8 or 16, on N: Sᵀ = K·qᵀ, then
//   Oᵀ += Vᵀ·Pᵀ with V read by ldmatrix.trans.  Slots on M waste no rows
//   at 2 heads per kv head (heads on M padded gemma2-2b's 2 to 16 rows,
//   and every score's softcap and exponential with them) and keep the
//   accumulator at d/4 registers a thread; P moves from the score
//   fragments into Pᵀ's B fragments by 8 shuffles a tile.  At G = 16 two
//   warps share each slot group, one per 8 heads: each K/V row is read
//   from memory once, in one block, and from shared memory twice.  The
//   warps keep their own online-softmax state and merge through shared
//   memory at the end.
// - Parity.  Held to one bf16 ulp of the float64 plain version on the
//   models' own activations, K2 needs none of the parity measures that K1
//   keeps (common.cuh; parity_probe.py on an H100): its products chain in
//   the mma accumulators, and the softcap and exponentials take the fast
//   MUFU forms.  P still goes in two bf16 parts: rounded once it moves the
//   output past one ulp (tests/test_torch_kernels.py::
//   test_split_p_holds_one_bf16_ulp).  A decode call has B·H·d outputs
//   where a prefill call has S times as many, so far fewer of them cancel
//   to near zero, where the fp32 sums' error shows.
// - Occupancy.  At d = 256 a block is 2 slot groups on 32-slot tiles and
//   three blocks share an SM (4 slot groups, 64-slot tiles below): one block's
//   prologue and epilogue overlap the others' loads (chip_smoke.py phase 3
//   at gemma2-2b's decode shape ran it faster than two blocks with 3-stage
//   rings, and than one block of 4 warps).
// - fp32 keeps IEEE FMA products on 32-slot tiles: a thread per (head,
//   slot) dot product, one warp per head for the softmax, a thread per
//   (head, column) output.
// - Combining the splits.  Each split writes its (m, l, acc) in fp32 to
//   scratch from the wrapper; a second small kernel, one block per (b,
//   head), merges them in split order (deterministic), the splits' weights
//   staged in shared memory so that all their column loads are in flight
//   together.  Chosen over "the last block of each (b, kv head) merges,
//   found by an atomic counter": that block would read all the partials
//   alone (512 KB at recurrentgemma's 32 splits of 16 heads), where the
//   combine spreads them over B·H blocks, and it needs no zeroed counter
//   kept between calls.  With one split the main kernel writes the output
//   and the combine is not launched.
// common.cuh's parity switches as K2 ships them (see the header)
#ifndef PARITY_QK_CHAIN
#define PARITY_QK_CHAIN 16
#endif
#ifndef PARITY_PV_FRESH
#define PARITY_PV_FRESH 0
#endif
#ifndef PARITY_P_PARTS
#define PARITY_P_PARTS 2
#endif
#ifndef PARITY_IEEE_EXP
#define PARITY_IEEE_EXP 0
#endif
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int MAXG = 16;  // query heads per kv head: the M side of one mma tile

struct DecodeArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* part;          // (B, K, nsplit, G, D + 2): acc[D], m, l; null when nsplit == 1
  const int* lengths;   // (B,)
  const int* q_pos;     // (B,) or null
  const int* slot_pos;  // (B, T) contiguous, or null
  int64_t q_sb, q_sh, k_sb, k_sh, k_st, v_sb, v_sh, v_st, o_sb, o_sh;
  int K, T, G, window, nsplit, chunk;
  float softcap, sm_scale;
};

// Block shape.  bf16: a warp takes 16 slots of a tile (its slot group)
// and 8 query heads (NG = 2 head tiles at G = 16: two warps per slot
// group); at d = 256, 2 slot groups and a 2-stage ring of 32-slot tiles
// (64 KB), so three blocks fit on an SM; below, 4 slot groups and a
// 3-stage ring of 64-slot tiles.  fp32: 4 warps, 32-slot tiles (one slot
// per lane of the softmax warp), the ring 128 KB at most.
template <typename T, int D, int NG>
struct Shape {
  static constexpr bool BF16 = sizeof(T) == 2;
  static constexpr int SG = BF16 ? (D == 256 ? 2 : 4) : 4;  // slot groups
  static constexpr int NWARPS = BF16 ? SG * NG : 4;
  static constexpr int NTHREADS = NWARPS * 32;
  static constexpr int TS = BF16 ? 16 * SG : 32;
  static constexpr int ST = BF16 ? (D == 256 ? 2 : 3) : D == 256 ? 2 : D == 128 ? 3 : 4;
};

// Dynamic shared memory: the K, V ring first, then regions at these byte
// offsets (the fp32 scores and softmax state in fp32 only).  After the loop
// the ring holds the bf16 slot groups' merge buffer, float [SG][G][D].
template <typename T, int D, int NG>
struct Smem : Shape<T, D, NG> {
  using Shape<T, D, NG>::BF16;
  using Shape<T, D, NG>::TS;
  using Shape<T, D, NG>::ST;
  using Shape<T, D, NG>::NWARPS;
  static constexpr size_t pos = (size_t)ST * TS * D * sizeof(T) * 2;      // int [ST][TS]
  static constexpr size_t q = pos + (size_t)ST * TS * sizeof(int);        // T [16][D]
  static constexpr size_t s = q + (size_t)MAXG * D * sizeof(T);           // scores [16][TS]
  static constexpr size_t st = s + (BF16 ? 0 : MAXG * TS * sizeof(float));  // m, l, alpha [16]
  static constexpr size_t wml = st + (BF16 ? 0 : 3 * MAXG * sizeof(float));  // groups' m, l
  static constexpr size_t row = wml + 2 * NWARPS * MAXG * sizeof(float);  // merged m, l [16]
  static constexpr size_t bytes = row + 2 * MAXG * sizeof(float);
};

__device__ __forceinline__ bool live(int pos, int qp, int window) {
  return pos >= 0 && pos <= qp && (window <= 0 || pos > qp - window);
}

// NG: tiles of 8 query heads on the mma's N side, (G + 7) / 8 (bf16 only).
template <typename T, int D, int NG>
__global__ void __launch_bounds__(Shape<T, D, NG>::NTHREADS) decode_kernel(DecodeArgs a) {
  using L = Smem<T, D, NG>;
  constexpr int TS = L::TS, ST = L::ST, NWARPS = L::NWARPS, NTHREADS = L::NTHREADS;
  constexpr bool BF16 = L::BF16;
  constexpr int EPC = 16 / sizeof(T);  // elements per 16-byte chunk
  constexpr int CPR = D / EPC;         // chunks per row
  extern __shared__ __align__(16) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = sK + ST * TS * D;
  int* sPos = reinterpret_cast<int*>(smem + L::pos);
  T* sQ = reinterpret_cast<T*>(smem + L::q);

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int G = a.G;
  const int64_t head0 = (int64_t)kvh * G;

  // q first, by cp.async (it joins the first tile's copy group): nothing
  // waits for it before the cache tiles are in flight
  const T* Qg = static_cast<const T*>(a.q) + b * a.q_sb + head0 * a.q_sh;
  for (int i = tid; i < (BF16 ? MAXG : G) * CPR; i += NTHREADS) {
    const int r = i / CPR, c = i % CPR;  // bf16: heads past G are zero rows of the mma
    cp_async16(sQ + (BF16 ? swz<CPR, EPC>(r, c) : r * D + c * EPC),
               Qg + (r < G ? r * a.q_sh : 0) + c * EPC, r < G);
  }

  const int len = max(0, min(a.lengths[b], a.T));
  const int qp = a.q_pos ? a.q_pos[b] : len - 1;
  const int* sp = a.slot_pos ? a.slot_pos + (int64_t)b * a.T : nullptr;
  const int s0 = split * a.chunk;
  int begin = s0;
  if (!sp && a.window > 0) begin = max(begin, qp - a.window + 1);
  const int end = min(s0 + a.chunk, len);
  const int first = s0 + (begin - s0) / TS * TS;
  const int ntiles = begin < end ? (end - first + TS - 1) / TS : 0;

  T* O = static_cast<T*>(a.o) + b * a.o_sb + head0 * a.o_sh;
  float* P = a.part ? a.part + (((int64_t)b * a.K + kvh) * a.nsplit + split) * G * (D + 2)
                    : nullptr;
  // The block's result for head `row`, column c: unnormalised sum x, max m
  // and sum l: the output with one split, else this split's partial.
  auto finish = [&](int row, int c, float x, float m, float l) {
    if (!P) {
      O[row * a.o_sh + c] = from_f<T>(l > 0.f ? x / l : 0.f);  // no live slot -> 0
    } else {
      P[row * (D + 2) + c] = x;
      if (c == 0) {
        P[row * (D + 2) + D] = m;
        P[row * (D + 2) + D + 1] = l;
      }
    }
  };
  if (ntiles == 0) {
    if (!P) {
      for (int i = tid; i < G * D; i += NTHREADS) finish(i / D, i % D, 0.f, -INFINITY, 0.f);
    } else if (tid < G) {
      finish(tid, 0, 0.f, -INFINITY, 0.f);  // l = 0: the combine skips this split
    }
    cp_async_commit();  // q's copies land before the block's shared memory goes
    cp_async_wait<0>();
    return;
  }

  const T* Kb = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* Vb = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  auto issue = [&](int tile) {
    const int stage = tile % ST, t0 = first + tile * TS;
    T* dk = sK + stage * TS * D;
    T* dv = sV + stage * TS * D;
    for (int i = tid; i < TS * CPR; i += NTHREADS) {
      const int r = i / CPR, c = i % CPR, t = t0 + r;
      const bool ok = t < end;
      const int64_t row = ok ? t : 0;
      cp_async16(dk + swz<CPR, EPC>(r, c), Kb + row * a.k_st + c * EPC, ok);
      cp_async16(dv + swz<CPR, EPC>(r, c), Vb + row * a.v_st + c * EPC, ok);
    }
    if (tid < TS) {
      const int t = t0 + tid;
      int* dp = sPos + stage * TS + tid;
      if (sp && t < end) {
        cp_async4(dp, sp + t);
      } else {
        *dp = t < end ? t : -1;
      }
    }
  };

  if constexpr (BF16) {
    // ---- bf16: tensor cores; warp w takes slots 16·(w % SG).. of each
    // tile and heads 8·(w / SG)..: slots on M, heads on N, Sᵀ = K·qᵀ and
    // Oᵀ += Vᵀ·Pᵀ.  Fragment coordinates (g = lane / 4, t4 = lane % 4): s
    // holds slots g and g + 8 of heads h0 + 2t4 and + 1; acc[mt] holds d
    // rows 16mt + g and + 8 of the same heads.
    constexpr int NM = D / 16, SG = L::SG;
    const int g = lane >> 2, t4 = lane & 3;
    const int sg = warp % SG, kw = 16 * sg, h0 = 8 * (warp / SG);
    float acc[NM][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int mt = 0; mt < NM; ++mt) acc[mt][0] = acc[mt][1] = acc[mt][2] = acc[mt][3] = 0.f;

    pipeline<ST>(ntiles, issue, [&](int tile) {
      const int stage = tile % ST;
      const T* tk = sK + stage * TS * D;
      const T* tv = sV + stage * TS * D;
      const int* pos = sPos + stage * TS + kw;
      float s[4] = {0.f, 0.f, 0.f, 0.f}, u[4];  // scores, the running chain (qk_mma)
#pragma unroll 4
      for (int kk = 0; kk < D / 16; kk += 2) {
        uint32_t qb[4];  // qᵀ as B: d 16kk..+7, +8..+15, then the same of kk + 1
        ldmatrix_x4(qb, sQ + swz<CPR, EPC>(h0 + (lane & 7), 2 * kk + (lane >> 3)));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t ka[4];  // K as A: slots 0-7 and 8-15 by d low, then d high
          ldmatrix_x4(ka, tk + swz<CPR, EPC>(kw + (lane & 15), 2 * (kk + h) + (lane >> 4)));
          qk_mma<D / 16>(s, u, kk + h, ka, qb[2 * h], qb[2 * h + 1]);
        }
      }
      const bool ok0 = live(pos[g], qp, a.window), ok1 = live(pos[g + 8], qp, a.window);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = softcap_tc(s[e] * a.sm_scale, a.softcap);
        s[e] = (e < 2 ? ok0 : ok1) ? x : -INFINITY;
      }
      // online softmax down each head's column of 16 slots
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float mx = fmaxf(s[j], s[2 + j]);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
        const float m_old = m[j], m_new = fmaxf(m_old, mx);
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        const float alpha = m_new == m_old ? 1.f : exp_tc(m_old - m_use);
        m[j] = m_new;
        s[j] = exp_tc(s[j] - m_use);
        s[2 + j] = exp_tc(s[2 + j] - m_use);
        l[j] = l[j] * alpha + s[j] + s[2 + j];
        if (m_new != m_old) {
#pragma unroll
          for (int mt = 0; mt < NM; ++mt) {
            acc[mt][j] *= alpha;
            acc[mt][2 + j] *= alpha;
          }
        }
      }
      // Pᵀ as B fragments: this thread takes head g's slots 2t4, 2t4 + 1
      // (b0) and 2t4 + 8, 2t4 + 9 (b1), held by lanes src and src + 4
      const int src = 8 * t4 + (g >> 1);
      const bool odd = g & 1;
      float p[4][2];  // [slot 2t4, 2t4 + 1, 2t4 + 8, 2t4 + 9][head g even, odd]
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        p[0][c] = __shfl_sync(0xffffffffu, s[c], src);
        p[1][c] = __shfl_sync(0xffffffffu, s[c], src + 4);
        p[2][c] = __shfl_sync(0xffffffffu, s[2 + c], src);
        p[3][c] = __shfl_sync(0xffffffffu, s[2 + c], src + 4);
      }
      constexpr int NP = PARITY_P_PARTS;
      uint32_t bp[NP][2], part[NP];  // Pᵀ's B registers in bf16 parts (split_bf16)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        split_bf16<NP>(odd ? p[2 * r][1] : p[2 * r][0], odd ? p[2 * r + 1][1] : p[2 * r + 1][0],
                       part);
#pragma unroll
        for (int i = 0; i < NP; ++i) bp[i][r] = part[i];
      }
#pragma unroll
      for (int mt = 0; mt < NM; ++mt) {
        uint32_t va[4];  // Vᵀ as A: d 16mt..+7, +8..+15 by slots 0-7, then 8-15
        ldmatrix_x4_trans(va, tv + swz<CPR, EPC>(kw + (lane & 7) + ((lane >> 4) << 3),
                                                 2 * mt + ((lane >> 3) & 1)));
        pv_mma(acc[mt], [&](int) -> const uint32_t(&)[4] { return va; },
               [&](int i, int e) { return bp[i][e]; });
      }
    });

    // merge the slot groups: the ring is free (no copy in flight, last
    // barrier passed)
    float* sAcc = reinterpret_cast<float*>(smem);  // [SG][G][D]
    float* sWM = reinterpret_cast<float*>(smem + L::wml);  // [SG][16]
    float* sWL = sWM + NWARPS * MAXG;
    float* sRM = reinterpret_cast<float*>(smem + L::row);
    float* sRL = sRM + MAXG;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float x = l[j];
      x += __shfl_xor_sync(0xffffffffu, x, 4);
      x += __shfl_xor_sync(0xffffffffu, x, 8);
      x += __shfl_xor_sync(0xffffffffu, x, 16);
      if (g == 0) {
        sWM[sg * MAXG + h0 + 2 * t4 + j] = m[j];
        sWL[sg * MAXG + h0 + 2 * t4 + j] = x;
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int head = h0 + 2 * t4 + j;
      if (head < G) {
        float M = -INFINITY;
#pragma unroll
        for (int w = 0; w < SG; ++w) M = fmaxf(M, sWM[w * MAXG + head]);
        const float f = m[j] == -INFINITY ? 0.f : expf(m[j] - M);
        float* dst = sAcc + (sg * G + head) * D + g;
#pragma unroll
        for (int mt = 0; mt < NM; ++mt) {
          dst[16 * mt] = acc[mt][j] * f;
          dst[16 * mt + 8] = acc[mt][2 + j] * f;
        }
      }
    }
    if (tid < G) {
      float M = -INFINITY, Lsum = 0.f;
#pragma unroll
      for (int w = 0; w < SG; ++w) M = fmaxf(M, sWM[w * MAXG + tid]);
#pragma unroll
      for (int w = 0; w < SG; ++w) {
        const float mw = sWM[w * MAXG + tid];
        if (mw != -INFINITY) Lsum = fmaf(sWL[w * MAXG + tid], expf(mw - M), Lsum);
      }
      sRM[tid] = M;
      sRL[tid] = Lsum;
    }
    __syncthreads();
    for (int i = tid; i < G * D; i += NTHREADS) {
      const int row = i / D, c = i % D;
      float x = 0.f;
#pragma unroll
      for (int w = 0; w < SG; ++w) x += sAcc[(w * G + row) * D + c];
      finish(row, c, x, sRM[row], sRL[row]);
    }
  } else {
    // ---- fp32: IEEE FMA, block-wide online softmax per 32-slot tile ----
    constexpr int NR = MAXG * D / NTHREADS;  // outputs a thread owns at most
    float* sS = reinterpret_cast<float*>(smem + L::s);
    float* sM = reinterpret_cast<float*>(smem + L::st);
    float* sL = sM + MAXG;
    float* sAlpha = sL + MAXG;
    if (tid < MAXG) {
      sM[tid] = -INFINITY;
      sL[tid] = 0.f;
    }
    float acc[NR];
#pragma unroll
    for (int r = 0; r < NR; ++r) acc[r] = 0.f;

    pipeline<ST>(ntiles, issue, [&](int tile) {
      const int stage = tile % ST;
      const T* tk = sK + stage * TS * D;
      const T* tv = sV + stage * TS * D;
      // scores: a warp takes one head against the tile's 32 slots
      for (int p = tid; p < G * TS; p += NTHREADS) {
        const int hg = p / TS, j = p % TS;
        const float* qr = sQ + hg * D;
        float dot = 0.f;
#pragma unroll 8
        for (int c = 0; c < CPR; ++c) {
          const float4 kx = *reinterpret_cast<const float4*>(tk + swz<CPR, EPC>(j, c));
          const float4 qx = *reinterpret_cast<const float4*>(qr + 4 * c);
          dot = fmaf(qx.x, kx.x, dot);
          dot = fmaf(qx.y, kx.y, dot);
          dot = fmaf(qx.z, kx.z, dot);
          dot = fmaf(qx.w, kx.w, dot);
        }
        sS[hg * TS + j] = softcap_f(dot * a.sm_scale, a.softcap);
      }
      __syncthreads();
      // softmax: a warp per head, a lane per slot
      for (int hg = warp; hg < G; hg += NWARPS) {
        const bool ok = live(sPos[stage * TS + lane], qp, a.window);
        const float x = ok ? sS[hg * TS + lane] : -INFINITY;
        const float m_old = sM[hg];
        const float m_new = fmaxf(m_old, warp_max(x));
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        const float p = expf(x - m_use);
        const float sum = warp_sum(p);
        sS[hg * TS + lane] = p;
        __syncwarp();
        if (lane == 0) {
          const float alpha = expf(m_old - m_use);
          sM[hg] = m_new;
          sL[hg] = sL[hg] * alpha + sum;
          sAlpha[hg] = alpha;
        }
      }
      __syncthreads();
      // P·V: a thread per (head, column)
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        const int i = tid + r * NTHREADS;
        if (i < G * D) {
          const int hg = i / D, c = i % D;
          float x = acc[r] * sAlpha[hg];
#pragma unroll 8
          for (int j = 0; j < TS; ++j)
            x = fmaf(sS[hg * TS + j], tv[swz<CPR, EPC>(j, c / EPC) + c % EPC], x);
          acc[r] = x;
        }
      }
    });

#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const int i = tid + r * NTHREADS;
      if (i < G * D) finish(i / D, i % D, acc[r], sM[i / D], sL[i / D]);
    }
  }
}

// Merge the splits' partials: one block per (head, b), a thread per column.
// The splits' weights e^(m_s - M) go through shared memory first, so the
// column loads of all splits are independent and in flight together.
template <typename T, int D>
__global__ void __launch_bounds__(D) combine_kernel(DecodeArgs a) {
  extern __shared__ float sw[];  // [nsplit] weights, then [nsplit] sums l
  float* sl = sw + a.nsplit;
  const int h = blockIdx.x, b = blockIdx.y, c = threadIdx.x;
  const int kvh = h / a.G, row = h % a.G;
  const int64_t stride = (int64_t)a.G * (D + 2);  // from one split to the next
  const float* p = a.part + ((int64_t)b * a.K + kvh) * a.nsplit * stride + row * (D + 2);
  for (int s = c; s < a.nsplit; s += D) {
    sl[s] = p[s * stride + D + 1];
    sw[s] = p[s * stride + D];
  }
  __syncthreads();
  float M = -INFINITY;
  for (int s = 0; s < a.nsplit; ++s)
    if (sl[s] > 0.f) M = fmaxf(M, sw[s]);  // an empty split wrote only m and l = 0
  __syncthreads();
  for (int s = c; s < a.nsplit; s += D) sw[s] = sl[s] > 0.f ? expf(sw[s] - M) : 0.f;
  __syncthreads();
  float L = 0.f, x = 0.f;
#pragma unroll 8
  for (int s = 0; s < a.nsplit; ++s) {
    const float f = sw[s];
    if (f > 0.f) {
      L = fmaf(sl[s], f, L);
      x = fmaf(p[s * stride + c], f, x);
    }
  }
  T* O = static_cast<T*>(a.o) + b * a.o_sb + (int64_t)h * a.o_sh;
  O[c] = from_f<T>(L > 0.f ? x / L : 0.f);
}

template <typename T, int D, int NG>
cudaError_t launch_ng(const DecodeArgs& a, int B, cudaStream_t stream) {
  constexpr size_t smem = Smem<T, D, NG>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<T, D, NG>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  constexpr int threads = Shape<T, D, NG>::NTHREADS;
  decode_kernel<T, D, NG><<<dim3(a.nsplit, a.K, B), threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(const DecodeArgs& a, int B, cudaStream_t stream) {
  cudaError_t err;
  if constexpr (sizeof(T) == 2) {
    err = a.G > 8 ? launch_ng<T, D, 2>(a, B, stream) : launch_ng<T, D, 1>(a, B, stream);
  } else {
    err = launch_ng<T, D, 1>(a, B, stream);
  }
  if (err != cudaSuccess || a.nsplit == 1) return err;
  const size_t cmem = 2 * sizeof(float) * a.nsplit;
  if (cmem > 48 * 1024) return cudaErrorInvalidValue;
  combine_kernel<T, D><<<dim3(a.K * a.G, B), D, cmem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const DecodeArgs& a, int B, int d, cudaStream_t stream) {
  switch (d) {
    case 64: return launch<T, 64>(a, B, stream);
    case 128: return launch<T, 128>(a, B, stream);
    case 256: return launch<T, 256>(a, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro_torch

// strides: 10 element strides — q (b, head), k (b, head, slot), v (b, head,
// slot), out (b, head); the head dimension must be contiguous and rows
// 16-byte aligned.  dtype: 0 = float32, 1 = bfloat16.  The cache is cut into
// nsplit ranges of `chunk` slots (a multiple of 64); with nsplit > 1, part
// is fp32 scratch of B·K·nsplit·(H/K)·(d + 2) floats.
extern "C" int decode_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                    float* part, const int* lengths, const int* q_pos,
                                    const int* slot_pos, const long long* strides, int B,
                                    int H, int K, int T, int d, int dtype, int window,
                                    int nsplit, int chunk, float softcap, float sm_scale,
                                    void* stream) {
  using namespace repro_torch;
  const int G = H / K;
  if (G < 1 || G > MAXG || G * K != H || nsplit < 1 || chunk < 64 || chunk % 64 ||
      (nsplit > 1 && !part))
    return (int)cudaErrorInvalidValue;
  DecodeArgs a;
  a.q = q; a.k = k; a.v = v; a.o = o; a.part = nsplit > 1 ? part : nullptr;
  a.lengths = lengths; a.q_pos = q_pos; a.slot_pos = slot_pos;
  a.q_sb = strides[0]; a.q_sh = strides[1];
  a.k_sb = strides[2]; a.k_sh = strides[3]; a.k_st = strides[4];
  a.v_sb = strides[5]; a.v_sh = strides[6]; a.v_st = strides[7];
  a.o_sb = strides[8]; a.o_sh = strides[9];
  a.K = K; a.T = T; a.G = G; a.window = window; a.nsplit = nsplit; a.chunk = chunk;
  a.softcap = softcap; a.sm_scale = sm_scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_d<float>(a, B, d, st);
  if (dtype == 1) return (int)launch_d<__nv_bfloat16>(a, B, d, st);
  return (int)cudaErrorInvalidValue;
}
