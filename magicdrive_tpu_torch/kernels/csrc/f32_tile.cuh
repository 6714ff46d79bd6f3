// The fp32 pieces of the hand-written attention kernels' fp32 instances,
// for Hopper (sm_90a): the FFMA product over [row][k] shared tiles, the
// cp.async ring of the GEMM tiles of K1's kv projection and K8's
// out-projection (f32_attention.cu; K4's design, whose own copy in
// f32_geglu.cu K3 and K4 keep), and the attention tiles and online-softmax
// core that K1/K2 (f32_attention.cu) and K5/K6 (f32_flash.cu) run.
//
// The fp32 instances of K1-K8 keep fp32 arithmetic end to end: every cast
// point of the bf16 contract (kernels/reference.py) is the identity, so the
// products accumulate fp32 operands in fp32. Hopper's tensor cores take fp32
// only as TF32 (about three decimal digits), which reads near 1e-3 of
// max|ref| on these shapes, ten times past the fp32 gate (chip_smoke.py
// KERNEL_TOL_F32): the products here are FFMA on the CUDA cores.
//
// Bound: the CUDA cores' fp32 rate, 67 TFLOP/s on an H100 SXM (132 SMs x 4
// schedulers x one 32-lane FFMA a clock at 1.98 GHz; the tensor cores' 989
// bf16 TFLOP/s do not apply), so every product of these kernels is bound
// by operations rather than bytes at the path's shapes. A scheduler issues
// one instruction a clock, so what decides the time is how few other
// instructions (shared loads, the softmax, the copies) go with each FFMA,
// and how evenly the grid fills the SMs.
//
// Design (what keeps the FFMA pipes fed):
//  * both operands of every product are k-contiguous [row][k] tiles in
//    shared memory, read as float4 along k: lane (ty, tx) = (lane / 8,
//    lane % 8) of a warp owns rows ty + 4 i and columns tx + 8 j of the
//    warp's block, so a k step of 4 takes TI + TJ loads for 4 TI TJ FFMAs
//    (8 x 8: 16 loads for 256). The pitches put the 4 rows of an A load and
//    the 8 rows of a B load in distinct 4-bank groups;
//  * operands arrive by 16-byte cp.async (zeros outside the tensor) into a
//    ring of stages, the next stage's copies in flight while the current
//    one is multiplied; no register staging;
//  * attention: a warp owns its rows (q rows, or keys in K6's dk/dv) for
//    the whole walk, so the logits, p and ds it stages as the A operand of
//    the next product never leave the warp. The streamed tile the second
//    product reads across its rows (v for o += p v, k for dq += ds k, q
//    and dO for dk and dv) is transposed once a tile in shared memory into
//    [d][row], so that product too reads float4 along k; two barriers a
//    tile, one for the stage and one for the transposed copy;
//  * softmax statistics stay fp32 in registers; exp is exp2 of the logit
//    times log2(e), one FFMA and one MUFU a logit; each thread keeps its
//    part of a row sum and the row's 8 threads add them once at the end;
//  * every output sums its k in increasing order in one thread: no atomics,
//    no split of k, two calls bitwise equal.
#pragma once

#include "common.cuh"
#include "flash_tile.cuh"

namespace mdk {
namespace f32 {

using tile::cp16;
using tile::cp_commit;
using tile::cp_vec;
using tile::cp_wait;

constexpr int BK = 32;     // k depth of a GEMM ring stage
constexpr int P = BK + 4;  // pitch of a [row][k] GEMM stage tile (floats)
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ int lane_ty() { return (threadIdx.x & 31) >> 3; }
__device__ __forceinline__ int lane_tx() { return threadIdx.x & 7; }
__device__ __forceinline__ int warp() { return threadIdx.x >> 5; }

// acc[i][j] += sum_{k < KD} a[4 i * LDA + k] * b[boff(j) * LDB + k], k in
// increasing order: a and b point at the thread's first row of A and of B
// ([row][k] tiles, 16-byte aligned rows), B's column j at row boff(j) =
// 8 (j % JG) + GS (j / JG). KU: the k steps of 4 unrolled together, which
// lets the compiler load ahead for as many registers as the block allows.
template <int TI, int TJ, int JG, int GS, int LDA, int LDB, int KD, int KU>
__device__ __forceinline__ void fma_rows(float (&acc)[TI][TJ],
                                         const float* __restrict__ a,
                                         const float* __restrict__ b) {
#pragma unroll (KU)
  for (int k = 0; k < KD; k += 4) {
    float4 av[TI];
#pragma unroll
    for (int i = 0; i < TI; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + 4 * i * LDA + k);
#pragma unroll
    for (int j = 0; j < TJ; ++j) {
      const float4 bv = *reinterpret_cast<const float4*>(
          b + (8 * (j % JG) + GS * (j / JG)) * LDB + k);
#pragma unroll
      for (int i = 0; i < TI; ++i) {
        acc[i][j] = fmaf(av[i].x, bv.x, acc[i][j]);
        acc[i][j] = fmaf(av[i].y, bv.y, acc[i][j]);
        acc[i][j] = fmaf(av[i].z, bv.z, acc[i][j]);
        acc[i][j] = fmaf(av[i].w, bv.w, acc[i][j]);
      }
    }
  }
}

template <int TI, int TJ>
__device__ __forceinline__ void zero(float (&acc)[TI][TJ]) {
#pragma unroll
  for (int i = 0; i < TI; ++i)
#pragma unroll
    for (int j = 0; j < TJ; ++j) acc[i][j] = 0.0f;
}

// ---- the GEMM tiles of the kv and out projections (K4's, f32_geglu.cu) --

// A thread's copies into a stage tile: 16 bytes at column c of rows
// r + BAND p (r = threadIdx / 8, c = threadIdx % 8 * 4), the pass p over
// the tile's bands of BAND = NT / 8 rows (NT threads a block).
template <int NT>
constexpr int BAND = NT / (BK / 4);

// A thread's sources of a dual product's stage tiles at m0 (x) and n0: its
// row and column of x and of the value rows' matrix (K8's out-projection:
// Wout, whose second N rows are the gate columns, as W1's are K4's) and,
// for the kv projection, of a second matrix whose rows are the gate
// columns (Wv beside Wk).
struct Stage1Src {
  const float* x;   // &x[m0 + r][c]
  const float* wv;  // &Wv[n0 + r][c]
  const float* wg;  // &Wg[n0 + r][c] (a split dual product's)
  int xr, nr, c;    // m0 + r, n0 + r, c
};

__device__ __forceinline__ Stage1Src stage1_src(const float* x,
                                                const float* wv,
                                                const float* wg, int K,
                                                int m0, int n0) {
  const int r = threadIdx.x / (BK / 4), c = threadIdx.x % (BK / 4) * 4;
  const long w = (long)(n0 + r) * K + c;
  return {x + (long)(m0 + r) * K + c, wv + w, wg + w, m0 + r, n0 + r, c};
}

// Start copying the stage tile at k0 into dst: rows [0, BM) of x, then the
// BN value rows and the BN gate rows (SPLIT: from s.wg; else the value
// matrix's rows N on); zeros for rows past M or N and columns past K (K a
// multiple of 4). BN need not be whole bands: the last pass copies only the
// rows below BN. ``zero_src`` is any mapped address (read by no copy).
template <int NT, int BM, int BN, bool SPLIT>
__device__ __forceinline__ void load_stage1(float* dst, const Stage1Src& s,
                                            const float* zero_src, int M,
                                            int K, int N, int k0) {
  constexpr int B = BAND<NT>;
  static_assert(BM % B == 0 && BN % 8 == 0, "whole bands of x rows");
  const int r = threadIdx.x / (BK / 4);  // the thread's row in a band
  const bool k_in = s.c + k0 < K;
  const long rows = (long)B * K;  // a band of rows in device memory
  float* d = dst + r * P + s.c;
#pragma unroll
  for (int p = 0; p < BM / B; ++p) {
    const bool ok = k_in && s.xr + B * p < M;
    cp16(d + B * p * P, ok ? s.x + p * rows + k0 : zero_src, ok);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int p = 0; p < (BN + B - 1) / B; ++p) {
      if (BN % B && p == BN / B && r >= BN % B) continue;  // past row BN
      const bool ok = k_in && s.nr + B * p < N;
      const float* w = SPLIT ? (half ? s.wg : s.wv) + p * rows + k0
                             : s.wv + half * (long)N * K + p * rows + k0;
      cp16(d + (BM + half * BN + B * p) * P, ok ? w : zero_src, ok);
    }
}

// A dual-product tile: TI rows and TV value columns (and the same TV gate
// columns) a thread, so 4 TI rows x 8 TV value columns a warp; WM x WN warps
// a block, BM x BN; STAGES ring stages; MIN_BLOCKS blocks an SM (the
// register budget); KU as fma_rows'; EFF the FFMA rate a full SM reaches on
// it over several rounds of blocks, in percent of DualWide's (chip_smoke.py
// ``dual_rates``: the out-projection at K = 640 on a grid of three or four
// whole rounds of each tile on every SM of an NVIDIA H100 80GB HBM3 at
// 700 W). The two-block tiles lose on long grids, where a three-block
// tile keeps two blocks running while a third starts: DualTall reaches 101
// % in one round and 102 % in four, but 96 % over the 91 rounds of the
// video's kv projection; DualBroad 99 % in four rounds, 97 % over the 18
// of the 272x736 kv projection. EFF is the long grids' rate, so that they
// keep DualWide where it is the faster.
template <int TI_, int WM_, int TV_, int WN_, int STAGES_, int MIN_BLOCKS_,
          int KU_, int EFF_>
struct DualTile {
  static constexpr int TI = TI_, WM = WM_, TV = TV_, WN = WN_,
                       STAGES = STAGES_, MIN_BLOCKS = MIN_BLOCKS_, KU = KU_,
                       EFF = EFF_;
  static constexpr int BM = 4 * TI * WM, BN = 8 * TV * WN, NT = 32 * WM * WN;
  static constexpr size_t SMEM = sizeof(float) * STAGES * (BM + 2 * BN) * P;
};
// 128 rows x 32 value columns, three 4-warp blocks an SM (170 registers
// each): the grids of many row blocks
using DualWide = DualTile<8, 4, 4, 1, 2, 3, 4, 100>;
// 112 rows x 64 value columns, two 4-warp blocks an SM: a grid of few row
// blocks that DualWide would spread over a second, nearly empty wave (the
// 12*28 rows of a request's level 3 are 3 x 112)
using DualTall = DualTile<7, 4, 8, 1, 2, 2, 4, 96>;
// 112 rows x 32 value columns, three an SM: DualWide's grid an eighth finer
// in rows, which fills the slots that DualWide's leaves empty (the
// out-projection at 12 x 350 rows: 380 blocks on 396 slots, not 330)
using DualShort = DualTile<7, 4, 4, 1, 2, 3, 4, 98>;
// 128 rows x 40 value columns, two an SM: 18 float4 loads for 320 FFMAs a
// k step (DualWide: 16 for 256), in grids of two-block waves (the
// out-projection at 12 x 350 rows: 33 x 8 blocks, one wave of 264)
using DualBroad = DualTile<8, 4, 5, 1, 2, 2, 4, 97>;

// The block's products h[i][j] = x[arow + 4 i] . Wv[bcol + 8 j] (j < TV)
// and x[arow + 4 i] . Wg[bcol + 8 (j - TV)] (j >= TV) over all K, through
// tile G's ring (``ring``: G::SMEM bytes; SPLIT as load_stage1's): a
// thread issues its copies for stage t + STAGES - 1 before it multiplies
// stage t, and one barrier a stage both publishes the stage and frees the
// slot it refills.
template <class G, bool SPLIT>
__device__ __forceinline__ void dual_product(float (&h)[G::TI][2 * G::TV],
                                             float* ring, const Stage1Src& src,
                                             const float* zero_src, int M,
                                             int K, int N, int arow,
                                             int bcol) {
  constexpr int BM = G::BM, BN = G::BN, STAGES = G::STAGES;
  constexpr int STAGE = (BM + 2 * BN) * P;
  const int KT = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT)
      load_stage1<G::NT, BM, BN, SPLIT>(ring + s * STAGE, src, zero_src, M,
                                        K, N, s * BK);
    cp_commit();
  }
  zero(h);
  for (int t = 0; t < KT; ++t) {
    cp_wait<STAGES - 2>();
    __syncthreads();  // stage t is in; every thread is done with t - 1
    const int u = t + STAGES - 1;
    if (u < KT)
      load_stage1<G::NT, BM, BN, SPLIT>(ring + (u % STAGES) * STAGE, src,
                                        zero_src, M, K, N, u * BK);
    cp_commit();
    const float* st = ring + (t % STAGES) * STAGE;
    fma_rows<G::TI, 2 * G::TV, G::TV, BN, P, P, BK, G::KU>(
        h, st + arow * P, st + (BM + bcol) * P);
  }
}

// The time the busiest SM takes for a grid of ``blocks`` blocks, holding
// ``per_sm`` at once, in blocks at the kernel's full rate: it runs
// ceil(blocks / sms) of them in rounds of per_sm; a round of two or more
// blocks runs at the full rate, a lone block at LONE_RATE percent of it
// (one 4-warp block leaves each scheduler a single warp, which hides
// neither the FFMA nor the shared loads' latency). Fitted to the fp32
// projections' and K5's times on every tile and geometry at the paths'
// grids on an H100 (PERF.md section 6), where counting whole waves
// instead took a slower tile at some of them.
constexpr int LONE_RATE = 70;

static double sm_rounds(long blocks, int sms, int per_sm) {
  const long n = (blocks + sms - 1) / sms, r = n % per_sm;
  return (double)(n - r) +
         (r >= 2 ? (double)r : r == 1 ? 100.0 / LONE_RATE : 0.0);
}

// The cost of tile G's grid over (M, N): sm_rounds of its blocks, each
// BM x BN outputs, at G's rate.
template <class G>
static double dual_cost(int M, int N, int sms) {
  const long blocks =
      (long)((M + G::BM - 1) / G::BM) * ((N + G::BN - 1) / G::BN);
  return sm_rounds(blocks, sms, G::MIN_BLOCKS) * G::BM * G::BN * 100.0 /
         G::EFF;
}

// The current card's SM count, 0 when it cannot be asked.
static int card_sms() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return sms;
}

// The tile a dual product over (M, N value columns) takes on the current
// card: 0 DualWide, 1 DualTall, 2 DualShort, 3 DualBroad, the cheapest by
// dual_cost (the lowest number at a tie); -1 when the card cannot be asked.
static int dual_tile(int M, int N) {
  const int sms = card_sms();
  if (sms <= 0) return -1;
  const double cost[] = {
      dual_cost<DualWide>(M, N, sms), dual_cost<DualTall>(M, N, sms),
      dual_cost<DualShort>(M, N, sms), dual_cost<DualBroad>(M, N, sms)};
  int best = 0;
  for (int i = 1; i < 4; ++i)
    if (cost[i] < cost[best]) best = i;
  return best;
}

// f(G{}) for the dual tile G numbered ``tile`` as dual_tile numbers them.
template <class F>
static cudaError_t on_dual_tile(int tile, F&& f) {
  switch (tile) {
    case 0:
      return f(DualWide{});
    case 1:
      return f(DualTall{});
    case 2:
      return f(DualShort{});
    case 3:
      return f(DualBroad{});
  }
  return cudaErrorInvalidValue;
}

// ---- the attention tiles: K1/K2's heads, K5, K6 -------------------------

// The head depth padded to the instance a kernel is compiled for (a
// multiple of 8: thread columns tx + 8 j), as a template switch; 40, the
// depth of the path's level 0, runs unpadded.
#define MDK_F32_DEPTHS(CASE)                                              \
  CASE(16) CASE(32) CASE(40) CASE(48) CASE(64) CASE(80) CASE(96) CASE(112) \
  CASE(128)

// The smallest instance of MDK_F32_DEPTHS that holds D, 0 past 128.
__host__ __device__ constexpr int depth_instance(int D) {
  return D <= 16    ? 16
         : D <= 32  ? 32
         : D <= 40  ? 40
         : D <= 48  ? 48
         : D <= 128 ? (D + 15) / 16 * 16
                    : 0;
}

// The geometry of an attention kernel at padded depth DP: 4 warps a block
// (one on each of the SM's schedulers), each owning 4 TI rows (thread
// (ty, tx): rows ty + 4 i of the warp's), so BR = 16 TI rows a block; KT
// rows (keys, or q rows in dk/dv) a streamed tile, TJ = KT / 8 of them a
// thread in the first product; TD = DP / 8 depth columns a thread in the
// second. Pitches: LR of [row][d] tiles (an odd count of 4-bank groups),
// LT of [d][row] tiles (the same), LP of the warps' [row][key] tiles (a
// multiple of 8 floats plus 8: the stores of a warp's 4 x 8 lanes fall in
// 32 distinct banks).
//
// Shallow heads (DP <= 48, the path's 40) take 32-row streamed tiles,
// deeper ones 16-row tiles, which keeps three blocks an SM at DP = 80.
template <int DP, int TI_>
struct AttnGeom {
  static_assert(DP % 8 == 0 && DP <= 128, "depth instance");
  static constexpr bool SHALLOW = DP <= 48;
  static constexpr int W = 4, TI = TI_, NT = 32 * W;
  static constexpr int BR = 4 * TI * W, KT = SHALLOW ? 32 : 16;
  static constexpr int TJ = KT / 8, TD = DP / 8;
  static constexpr int LR = DP + 4, LT = KT + 4, LP = KT + 8;
};

// Rows a thread of the attention core's kernels (K1/K2's heads, K5) and of
// K6's dq owns: 8 at the shallow depths (128 q rows a block); 6 deeper (96
// q rows a block: the path's L = 350 at DP = 80, 350 = 4 x 96 - 34, runs
// in one wave of 12 x 8 x 4 = 384 heads blocks on 132 x 3 slots, where
// 128-row blocks two an SM would take 288 blocks in two).
__host__ __device__ constexpr int attend_ti(int DP) {
  return DP <= 48 ? 8 : 6;
}

// Blocks an SM that the attention core's kernels are compiled for: three
// (168 registers a thread) at the path's depths; two past DP = 80, whose
// register blocks need more.
__host__ __device__ constexpr int attend_min_blocks(int DP) {
  return DP <= 80 ? 3 : 2;
}

// The attention core's geometry at depth DP with TI rows a thread: the
// heads' and dq's attend_ti; K5 also takes fewer (f32_flash.cu FwdGeom).
template <int DP, int TI = attend_ti(DP)>
using AttendGeom = AttnGeom<DP, TI>;

// The k steps the attention core's products unroll together (fma_rows'
// KU): two where a thread's register blocks (o and s) hold at most 72
// floats, which leaves room under 168 registers to load ahead; else one.
template <int DP, int TI = attend_ti(DP)>
__host__ __device__ constexpr int attend_ku() {
  using G = AttendGeom<DP, TI>;
  return G::TI * (G::TD + G::TJ) <= 72 ? 2 : 1;
}

// The blocks of ``bytes`` of dynamic shared memory an SM holds: 228 KB, of
// which each block takes 1 KB more for the system.
__host__ __device__ constexpr int smem_blocks(size_t bytes) {
  return (int)(233472 / (bytes + 1024));
}

// Start copying rows [r0, r0 + ROWS) of src (n_rows x D, row-major, D a
// multiple of 4) into a [row][d] tile of pitch LR: zeros outside the tensor
// and in the pad columns [D, DP).
template <int NT, int ROWS, int DP, int LR>
__device__ __forceinline__ void cp_rows(float* dst, const float* src, int r0,
                                        int n_rows, int D) {
  constexpr int V4 = DP / 4;
  for (int i = threadIdx.x; i < ROWS * V4; i += NT) {
    const int r = i / V4, d = (i - r * V4) * 4;
    const bool ok = r0 + r < n_rows && d < D;
    cp16(dst + r * LR + d, ok ? src + (long)(r0 + r) * D + d : src, ok);
  }
}

// dst[d * LT + r] = src[r * LR + d] for the ROWS x DP tile src: lanes walk
// the rows, so the reads of 8 lanes fall in distinct bank groups and the
// stores of a warp on consecutive words.
template <int NT, int ROWS, int DP, int LR, int LT>
__device__ __forceinline__ void transpose(float* dst, const float* src) {
  for (int i = threadIdx.x; i < ROWS * (DP / 4); i += NT) {
    const int r = i % ROWS, d = (i / ROWS) * 4;
    const float4 x = *reinterpret_cast<const float4*>(src + r * LR + d);
    dst[(d + 0) * LT + r] = x.x;
    dst[(d + 1) * LT + r] = x.y;
    dst[(d + 2) * LT + r] = x.z;
    dst[(d + 3) * LT + r] = x.w;
  }
}

// A thread's TI x TJ values into its warp's [row][key] tile (the A operand
// of the next product): dst[(ty + 4 i) * LP + tx + 8 j].
template <int TI, int TJ, int LP>
__device__ __forceinline__ void put_rows(float* dst,
                                         const float (&v)[TI][TJ]) {
  float* d = dst + lane_ty() * LP + lane_tx();
#pragma unroll
  for (int i = 0; i < TI; ++i)
#pragma unroll
    for (int j = 0; j < TJ; ++j) d[4 * i * LP + 8 * j] = v[i][j];
}

// Max and sum over the 8 threads of a row (lanes tx of one ty).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 1; o < 8; o <<= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Shared memory of the attention core (floats): the q tile [BR][LR], then a
// region that the ring of k/v stages (two of [KT][LR] k rows then [KT][LR]
// v rows), v^T [DP][LT] and the warps' p tiles [W][4 TI][LP] share; K1's q
// projection runs its own ring of QK-deep chunks of x and Wq rows
// ([BR + DP][QK + 4], two stages) in that region before the keys.
template <int DP, int TI = attend_ti(DP)>
struct AttendSmem {
  using G = AttendGeom<DP, TI>;
  static constexpr int Q = 0, RING = Q + G::BR * G::LR,
                       STAGE = 2 * G::KT * G::LR, VT = RING + 2 * STAGE,
                       PB = VT + DP * G::LT,
                       FLOATS = PB + G::W * 4 * G::TI * G::LP;
  static constexpr int QK = 2 * (G::BR + DP) * (32 + 4) <= FLOATS - RING
                                ? 32
                                : 16;
  static constexpr size_t BYTES = sizeof(float) * FLOATS;
  static_assert(2 * (G::BR + DP) * (QK + 4) <= FLOATS - RING,
                "the q projection's ring fits in the region");
};

// Start copying the k and v rows [t0, t0 + KT) of (Lk, D) into a stage.
template <int DP>
__device__ __forceinline__ void cp_kv_stage(float* dst, const float* k,
                                            const float* v, int t0, int Lk,
                                            int D) {
  using G = AttendGeom<DP>;
  cp_rows<G::NT, G::KT, DP, G::LR>(dst, k, t0, Lk, D);
  cp_rows<G::NT, G::KT, DP, G::LR>(dst + G::KT * G::LR, v, t0, Lk, D);
}

// One source's attention for the block's BR q rows, the q tile already in
// smem[Q] (scaled, pad columns zero) and the region free: for every KT-key
// tile below kv_len of the (Lk, D) rows k and v, s = q k^T, the online
// softmax with its statistics in m (each thread holds its rows' copies)
// and l (each thread its part of the row sum), p through the warp's tile
// and o += p v over v^T; keys at positions >= kv_len take no part. o is
// the unnormalised sum, l the row sums (summed over the row's threads).
// KU: the products' k steps unrolled together (fma_rows), 1 where the
// register blocks leave no room to load ahead; TI: the rows a thread owns
// (AttendGeom<DP, TI>, the layout of AttendSmem<DP, TI>).
template <int DP, int KU, int TI = attend_ti(DP)>
__device__ __forceinline__ void attend(float* smem,
                                       const float* __restrict__ k,
                                       const float* __restrict__ v, int Lk,
                                       int kv_len, int D, float (&m)[TI],
                                       float (&l)[TI],
                                       float (&o)[TI][DP / 8]) {
  using G = AttendGeom<DP, TI>;
  using S = AttendSmem<DP, TI>;
  constexpr int KT = G::KT, TJ = G::TJ;
  const int ty = lane_ty(), tx = lane_tx();
  const float* qa = smem + S::Q + (warp() * 4 * TI + ty) * G::LR;
  float* vt = smem + S::VT;
  float* pb = smem + S::PB + warp() * 4 * TI * G::LP;
#pragma unroll
  for (int i = 0; i < TI; ++i) m[i] = -INFINITY, l[i] = 0.0f;
  zero(o);
  const int T = (kv_len + KT - 1) / KT;
  cp_kv_stage<DP>(smem + S::RING, k, v, 0, Lk, D);
  cp_commit();
  for (int t = 0; t < T; ++t) {
    cp_wait<0>();
    __syncthreads();  // stage t is in; every thread is done with t - 1
    if (t + 1 < T)
      cp_kv_stage<DP>(smem + S::RING + ((t + 1) & 1) * S::STAGE, k, v,
                      (t + 1) * KT, Lk, D);
    cp_commit();
    const float* ks = smem + S::RING + (t & 1) * S::STAGE;
    transpose<G::NT, KT, DP, G::LR, G::LT>(vt, ks + KT * G::LR);
    float s[TI][TJ];
    zero(s);
    fma_rows<TI, TJ, TJ, 0, G::LR, G::LR, DP, KU>(s, qa, ks + tx * G::LR);
    const int t0 = t * KT;
#pragma unroll
    for (int j = 0; j < TJ; ++j)
      if (t0 + tx + 8 * j >= kv_len)
#pragma unroll
        for (int i = 0; i < TI; ++i) s[i][j] = -INFINITY;
#pragma unroll
    for (int i = 0; i < TI; ++i) {
      float mx = s[i][0];
#pragma unroll
      for (int j = 1; j < TJ; ++j) mx = fmaxf(mx, s[i][j]);
      const float m_new = fmaxf(m[i], row_max(mx));  // key t0 is valid
      const float mb = m_new * LOG2E;
      const float alpha = exp2f(fmaf(m[i], LOG2E, -mb));
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < TJ; ++j) {
        s[i][j] = exp2f(fmaf(s[i][j], LOG2E, -mb));
        sum += s[i][j];
      }
      l[i] = fmaf(l[i], alpha, sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) o[i][j] *= alpha;
    }
    put_rows<TI, TJ, G::LP>(pb, s);
    __syncthreads();  // v^T is in (and the warp's p)
    fma_rows<TI, DP / 8, DP / 8, 0, G::LP, G::LT, KT, KU>(
        o, pb + ty * G::LP, vt + tx * G::LT);
  }
#pragma unroll
  for (int i = 0; i < TI; ++i) l[i] = row_sum(l[i]);
}

}  // namespace f32
}  // namespace mdk
