// The fp32 instances of K4 (stage 1 of the GEGLU FeedForward) and K3 (the
// whole FeedForward but its stage-2 bias) for Hopper (sm_90a).
//
// Replace the fp32 instances of magicdrive_tpu/kernels/geglu.py fused_geglu
// and fused_ff, which an fp32 run of the JAX package reaches with the
// element size 4 (core/transformer.py FeedForward, ff_full_fusion_fits);
// at fp32 every bf16 cast point of their contract is the identity:
//   K4: g = (x Wv^T + bv) * gelu_erf(x Wg^T + bg), Wv/Wg the value and gate
//       halves of W1 (2N, K);
//   K3: y = g W2^T, W2 (C, N), g never in device memory.
//
// Bound: the CUDA cores' fp32 rate. The tensor cores take fp32 only as TF32,
// which fails the fp32 gate (f32_tile.cuh), so every product is FFMA, at
// most 67 TFLOP/s on an H100 SXM (132 SMs x 4 schedulers x one 32-lane FFMA
// a clock at 1.98 GHz). At the 224x400 level 0 (M = 12*1400, K = 320,
// N = 1280, C = 320) K3 needs 41.3 GFLOP, 0.62 ms at that rate, against
// 31 MB of inputs and output, 0.009 ms at 3.35 TB/s; K4 at M = 12*350,
// K = 640 is 27.5 GFLOP (0.41 ms) against 28 MB. So the bytes are far below
// the operations, and what decides the time is how close the SMs' issue
// comes to one FFMA a clock per scheduler, and how evenly the grid fills
// the SMs.
//
// Design (what keeps the FFMA pipes fed):
//  * every operand is k-contiguous in device memory (x (M, K), W1 (2N, K),
//    W2 (C, N), and K3's on-chip g as rows), so it is staged as it lies: a
//    [row][k] tile of BK = 32 columns at a pitch of 36 floats, filled by
//    16-byte cp.async copies (zeros outside the tensor) into a ring of
//    stages. A thread issues its copies for stage t + STAGES - 1 before it
//    multiplies stage t, and one barrier a stage both publishes the stage
//    and frees the slot it refills: no register staging and no transposed
//    scatter;
//  * lane (ty, tx) = (lane / 8, lane % 8) of a warp owns rows ty + 4 i and
//    columns tx + 8 j. A k step of 4 reads each of its rows and columns as
//    one float4 along k: 8 rows x 8 columns take 16 shared loads for 256
//    FFMAs. The pitch of 36 floats (9 four-bank groups) puts the 4 rows a
//    load reads across a warp, and the 8 columns, in distinct bank groups;
//  * K4 (geglu_f32_kernel<G>): a thread's columns are TV of the value half
//    and the same TV of the gate half, so the exact GELU (erff) and the
//    product run in its registers. Small blocks several to an SM hide one
//    another's barriers: GegluWide is 4 warps on 128 rows x 32 columns,
//    three blocks an SM (two ring stages each); GegluTall 4 warps on 112
//    rows x 64 columns, two an SM, for the grids whose last wave of
//    GegluWide blocks would leave most SMs idle (geglu_tile chooses by the
//    waves each grid takes on the card's SMs);
//  * K3 (ff_f32_kernel<NC>): a block of 8 warps owns 64 rows and 64*NC
//    columns of y (8 x 2*NC a thread, in registers for the whole walk). It
//    walks N in chunks of 128: the chunk's g (64 x 128) is computed as in
//    K4 over the ring, gated into shared memory as rows, and multiplied by
//    the chunk's W2 columns, which arrive in the same ring as four 32-deep
//    stages after the chunk's stage-1 stages. The ring never drains between
//    the stages of the walk. As the bf16 K3, wider outputs split over
//    blocks along y (at most 5 tiles of 64 a block), each walking the whole
//    N;
//  * every output sums its k in increasing order in one thread: no atomics,
//    no split of k, two calls bitwise equal.
#include "common.cuh"
#include "flash_tile.cuh"

namespace mdk {
namespace f32g {

using tile::cp16;
using tile::cp_commit;
using tile::cp_wait;

constexpr int BK = 32;        // k depth of a ring stage
constexpr int P = BK + 4;     // pitch of a [row][k] stage tile (floats)

// K3: rows a block (2 warps of 32 rows), N chunk (value columns of g a
// chunk), warps along the columns, ring stages, stage-1 k unroll, output
// tiles of 64 columns a block at most
constexpr int FF_BM = 64, FF_NB = 128, FF_WN = 4, FF_STAGES = 4, FF_KU = 2;
constexpr int FF_MAX_NC = 5;

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

// A thread's copies into a stage tile: 16 bytes at column c of rows
// r + BAND p (r = threadIdx / 8, c = threadIdx % 8 * 4), the pass p over
// the tile's bands of BAND = NT / 8 rows (NT threads a block).
template <int NT>
constexpr int BAND = NT / (BK / 4);

// A thread's sources of the stage-1 tiles at m0 (x) and n0 (W1): its row
// and column of x and of W1's value half (the gate half is N rows on).
struct Stage1Src {
  const float* x;   // &x[m0 + r][c]
  const float* wv;  // &W1[n0 + r][c]
  int xr, nr, c;    // m0 + r, n0 + r, c
};

__device__ __forceinline__ Stage1Src stage1_src(const float* x,
                                                const float* w1, int K,
                                                int m0, int n0) {
  const int r = threadIdx.x / (BK / 4), c = threadIdx.x % (BK / 4) * 4;
  return {x + (long)(m0 + r) * K + c, w1 + (long)(n0 + r) * K + c, m0 + r,
          n0 + r, c};
}

// Start copying the stage-1 tile at k0 into dst: rows [0, BM) of x, then
// the BN value rows and the BN gate rows of W1; zeros for rows past M or N
// and columns past K (K a multiple of 4). ``zero_src`` is any mapped
// address (read by no copy).
template <int NT, int BM, int BN>
__device__ __forceinline__ void load_stage1(float* dst, const Stage1Src& s,
                                            const float* zero_src, int M,
                                            int K, int N, int k0) {
  constexpr int B = BAND<NT>;
  static_assert(BM % B == 0 && BN % B == 0, "whole bands");
  const bool k_in = s.c + k0 < K;
  const long rows = (long)B * K;  // a band of rows in device memory
  float* d = dst + (threadIdx.x / (BK / 4)) * P + s.c;
#pragma unroll
  for (int p = 0; p < BM / B; ++p) {
    const bool ok = k_in && s.xr + B * p < M;
    cp16(d + B * p * P, ok ? s.x + p * rows + k0 : zero_src, ok);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int p = 0; p < BN / B; ++p) {
      const bool ok = k_in && s.nr + B * p < N;
      cp16(d + (BM + half * BN + B * p) * P,
           ok ? s.wv + half * (long)N * K + p * rows + k0 : zero_src, ok);
    }
}

// g = (hv + bv) * gelu_erf(hg + bg) at value column n < N, hv and hg the
// value and gate products there.
__device__ __forceinline__ float geglu_at(float hv, float hg,
                                          const float* b1, int N, int n) {
  const float bv = b1 != nullptr ? __ldg(b1 + n) : 0.0f;
  const float bg = b1 != nullptr ? __ldg(b1 + N + n) : 0.0f;
  return (hv + bv) * gelu_erf(hg + bg);
}

// A K4 tile: TI rows and TV value columns (and the same TV gate columns)
// a thread, so 4 TI rows x 8 TV value columns a warp; WM x WN warps a
// block, BM x BN; STAGES ring stages; MIN_BLOCKS blocks an SM (the register
// budget); KU as fma_rows'; EFF the FFMA rate it reaches, in percent of
// GegluWide's (timed on an NVIDIA H100 80GB HBM3 at 700 W at M = 12*350,
// K = 640, N = 2560, where geglu_cost counts the same work for both).
template <int TI_, int WM_, int TV_, int WN_, int STAGES_, int MIN_BLOCKS_,
          int KU_, int EFF_>
struct GegluTile {
  static constexpr int TI = TI_, WM = WM_, TV = TV_, WN = WN_,
                       STAGES = STAGES_, MIN_BLOCKS = MIN_BLOCKS_, KU = KU_,
                       EFF = EFF_;
  static constexpr int BM = 4 * TI * WM, BN = 8 * TV * WN, NT = 32 * WM * WN;
  static constexpr size_t SMEM = sizeof(float) * STAGES * (BM + 2 * BN) * P;
};
// 128 rows x 32 value columns, three 4-warp blocks an SM (170 registers
// each): the grids of many row blocks
using GegluWide = GegluTile<8, 4, 4, 1, 2, 3, 4, 100>;
// 112 rows x 64 value columns, two 4-warp blocks an SM: a grid of few row
// blocks that GegluWide would spread over a second, nearly empty wave (the
// 12*28 rows of a request's level 3 are 3 x 112)
using GegluTall = GegluTile<7, 4, 8, 1, 2, 2, 4, 95>;

// grid (column blocks of G::BN, row blocks of G::BM); out[m][n] = g.
template <class G>
__global__ void __launch_bounds__(G::NT, G::MIN_BLOCKS)
geglu_f32_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                 const float* __restrict__ b1, float* __restrict__ out,
                 int M, int K, int N) {
  extern __shared__ __align__(16) float ring[];
  constexpr int TI = G::TI, TV = G::TV, BM = G::BM, BN = G::BN;
  constexpr int STAGES = G::STAGES, STAGE = (BM + 2 * BN) * P;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int wy = warp() / G::WN, wx = warp() % G::WN;
  const int arow = wy * 4 * TI + lane_ty();
  const int bcol = wx * 8 * TV + lane_tx();  // value column in the block
  const int KT = (K + BK - 1) / BK;
  const Stage1Src src = stage1_src(x, w1, K, m0, n0);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT)
      load_stage1<G::NT, BM, BN>(ring + s * STAGE, src, x, M, K, N, s * BK);
    cp_commit();
  }
  float h[TI][2 * TV];  // value columns, then the same columns' gate
  zero(h);
  for (int t = 0; t < KT; ++t) {
    cp_wait<STAGES - 2>();
    __syncthreads();  // stage t is in; every thread is done with t - 1
    const int u = t + STAGES - 1;
    if (u < KT)
      load_stage1<G::NT, BM, BN>(ring + (u % STAGES) * STAGE, src, x, M, K,
                                 N, u * BK);
    cp_commit();
    const float* st = ring + (t % STAGES) * STAGE;
    fma_rows<TI, 2 * TV, TV, BN, P, P, BK, G::KU>(h, st + arow * P,
                                                  st + (BM + bcol) * P);
  }
#pragma unroll
  for (int j = 0; j < TV; ++j) {
    const int n = n0 + bcol + 8 * j;
    if (n >= N) continue;
#pragma unroll
    for (int i = 0; i < TI; ++i) {
      const int m = m0 + arow + 4 * i;
      if (m < M)
        out[(long)m * N + n] = geglu_at(h[i][j], h[i][j + TV], b1, N, n);
    }
  }
}

// The work of tile G's grid over (M, N) as the card runs it: whole waves of
// the blocks its SMs hold at once, each wave MIN_BLOCKS x BM x BN outputs an
// SM, at G's rate.
template <class G>
static double geglu_cost(int M, int N, int sms) {
  const long blocks =
      (long)((M + G::BM - 1) / G::BM) * ((N + G::BN - 1) / G::BN);
  const long slots = (long)sms * G::MIN_BLOCKS;
  const long waves = (blocks + slots - 1) / slots;
  return (double)waves * G::MIN_BLOCKS * G::BM * G::BN * 100.0 / G::EFF;
}

// The tile K4 takes for (M, N) on the current card: 0 GegluWide, 1
// GegluTall (the cheaper by geglu_cost; GegluWide at a tie), -1 when the
// card cannot be asked.
static int geglu_tile(int M, int N) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return -1;
  return geglu_cost<GegluTall>(M, N, sms) < geglu_cost<GegluWide>(M, N, sms)
             ? 1
             : 0;
}

template <class G>
static cudaError_t launch_geglu(const float* x, const float* w1,
                                const float* b1, float* out, int M, int K,
                                int N, cudaStream_t stream) {
  static unsigned opted_in = 0;
  const cudaError_t e =
      allow_smem_once(geglu_f32_kernel<G>, G::SMEM, opted_in);
  if (e != cudaSuccess) return e;
  if ((M + G::BM - 1) / G::BM > 65535) return cudaErrorInvalidValue;
  const dim3 grid((N + G::BN - 1) / G::BN, (M + G::BM - 1) / G::BM);
  geglu_f32_kernel<G><<<grid, G::NT, G::SMEM, stream>>>(x, w1, b1, out, M, K,
                                                        N);
  return cudaGetLastError();
}

// The layout of ff_f32_kernel<NC> (floats): the ring, each stage the
// larger of a stage-1 tile (FF_BM rows of x, FF_NB value and FF_NB gate
// rows of W1) and a 32-deep tile of the block's CT rows of W2, then the
// chunk's g as [FF_BM][GP] rows.
template <int NC>
struct FFSmem {
  static constexpr int CT = 64 * NC;  // output columns a block
  static constexpr int S1_ROWS = FF_BM + 2 * FF_NB;
  static constexpr int ROWS = CT > S1_ROWS ? CT : S1_ROWS;
  static constexpr int GP = FF_NB + 4;      // pitch of g's rows
  static constexpr int PER_N = FF_NB / BK;  // W2 stages a chunk
  static constexpr int NT = 64 * FF_WN;     // threads a block
  static constexpr int STAGE = ROWS * P, G = FF_STAGES * STAGE,
                       FLOATS = G + FF_BM * GP;
  static constexpr size_t BYTES = sizeof(float) * FLOATS;
};

// Start copying stage u of K3's walk into its ring slot: per N chunk of
// FF_NB, KT stage-1 tiles (k0 = 32 kind), then the chunk's W2 columns as
// FF_NB / 32 tiles of the block's CT rows (zeros past C or N).
template <int NC>
__device__ __forceinline__ void ff_load(float* ring, int u, int KT,
                                        const float* x, const float* w1,
                                        const float* w2, int M, int K, int N,
                                        int C, int m0, int c0) {
  using S = FFSmem<NC>;
  const int chunk = u / (KT + S::PER_N), kind = u - chunk * (KT + S::PER_N);
  const int n0 = chunk * FF_NB;
  float* dst = ring + (u % FF_STAGES) * S::STAGE;
  if (kind < KT) {
    load_stage1<S::NT, FF_BM, FF_NB>(dst, stage1_src(x, w1, K, m0, n0), x,
                                     M, K, N, kind * BK);
    return;
  }
  constexpr int B = BAND<S::NT>;
  static_assert(S::CT % B == 0, "whole bands");
  const int r = threadIdx.x / (BK / 4), c = threadIdx.x % (BK / 4) * 4;
  const int nk = n0 + (kind - KT) * BK + c;  // the copy's column of W2
  const float* src = w2 + (long)(c0 + r) * N + nk;
#pragma unroll
  for (int p = 0; p < S::CT / B; ++p) {
    const bool ok = c0 + r + B * p < C && nk < N;
    cp16(dst + (r + B * p) * P + c, ok ? src + (long)B * p * N : w2, ok);
  }
}

// grid (row blocks of FF_BM, column blocks of 64*NC): y[m0.., c0..] = sum
// over N chunks of FF_NB of g_chunk W2[c0.., chunk]^T. Warps 2 (rows) x
// FF_WN (columns): 32 rows x FF_NB / FF_WN value columns of a chunk in
// stage 1 (FF_KU as fma_rows'), 32 rows x 64 NC / FF_WN output columns in
// stage 2.
template <int NC>
__global__ void __launch_bounds__(FFSmem<NC>::NT, 1)
ff_f32_kernel(const float* __restrict__ x, const float* __restrict__ w1,
              const float* __restrict__ b1, const float* __restrict__ w2,
              float* __restrict__ out, int M, int K, int N, int C) {
  extern __shared__ __align__(16) float smem[];
  using S = FFSmem<NC>;
  constexpr int NB = FF_NB, WN = FF_WN, TI = 8;  // rows a thread: ty + 4 i
  constexpr int TV = NB / (8 * WN);  // value columns of a chunk a thread
  constexpr int TJ = 8 * NC / WN;    // output columns a thread
  static_assert(NB % (8 * WN) == 0 && 8 * NC % WN == 0, "whole columns");
  float* g = smem + S::G;
  const int m0 = blockIdx.x * FF_BM, c0 = blockIdx.y * S::CT;
  const int wy = warp() / WN, wx = warp() % WN;
  const int arow = wy * 32 + lane_ty();
  const int gcol = wx * (NB / WN) + lane_tx();      // value column, chunk
  const int ycol = wx * (64 * NC / WN) + lane_tx();  // output column, block
  const int KT = (K + BK - 1) / BK;
  const int T = (N + NB - 1) / NB * (KT + S::PER_N);  // stages of the walk
#pragma unroll
  for (int s = 0; s < FF_STAGES - 1; ++s) {
    if (s < T) ff_load<NC>(smem, s, KT, x, w1, w2, M, K, N, C, m0, c0);
    cp_commit();
  }
  // wait for stage t, publish it, and refill the slot stage t - 1 used
  auto advance = [&](int t) -> const float* {
    cp_wait<FF_STAGES - 2>();
    __syncthreads();
    const int u = t + FF_STAGES - 1;
    if (u < T) ff_load<NC>(smem, u, KT, x, w1, w2, M, K, N, C, m0, c0);
    cp_commit();
    return smem + (t % FF_STAGES) * S::STAGE;
  };
  float y[TI][TJ];
  zero(y);
  int t = 0;
  for (int n0 = 0; n0 < N; n0 += NB) {
    float h[TI][2 * TV];  // value columns, then the same columns' gate
    zero(h);
    for (int kt = 0; kt < KT; ++kt, ++t) {
      const float* st = advance(t);
      fma_rows<TI, 2 * TV, TV, NB, P, P, BK, FF_KU>(h, st + arow * P,
                                             st + (FF_BM + gcol) * P);
    }
    // g's rows for stage 2: the previous chunk's stage 2 read them before
    // the barriers of this chunk's stage 1
#pragma unroll
    for (int j = 0; j < TV; ++j) {
      const int n = n0 + gcol + 8 * j;
#pragma unroll
      for (int i = 0; i < TI; ++i)
        g[(arow + 4 * i) * S::GP + gcol + 8 * j] =
            n < N ? geglu_at(h[i][j], h[i][j + TV], b1, N, n) : 0.0f;
    }
    for (int s = 0; s < S::PER_N; ++s, ++t) {
      const float* st = advance(t);  // its barrier also publishes g
      fma_rows<TI, TJ, TJ, 0, S::GP, P, BK, BK / 4>(
          y, g + arow * S::GP + s * BK, st + ycol * P);
    }
  }
#pragma unroll
  for (int i = 0; i < TI; ++i) {
    const int m = m0 + arow + 4 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TJ; ++j) {
      const int c = c0 + ycol + 8 * j;
      if (c < C) out[(long)m * C + c] = y[i][j];
    }
  }
}

template <int NC>
static cudaError_t launch_ff(const float* x, const float* w1, const float* b1,
                             const float* w2, float* out, int M, int K, int N,
                             int C, int n_ct, cudaStream_t stream) {
  using S = FFSmem<NC>;
  static unsigned opted_in = 0;
  const cudaError_t e = allow_smem_once(ff_f32_kernel<NC>, S::BYTES, opted_in);
  if (e != cudaSuccess) return e;
  const dim3 grid((M + FF_BM - 1) / FF_BM, n_ct);
  ff_f32_kernel<NC><<<grid, S::NT, S::BYTES, stream>>>(x, w1, b1, w2, out, M,
                                                       K, N, C);
  return cudaGetLastError();
}

}  // namespace f32g
}  // namespace mdk

extern "C" {

// x: (M, K); w1: (2N, K); b1: (2N,) or null; out: (M, N), all fp32, 16-byte
// aligned; K and N multiples of 8. The tile is geglu_tile's for (M, N).
int mdk_geglu_f32(const void* x, const void* w1, const void* b1, void* out,
                  int M, int K, int N, void* stream) {
  using namespace mdk::f32g;
  if (M <= 0 || K <= 0 || K % 8 || N <= 0 || N % 8 ||
      !mdk::aligned16({x, w1, b1, out}))
    return (int)cudaErrorInvalidValue;
  const auto X = static_cast<const float*>(x);
  const auto W1 = static_cast<const float*>(w1);
  const auto B1 = static_cast<const float*>(b1);
  const auto O = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (geglu_tile(M, N)) {
    case 0:
      return (int)launch_geglu<GegluWide>(X, W1, B1, O, M, K, N, s);
    case 1:
      return (int)launch_geglu<GegluTall>(X, W1, B1, O, M, K, N, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The tile mdk_geglu_f32 takes for (M, N) on the current card: 0 the
// 128 x 32 tile, 1 the 112 x 64 one; -1 when M or N is not positive or the
// card cannot be asked.
int mdk_geglu_f32_tile(int M, int N) {
  return M > 0 && N > 0 ? mdk::f32g::geglu_tile(M, N) : -1;
}

#define MDK_FF_F32_CASE(NC)                                                \
  case NC:                                                                 \
    return (int)launch_ff<NC>(                                             \
        static_cast<const float*>(x), static_cast<const float*>(w1),       \
        static_cast<const float*>(b1), static_cast<const float*>(w2),      \
        static_cast<float*>(out), M, K, N, C, n_ct,                        \
        static_cast<cudaStream_t>(stream));

// x: (M, K); w1: (2N, K); b1: (2N,) or null; w2: (C, N); out: (M, C), all
// fp32, 16-byte aligned; K, N and C multiples of 8.
int mdk_ff_f32(const void* x, const void* w1, const void* b1, const void* w2,
               void* out, int M, int K, int N, int C, void* stream) {
  using namespace mdk::f32g;
  if (M <= 0 || K <= 0 || K % 8 || N <= 0 || N % 8 || C <= 0 || C % 8 ||
      !mdk::aligned16({x, w1, b1, w2, out}))
    return (int)cudaErrorInvalidValue;
  // output tiles of 64 columns, at most FF_MAX_NC a block, spread evenly
  // over the fewest blocks along y (as mdk_ff)
  const int tiles = (C + 63) / 64;
  const int n_ct = (tiles + FF_MAX_NC - 1) / FF_MAX_NC;
  const int nc = (tiles + n_ct - 1) / n_ct;
  if (n_ct > 65535) return (int)cudaErrorInvalidValue;
  switch (nc) {
    MDK_FF_F32_CASE(1)
    MDK_FF_F32_CASE(2)
    MDK_FF_F32_CASE(3)
    MDK_FF_F32_CASE(4)
    MDK_FF_F32_CASE(5)
  }
  return (int)cudaErrorInvalidValue;
}

#undef MDK_FF_F32_CASE

}  // extern "C"
