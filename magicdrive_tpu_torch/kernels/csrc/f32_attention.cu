// The fp32 instances of K1, K2, K7, K8 and the K8 pair for Hopper (sm_90a).
//
// Replace the fp32 instances of the Pallas kernels of
// magicdrive_tpu/kernels/fused_attention.py: fused_kvstat_attention (K1; K7,
// fused_qkv_attention, computes its function), fused_kvstat_attention_pair
// (K2) and fused_qkv_out_attention with its pair (K8). An fp32 run of the
// JAX package sends its attentions there with the element size 4
// (core/attention.py, core/transformer.py); at fp32 every bf16 cast point
// of their contract is the identity: k, v = x_kv W per head; q = (x_q Wq)
// scale; o = softmax(q k^T) v with fp32 statistics, divided by the row sum;
// the pair sums its two neighbours' normalised outputs; K8 out-projects o by
// Wout without the bias. The wrappers launch these entries for fp32 tensors
// as they launch the bf16 ones (kvstat_attention.cu,
// kvstat_pair_attention.cu, fused_out_attention.cu) for bf16:
//  1. kv_project_f32_kernel<G>: k and v of every head into (B, H, Lk, D),
//     the kv-stationary workspace: f32_tile.cuh's dual product (K4's ring
//     and tiles), Wk's rows as the value columns and Wv's as the gate;
//  2. heads_f32_kernel<DP, NSRC>: per (q tile of AttendGeom<DP>::BR rows,
//     head, batch), q projected into shared memory, then f32::attend over
//     each of NSRC sources (the pair's neighbour i of view v is view
//     table[i][v] of the same sample), the pair's normalised outputs summed
//     in fp32;
//  3. out_project_f32_kernel<G>: o Wout^T for K8 and its pair, the dual
//     product over the two halves of Wout's rows.
//
// Bound. At the 28x50 level (12 views, L=1400, C=320, 8 heads of 40) K1
// needs 40.4 GFLOP against 43 MB of fp32 inputs and output: 0.60 ms at the
// 67 TFLOP/s fp32 rate against 0.013 ms of bytes, so operations bind. At
// L=350, C=640 (8 heads of 80) the kv projection is half of K1's work.
//
// Design: f32_tile.cuh's FFMA tiles ([row][k] operands read as float4, a
// cp.async ring, 8 x 8 register blocks). The projections run K4's dual
// product and take the tile of the four (DualWide, DualTall, DualShort,
// DualBroad) whose grid costs the least on the busiest SM at its measured
// rate (dual_tile, reported by mdk_project_f32_tile): a tile is a blocking
// only, and every output sums its k in order in one thread on each.
// The heads kernel projects its q tile over QK-deep chunks of C through
// its own ring, then attends: the logits, p and the statistics never reach
// device memory, p goes once through its warp's shared tile as the A
// operand of p v, and the q tile stays in shared memory for every key tile
// of both sources.
#include "f32_tile.cuh"

namespace mdk {
namespace f32 {

// The rows of the dual-product tile G at (m0, n0) of the grid: the thread's
// first row and value column in the block.
template <class G>
__device__ __forceinline__ int dual_row() {
  return warp() / G::WN * 4 * G::TI + lane_ty();
}
template <class G>
__device__ __forceinline__ int dual_col() {
  return warp() % G::WN * 8 * G::TV + lane_tx();
}

// k_z[b, h, l, d] = sum_c x[b*Lk + l, c] W_z[h*D + d, c] for z = k (the
// value columns of the dual product) and v (its gate columns): a GEMM with
// M = B*Lk, N = H*D, K = Ck; grid (column blocks of G::BN, row blocks of
// G::BM).
template <class G>
__global__ void __launch_bounds__(G::NT, G::MIN_BLOCKS)
kv_project_f32_kernel(const float* __restrict__ x,
                      const float* __restrict__ wk,
                      const float* __restrict__ wv, float* __restrict__ kout,
                      float* __restrict__ vout, int M, int Lk, int Ck, int H,
                      int D) {
  extern __shared__ __align__(16) float ring[];
  const int N = H * D, n0 = blockIdx.x * G::BN, m0 = blockIdx.y * G::BM;
  const int arow = dual_row<G>(), bcol = dual_col<G>();
  float h[G::TI][2 * G::TV];
  dual_product<G, true>(h, ring, stage1_src(x, wk, wv, Ck, m0, n0), x, M,
                        Ck, N, arow, bcol);
#pragma unroll
  for (int j = 0; j < G::TV; ++j) {
    const int n = n0 + bcol + 8 * j;
    if (n >= N) continue;
    const int hh = n / D, d = n - hh * D;
#pragma unroll
    for (int i = 0; i < G::TI; ++i) {
      const int m = m0 + arow + 4 * i;
      if (m >= M) continue;
      const int bb = m / Lk, l = m - bb * Lk;
      const long at = (((long)bb * H + hh) * Lk + l) * D + d;
      kout[at] = h[i][j];
      vout[at] = h[i][j + G::TV];
    }
  }
}

// out (M, N) = o (M, K) Wout (N, K)^T: K8's out-projection, no bias; the
// dual product's value columns are out's first N/2 columns (Wout's first
// N/2 rows), its gate columns the last N/2.
template <class G>
__global__ void __launch_bounds__(G::NT, G::MIN_BLOCKS)
out_project_f32_kernel(const float* __restrict__ o,
                       const float* __restrict__ wout,
                       float* __restrict__ out, int M, int K, int N) {
  extern __shared__ __align__(16) float ring[];
  const int N2 = N / 2, n0 = blockIdx.x * G::BN, m0 = blockIdx.y * G::BM;
  const int arow = dual_row<G>(), bcol = dual_col<G>();
  float h[G::TI][2 * G::TV];
  dual_product<G, false>(h, ring, stage1_src(o, wout, wout, K, m0, n0), o,
                         M, K, N2, arow, bcol);
#pragma unroll
  for (int j = 0; j < G::TV; ++j) {
    const int n = n0 + bcol + 8 * j;
    if (n >= N2) continue;
#pragma unroll
    for (int i = 0; i < G::TI; ++i) {
      const int m = m0 + arow + 4 * i;
      if (m >= M) continue;
      out[(long)m * N + n] = h[i][j];
      out[(long)m * N + N2 + n] = h[i][j + G::TV];
    }
  }
}

// Start copying the QK-deep chunk at column k0 of rows [r0, r0 + ROWS) of
// src (n_rows x K, row-major, K a multiple of 4) into a [row][k] tile of
// pitch QK + 4; zeros outside the tensor.
template <int NT, int ROWS, int QK>
__device__ __forceinline__ void cp_chunk(float* dst, const float* src,
                                         int r0, int n_rows, int K, int k0) {
  constexpr int V4 = QK / 4;
  for (int i = threadIdx.x; i < ROWS * V4; i += NT) {
    const int r = i / V4, c = (i - r * V4) * 4;
    const bool ok = r0 + r < n_rows && k0 + c < K;
    cp16(dst + r * (QK + 4) + c,
         ok ? src + (long)(r0 + r) * K + k0 + c : src, ok);
  }
}

// K1 (NSRC == 1) and K2 (NSRC == 2): grid (q tiles of BR rows, H, B). The
// block projects q = (x_q tile . Wq_h^T) * scale over QK-deep chunks of C
// (a ring of two stages of BR x rows and DP Wq rows in the keys' region)
// into the q tile, attends over each source's k/v rows of the (B, H, Lk, D)
// workspace and writes (B, Lq, H*D) at the head's columns; the pair adds
// its second source's normalised output to the first's in fp32 there.
template <int DP, int NSRC>
__global__ void __launch_bounds__(AttendGeom<DP>::NT, attend_min_blocks(DP))
heads_f32_kernel(const float* __restrict__ xq, const float* __restrict__ wq,
                 const float* __restrict__ kws,
                 const float* __restrict__ vws, float* __restrict__ out,
                 int Lq, int C, int Lk, int H, int D, float scale,
                 const int* __restrict__ table, int n_views) {
  extern __shared__ __align__(16) float smem[];
  using G = AttendGeom<DP>;
  using S = AttendSmem<DP>;
  constexpr int BR = G::BR, TI = G::TI, TD = G::TD, QK = S::QK, QP = QK + 4;
  // the pair needs the registers of loading ahead for its second source
  constexpr int KU = NSRC == 1 ? attend_ku<DP>() : 1;
  constexpr int STAGE = (BR + DP) * QP;
  const int q0 = blockIdx.x * BR, h = blockIdx.y, b = blockIdx.z;
  const int arow = warp() * 4 * TI + lane_ty(), tx = lane_tx();
  float o[TI][TD];  // the q projection, then each source's output

  // ---- the q tile: ((x_q . Wq_h^T) * scale), pad columns zero ----
  {
    const float* x = xq + (long)b * Lq * C;
    const float* w = wq + (long)h * D * C;  // the head's D rows
    float* ring = smem + S::RING;
    const int T = (C + QK - 1) / QK;
    auto load = [&](int t) {
      float* st = ring + (t & 1) * STAGE;
      cp_chunk<G::NT, BR, QK>(st, x, q0, Lq, C, t * QK);
      cp_chunk<G::NT, DP, QK>(st + BR * QP, w, 0, D, C, t * QK);
    };
    zero(o);
    load(0);
    cp_commit();
    for (int t = 0; t < T; ++t) {
      cp_wait<0>();
      __syncthreads();  // chunk t is in; every thread is done with t - 1
      if (t + 1 < T) load(t + 1);
      cp_commit();
      const float* st = ring + (t & 1) * STAGE;
      fma_rows<TI, TD, TD, 0, QP, QP, QK, KU>(o, st + arow * QP,
                                                st + (BR + tx) * QP);
    }
    float* q = smem + S::Q + arow * G::LR + tx;
#pragma unroll
    for (int i = 0; i < TI; ++i)
#pragma unroll
      for (int j = 0; j < TD; ++j) q[4 * i * G::LR + 8 * j] = o[i][j] * scale;
    __syncthreads();  // the keys' ring takes the projection's place
  }

  // ---- each source, normalised; the pair's second added in fp32 ----
  const long ld = (long)H * D;
  float* dst = out + (long)b * Lq * ld + (long)h * D;
#pragma unroll 1
  for (int src = 0; src < NSRC; ++src) {
    const int v = b % n_views;
    const int kb = NSRC == 1 ? b : b - v + __ldg(table + src * n_views + v);
    const long base = ((long)kb * H + h) * Lk * D;
    float m[TI], l[TI];
    attend<DP, KU>(smem, kws + base, vws + base, Lk, Lk, D, m, l, o);
#pragma unroll
    for (int i = 0; i < TI; ++i) {
      const int r = q0 + arow + 4 * i;
      if (r >= Lq) continue;
      const float inv = 1.0f / l[i];
#pragma unroll
      for (int j = 0; j < TD; ++j) {
        const int d = tx + 8 * j;
        if (d >= D) continue;
        float* y = dst + r * ld + d;
        *y = src == 0 ? o[i][j] * inv : *y + o[i][j] * inv;
      }
    }
  }
}

// The heads kernel's shared memory, opted in once per device.
template <int DP, int NSRC>
static cudaError_t heads_opt_in() {
  static unsigned opted_in = 0;
  return allow_smem_once(heads_f32_kernel<DP, NSRC>, AttendSmem<DP>::BYTES,
                         opted_in);
}

template <int DP, int NSRC>
static cudaError_t launch_heads_dp(const float* xq, const float* wq,
                                   const float* k, const float* v, float* out,
                                   int B, int Lq, int C, int Lk, int H, int D,
                                   float scale, const int* table, int n_views,
                                   cudaStream_t stream) {
  using G = AttendGeom<DP>;
  auto kern = heads_f32_kernel<DP, NSRC>;
  const size_t bytes = AttendSmem<DP>::BYTES;
  const cudaError_t e = heads_opt_in<DP, NSRC>();
  if (e != cudaSuccess) return e;
  const dim3 grid((Lq + G::BR - 1) / G::BR, H, B);
  kern<<<grid, G::NT, bytes, stream>>>(xq, wq, k, v, out, Lq, C, Lk, H, D,
                                       scale, table, n_views);
  return cudaGetLastError();
}

template <int NSRC>
static cudaError_t launch_heads(const float* xq, const float* wq,
                                const float* k, const float* v, float* out,
                                int B, int Lq, int C, int Lk, int H, int D,
                                float scale, const int* table, int n_views,
                                cudaStream_t stream) {
  // rows of C and of D floats are whole 16-byte vectors
  if (B <= 0 || B > 65535 || Lq <= 0 || Lk <= 0 || C <= 0 || C % 8 ||
      H <= 0 || H > 65535 || D <= 0 || D > 128 || D % 8 || n_views <= 0 ||
      B % n_views || (NSRC == 2 && table == nullptr) ||
      !aligned16({xq, wq, k, v, out}))
    return cudaErrorInvalidValue;
#define MDK_HEADS_CASE(DPV)                                               \
  case DPV:                                                               \
    return launch_heads_dp<DPV, NSRC>(xq, wq, k, v, out, B, Lq, C, Lk, H, \
                                      D, scale, table, n_views, stream);
  switch (depth_instance(D)) {
    MDK_F32_DEPTHS(MDK_HEADS_CASE)
    default:
      return cudaErrorInvalidValue;
  }
#undef MDK_HEADS_CASE
}

// The heads kernel's tile at depth instance DP: what 0 the q rows a block
// owns, 1 the keys of a streamed tile, 2 the blocks an SM holds on the
// current card (its registers and shared memory); -1 otherwise.
template <int DP, int NSRC>
static int heads_tile(int what) {
  using G = AttendGeom<DP>;
  if (what == 0) return G::BR;
  if (what == 1) return G::KT;
  int blocks = -1;
  if (what != 2 || heads_opt_in<DP, NSRC>() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, heads_f32_kernel<DP, NSRC>, G::NT,
          AttendSmem<DP>::BYTES) != cudaSuccess)
    return -1;
  return blocks;
}

// A dual product's grid over M rows and N value columns on tile G, its
// kernel's shared memory opted in once per device.
template <class G, class Kernel, class... Args>
static cudaError_t launch_dual(Kernel kern, unsigned& opted_in, int M, int N,
                               cudaStream_t stream, Args... args) {
  const cudaError_t e = allow_smem_once(kern, G::SMEM, opted_in);
  if (e != cudaSuccess) return e;
  if ((M + G::BM - 1) / G::BM > 65535) return cudaErrorInvalidValue;
  const dim3 grid((N + G::BN - 1) / G::BN, (M + G::BM - 1) / G::BM);
  kern<<<grid, G::NT, G::SMEM, stream>>>(args...);
  return cudaGetLastError();
}

template <class G>
static cudaError_t launch_kv_project(const float* x, const float* wk,
                                     const float* wv, float* k, float* v,
                                     int M, int Lk, int Ck, int H, int D,
                                     cudaStream_t stream) {
  static unsigned opted_in = 0;
  return launch_dual<G>(kv_project_f32_kernel<G>, opted_in, M, H * D, stream,
                        x, wk, wv, k, v, M, Lk, Ck, H, D);
}

template <class G>
static cudaError_t launch_out_project(const float* o, const float* wout,
                                      float* out, int M, int K, int N,
                                      cudaStream_t stream) {
  static unsigned opted_in = 0;
  return launch_dual<G>(out_project_f32_kernel<G>, opted_in, M, N / 2,
                        stream, o, wout, out, M, K, N);
}

}  // namespace f32
}  // namespace mdk

extern "C" {

// x: (B, Lk, Ck) fp32; wk, wv: (H*D, Ck) nn.Linear layout; k, v: (B, H, Lk,
// D) fp32 workspaces. Ck and D multiples of 8, pointers 16-byte aligned.
// The tile is mdk_project_f32_tile's for (B*Lk, H*D).
int mdk_kv_project_f32(const void* x, const void* wk, const void* wv,
                       void* k, void* v, int B, int Lk, int Ck, int H, int D,
                       void* stream) {
  using namespace mdk::f32;
  if (B <= 0 || Lk <= 0 || H <= 0 || D <= 0 || D % 8 || Ck <= 0 || Ck % 8 ||
      !mdk::aligned16({x, wk, wv, k, v}))
    return (int)cudaErrorInvalidValue;
  const int M = B * Lk;
  const auto X = static_cast<const float*>(x);
  const auto WK = static_cast<const float*>(wk);
  const auto WV = static_cast<const float*>(wv);
  const auto K = static_cast<float*>(k);
  const auto V = static_cast<float*>(v);
  const auto s = static_cast<cudaStream_t>(stream);
  return (int)on_dual_tile(dual_tile(M, H * D), [&](auto g) {
    return launch_kv_project<decltype(g)>(X, WK, WV, K, V, M, Lk, Ck, H, D,
                                          s);
  });
}

// xq: (B, Lq, C); wq: (H*D, C); k, v: (B, H, Lk, D) from
// mdk_kv_project_f32; out: (B, Lq, H*D), all fp32
int mdk_kvstat_attention_f32(const void* xq, const void* wq, const void* k,
                             const void* v, void* out, int B, int Lq, int C,
                             int Lk, int H, int D, float scale,
                             void* stream) {
  return (int)mdk::f32::launch_heads<1>(
      static_cast<const float*>(xq), static_cast<const float*>(wq),
      static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), B, Lq, C, Lk, H, D, scale, nullptr, 1,
      static_cast<cudaStream_t>(stream));
}

// x: (B, L, C) the views' hidden states; k, v: (B, H, L, D) projected from
// x; out: (B, L, H*D), all fp32. B a multiple of n_views; table: int32
// [2][n_views] on the device, every entry in [0, n_views).
int mdk_kvstat_attention_pair_f32(const void* x, const void* wq,
                                  const void* k, const void* v, void* out,
                                  int B, int L, int C, int H, int D,
                                  float scale, const void* table,
                                  int n_views, void* stream) {
  return (int)mdk::f32::launch_heads<2>(
      static_cast<const float*>(x), static_cast<const float*>(wq),
      static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), B, L, C, L, H, D, scale,
      static_cast<const int*>(table), n_views,
      static_cast<cudaStream_t>(stream));
}

// o: (M, K); wout: (N, K) nn.Linear layout; out: (M, N), all fp32; K and N
// multiples of 8, pointers 16-byte aligned. The tile is
// mdk_project_f32_tile's for (M, N / 2).
int mdk_out_project_f32(const void* o, const void* wout, void* out, int M,
                        int K, int N, void* stream) {
  using namespace mdk::f32;
  if (M <= 0 || K <= 0 || K % 8 || N <= 0 || N % 8 ||
      !mdk::aligned16({o, wout, out}))
    return (int)cudaErrorInvalidValue;
  const auto O = static_cast<const float*>(o);
  const auto W = static_cast<const float*>(wout);
  const auto Y = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  return (int)on_dual_tile(dual_tile(M, N / 2), [&](auto g) {
    return launch_out_project<decltype(g)>(O, W, Y, M, K, N, s);
  });
}

// The tile the fp32 kv projection (M = B*Lk rows, N = H*D value columns)
// or out-projection (M rows, N = half its output columns) takes on the
// current card: 0 the 128 x 32 tile, 1 the 112 x 64 one, 2 the 112 x 32
// one, 3 the 128 x 40 one; -1 when M or N is not positive or the card
// cannot be asked.
int mdk_project_f32_tile(int M, int N) {
  return M > 0 && N > 0 ? mdk::f32::dual_tile(M, N) : -1;
}

// The tile of K1's (nsrc 1) or K2's (nsrc 2) fp32 heads kernel at head
// depth D (a multiple of 8, at most 128): what 0 the q rows a block owns,
// 1 the keys of a streamed tile, 2 the blocks an SM holds on the current
// card; -1 for anything else.
int mdk_kvstat_f32_tile(int nsrc, int D, int what) {
  using namespace mdk::f32;
#define MDK_TILE_CASE(DPV)                                            \
  case DPV:                                                           \
    return nsrc == 1 ? heads_tile<DPV, 1>(what)                       \
                     : nsrc == 2 ? heads_tile<DPV, 2>(what) : -1;
  switch (D > 0 && D % 8 == 0 ? depth_instance(D) : 0) {
    MDK_F32_DEPTHS(MDK_TILE_CASE)
    default:
      return -1;
  }
#undef MDK_TILE_CASE
}

}  // extern "C"
