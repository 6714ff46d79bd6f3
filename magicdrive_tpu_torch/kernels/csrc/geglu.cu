// K3 (whole FeedForward) and K4 (GEGLU stage 1) for Hopper (sm_90a).
//
// K4 replaces magicdrive_tpu/kernels/geglu.py _kernel (launcher
// _geglu_fwd_impl, entry fused_geglu): out = (x.Wv + bv) * gelu_erf(x.Wg + bg)
// with fp32 accumulation, written in bf16; stage 2 of the FeedForward stays a
// matrix product outside the kernel, as in the JAX package.
// K3 replaces geglu.py _ff_kernel (launcher _ff_fwd_impl, entry fused_ff):
// out = bf16((x.Wv + bv) * gelu_erf(x.Wg + bg)) . W2 with an fp32
// accumulator; the caller adds the W2 bias.
//
// Weights arrive in nn.Linear layout: W1 = ff.net.0.proj.weight (2N, K),
// value rows [0, N) first and gate rows [N, 2N) second; W2 =
// ff.net.2.weight (C, N). GELU is the exact erf form (erff); the TPU
// kernel's rational erf polynomial only worked around a Mosaic gap. The
// cast points are the Pallas kernels': value and gate accumulate in fp32,
// the biases are added in fp32, g = bf16(hv * gelu(hg)), and K3's stage 2
// accumulates in fp32 and casts once. One thread writes each output element
// and there are no atomics, so two calls on the same inputs are bitwise
// equal.
//
// Bound: both are matrix products (4*M*K*N operations for the two halves,
// plus 2*M*N*C for K3's stage 2), so the tensor cores bind at the path's
// shapes. The design is the one the card's tensor-core rate asks for
// (wgmma_tile.cuh): two consumer warpgroups of 64 rows each and one
// producer (a warp in K4, a warpgroup in K3) that keeps TMA loads of
// swizzled tiles in flight through an mbarrier ring; wgmma reads both
// operands from those tiles (or A from registers) and accumulates in
// registers.
//  * K4: a block is 128 rows x 64 output columns. Its B tile stacks the 64
//    value rows of W1 over the matching 64 gate rows, so one m64n128
//    accumulator holds both halves and the thread holding value column c
//    holds gate column c too: biases, GELU and the gate run in registers,
//    and no fp32 half touches shared memory. A 3-stage ring of 64-deep K
//    chunks (32 KB each) lets two blocks share an SM.
//  * K3: a block is 128 rows and up to 320 output columns (wider outputs
//    take more blocks along y, each recomputing stage 1). x stays resident
//    in shared memory; the weights stream through the ring in inner chunks
//    of 32: the chunk's 32 value and 32 gate rows of W1, one 64-deep K piece
//    a slot (m64n64: value and gate in one accumulator, as in K4), then its
//    W2 columns (64-byte swizzle). The gated chunk, cast to bf16, is the A
//    operand of stage 2 straight from the registers (the accumulator layout
//    is the A fragment layout), and stage 2 accumulates the 64 x 320 fp32
//    output in registers (160 a thread). 128 rows a block give one wave of
//    132 blocks at M = 16,800, which read the 2.46 MB of weights 132 times
//    from L2 (32-row blocks would read them 525 times).
// Ragged edges are TMA's zero fill: rows past M, K columns past K, W2 rows
// past C. A K4 or K3 value box that runs past N reads gate rows, whose
// products land only in columns that are never stored (K4) or meet the
// zero-filled W2 columns past N (K3).
#include <chrono>

#include "common.cuh"
#include "wgmma_tile.cuh"

namespace mdk {

constexpr int GG_THREADS = 288;  // warpgroups 0-1 consume, warp 8 produces
constexpr int GG_CONSUMERS = 256;
constexpr int BM = 128;          // rows a block, 64 a consumer warpgroup
constexpr int BK = 64;           // K chunk: one 128-byte swizzled row
constexpr uint32_t X_BOX = BM * BK * 2;  // one 128 x 64 x tile, 16 KB
constexpr uint32_t WG_ROWS_BYTES = 64 * BK * 2;  // a warpgroup's 64 rows
constexpr uint32_t SW64_ATOM = 512;
using wg::SW128_ATOM;
using wg::sw128;

// ---------------------------------------------------------------------------
// K4
// ---------------------------------------------------------------------------

constexpr int GG_BN = 64, GG_STAGES = 3;
constexpr uint32_t GG_W_HALF = GG_BN * BK * 2;  // 64 value or gate rows
constexpr uint32_t GG_STAGE = X_BOX + 2 * GG_W_HALF;  // 32 KB
constexpr size_t GG_SMEM = SW128_ATOM + GG_STAGES * GG_STAGE +
                           2 * GG_STAGES * 8;

__global__ void __launch_bounds__(GG_THREADS, 2)
geglu_kernel(const __grid_constant__ CUtensorMap tm_x,
             const __grid_constant__ CUtensorMap tm_w,
             const bf16* __restrict__ b1, bf16* __restrict__ out, int M,
             int K, int N) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (wg::smem_u32(smem_raw) + SW128_ATOM - 1) &
                        ~(SW128_ATOM - 1);
  const uint32_t bars = base + GG_STAGES * GG_STAGE;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (GG_STAGES + s); };
  const int n0 = blockIdx.x * GG_BN, m0 = blockIdx.y * BM;
  const int KT = (K + BK - 1) / BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < GG_STAGES; ++s) {
      wg::mbar_init(full(s), 1);
      wg::mbar_init(empty(s), GG_CONSUMERS);
    }
    wg::mbar_fence_init();
  }
  __syncthreads();

  if (warp == 8) {  // producer: x rows, then value and gate rows of W1
    if (lane == 0) {
      wg::tma_prefetch_map(&tm_x);
      wg::tma_prefetch_map(&tm_w);
      int s = 0;
      uint32_t phase = 0;
      for (int kt = 0; kt < KT; ++kt) {
        wg::mbar_wait(empty(s), phase ^ 1);
        wg::mbar_expect_tx(full(s), GG_STAGE);
        const uint32_t st = base + s * GG_STAGE;
        wg::tma_load_2d(st, &tm_x, full(s), kt * BK, m0);
        wg::tma_load_2d(st + X_BOX, &tm_w, full(s), kt * BK, n0);
        wg::tma_load_2d(st + X_BOX + GG_W_HALF, &tm_w, full(s), kt * BK,
                        N + n0);
        if (++s == GG_STAGES) s = 0, phase ^= 1;
      }
    }
    return;
  }

  // consumer warpgroup w: rows m0 + 64 w .. + 63; d[0..31] value columns,
  // d[32..63] the matching gate columns
  const int w = warp / 4;
  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.0f;
  int s = 0, prev = 0;
  uint32_t phase = 0;
  for (int kt = 0; kt < KT; ++kt) {
    wg::mbar_wait(full(s), phase);
    const uint32_t st = base + s * GG_STAGE;
    wg::mma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wg::mma_ss_n128(d, sw128(st + w * WG_ROWS_BYTES + 32 * kk),
                      sw128(st + X_BOX + 32 * kk));
    wg::mma_commit();
    if (kt > 0) {  // the previous chunk's products are done: free its slot
      wg::mma_wait<1>();
      wg::mbar_arrive(empty(prev));
    }
    prev = s;
    if (++s == GG_STAGES) s = 0, phase ^= 1;
  }
  wg::mma_wait<0>();
  wg::fence_operands(d);

  // epilogue: biases, GELU and the gate in fp32, one bf16 pair a store
  const int g = lane / 4, q = lane % 4;
  const int row0 = m0 + 64 * w + 16 * (warp % 4) + g;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = n0 + 8 * j + 2 * q;  // N % 8 == 0: col + 1 < N too
    if (col >= N) continue;
    float bv0 = 0.0f, bv1 = 0.0f, bg0 = 0.0f, bg1 = 0.0f;
    if (b1 != nullptr) {
      bv0 = __bfloat162float(b1[col]);
      bv1 = __bfloat162float(b1[col + 1]);
      bg0 = __bfloat162float(b1[N + col]);
      bg1 = __bfloat162float(b1[N + col + 1]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= M) continue;
      const float v0 = d[4 * j + 2 * h] + bv0, v1 = d[4 * j + 2 * h + 1] + bv1;
      const float g0 = d[32 + 4 * j + 2 * h] + bg0;
      const float g1 = d[32 + 4 * j + 2 * h + 1] + bg1;
      *reinterpret_cast<uint32_t*>(out + (long)row * N + col) =
          wg::pack_bf16(v0 * gelu_erf(g0), v1 * gelu_erf(g1));
    }
  }
}

// ---------------------------------------------------------------------------
// K3
// ---------------------------------------------------------------------------

constexpr int FF_CHUNK = 32;  // inner columns a chunk: 32 value + 32 gate
constexpr int FF_MAX_NC = 5;  // 64-column output tiles a block: C <= 320
constexpr int FF_MAX_SLOTS = 8;
// K3's producer is a whole warpgroup (one thread issues the loads) so that
// setmaxnreg can move its registers to the consumers: the block's pool is
// 384 x 168, and 128 x 40 + 256 x 232 fills it.
constexpr int FF_THREADS = 384;
constexpr uint32_t FF_W1_HALF = FF_CHUNK * BK * 2;    // 4 KB
constexpr uint32_t FF_W2_BOX = 64 * FF_CHUNK * 2;     // 64 rows of W2, 4 KB

template <int NC>
__host__ __device__ constexpr uint32_t ff_slot_bytes() {
  return NC * FF_W2_BOX > 2 * FF_W1_HALF ? NC * FF_W2_BOX : 2 * FF_W1_HALF;
}

// Slot sequence, the same for producer and consumers: for each inner chunk
// n0 = 32 j, ceil(K / 64) slots of W1 (value rows n0.., gate rows N + n0..,
// columns 64 kb..), then one slot of W2 (rows ct0 + 64 c.., columns n0..).
template <int NC>
__global__ void __launch_bounds__(FF_THREADS, 1)
ff_kernel(const __grid_constant__ CUtensorMap tm_x,
          const __grid_constant__ CUtensorMap tm_w1,
          const __grid_constant__ CUtensorMap tm_w2,
          const bf16* __restrict__ b1, bf16* __restrict__ out, int M, int K,
          int N, int C, int slots) {
  constexpr uint32_t SLOT = ff_slot_bytes<NC>();
  extern __shared__ unsigned char smem_raw[];
  const int KB = (K + BK - 1) / BK;
  const uint32_t xs = (wg::smem_u32(smem_raw) + SW128_ATOM - 1) &
                      ~(SW128_ATOM - 1);
  const uint32_t ring = xs + KB * X_BOX;
  const uint32_t bars = ring + slots * SLOT;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (slots + s); };
  const uint32_t x_full = bars + 16 * slots;
  const int m0 = blockIdx.x * BM, ct0 = blockIdx.y * NC * 64;
  const int NCH = (N + FF_CHUNK - 1) / FF_CHUNK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < slots; ++s) {
      wg::mbar_init(full(s), 1);
      wg::mbar_init(empty(s), GG_CONSUMERS);
    }
    wg::mbar_init(x_full, 1);
    wg::mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 8) {  // producer warpgroup
    wg::setmaxnreg_dec<40>();
    if (threadIdx.x == GG_CONSUMERS) {
      wg::tma_prefetch_map(&tm_x);
      wg::tma_prefetch_map(&tm_w1);
      wg::tma_prefetch_map(&tm_w2);
      wg::mbar_expect_tx(x_full, KB * X_BOX);
      for (int kb = 0; kb < KB; ++kb)
        wg::tma_load_2d(xs + kb * X_BOX, &tm_x, x_full, kb * BK, m0);
      // W2 boxes that lie wholly past C are not loaded: they would only
      // feed columns that are never stored
      int nc_in = (C - ct0 + 63) / 64;
      nc_in = nc_in < NC ? nc_in : NC;
      int s = 0;
      uint32_t phase = 0;
      for (int j = 0; j < NCH; ++j) {
        const int n0 = j * FF_CHUNK;
        for (int kb = 0; kb < KB; ++kb) {
          wg::mbar_wait(empty(s), phase ^ 1);
          wg::mbar_expect_tx(full(s), 2 * FF_W1_HALF);
          const uint32_t st = ring + s * SLOT;
          wg::tma_load_2d(st, &tm_w1, full(s), kb * BK, n0);
          wg::tma_load_2d(st + FF_W1_HALF, &tm_w1, full(s), kb * BK, N + n0);
          if (++s == slots) s = 0, phase ^= 1;
        }
        wg::mbar_wait(empty(s), phase ^ 1);
        wg::mbar_expect_tx(full(s), nc_in * FF_W2_BOX);
        for (int c = 0; c < nc_in; ++c)
          wg::tma_load_2d(ring + s * SLOT + c * FF_W2_BOX, &tm_w2, full(s),
                          n0, ct0 + 64 * c);
        if (++s == slots) s = 0, phase ^= 1;
      }
    }
    return;
  }

  wg::setmaxnreg_inc<232>();
  const int w = warp / 4;
  const int g = lane / 4, q = lane % 4;
  float acc[NC][32];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.0f;
  float h[32];  // stage 1 of a chunk; its first product overwrites it
#pragma unroll
  for (int i = 0; i < 32; ++i) h[i] = 0.0f;
  wg::mbar_wait(x_full, 0);
  const uint32_t xw = xs + w * WG_ROWS_BYTES;
  int s = 0;
  uint32_t phase = 0;
  for (int j = 0; j < NCH; ++j) {
    const int n0 = j * FF_CHUNK;
    // this thread's biases of the chunk (value, gate) as bf16 pairs, loaded
    // ahead of stage 1
    uint32_t bv[4], bg[4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int n = n0 + 8 * jj + 2 * q;
      const bool ok = b1 != nullptr && n < N;
      bv[jj] = ok ? *reinterpret_cast<const uint32_t*>(b1 + n) : 0u;
      bg[jj] = ok ? *reinterpret_cast<const uint32_t*>(b1 + N + n) : 0u;
    }
    // ---- stage 1: h = x . [Wv; Wg]^T over the chunk's 32 + 32 rows ----
    int prev = -1;
    for (int kb = 0; kb < KB; ++kb) {
      wg::mbar_wait(full(s), phase);
      const uint32_t st = ring + s * SLOT;
      wg::mma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wg::mma_ss_n64(h, sw128(xw + kb * X_BOX + 32 * kk),
                       sw128(st + 32 * kk), kb + kk > 0);
      wg::mma_commit();
      if (prev >= 0) {
        wg::mma_wait<1>();
        wg::mbar_arrive(empty(prev));
      }
      prev = s;
      if (++s == slots) s = 0, phase ^= 1;
    }
    wg::mma_wait<0>();
    wg::fence_operands(h);
    wg::mbar_arrive(empty(prev));
    // ---- the gate in registers: g = bf16((hv + bv) * gelu(hg + bg)) ----
    float gv[16];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const float2 v = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&bv[jj]));
      const float2 b = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&bg[jj]));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float hv = h[4 * jj + i] + (i % 2 ? v.y : v.x);
        const float hg = h[16 + 4 * jj + i] + (i % 2 ? b.y : b.x);
        gv[4 * jj + i] = hv * gelu_erf(hg);
      }
    }
    // the A fragments of the chunk's two k16 steps
    uint32_t a[2][4];
#pragma unroll
    for (int k = 0; k < 2; ++k)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        a[k][r] = wg::pack_bf16(gv[8 * k + 2 * r], gv[8 * k + 2 * r + 1]);
    // ---- stage 2: acc += g . W2[ct0.., n0..n0+31]^T ----
    wg::mbar_wait(full(s), phase);
    const uint32_t st = ring + s * SLOT;
    wg::mma_fence();
#pragma unroll
    for (int k = 0; k < 2; ++k)
#pragma unroll
      for (int c = 0; c < NC; ++c)
        wg::mma_rs_n64(acc[c], a[k],
                       wg::desc(st + c * FF_W2_BOX + 32 * k, wg::SW64,
                                SW64_ATOM));
    wg::mma_commit();
    wg::mma_wait<0>();
#pragma unroll
    for (int c = 0; c < NC; ++c) wg::fence_operands(acc[c]);
#pragma unroll
    for (int k = 0; k < 2; ++k)
#pragma unroll
      for (int r = 0; r < 4; ++r) wg::fence_operand(a[k][r]);
    wg::mbar_arrive(empty(s));
    if (++s == slots) s = 0, phase ^= 1;
  }

  // epilogue: the fp32 output cast once, one bf16 pair a store
  const int row0 = m0 + 64 * w + 16 * (warp % 4) + g;
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int col = ct0 + 64 * c + 8 * jj + 2 * q;  // C % 8 == 0
      if (col >= C) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        if (row < M)
          *reinterpret_cast<uint32_t*>(out + (long)row * C + col) =
              wg::pack_bf16(acc[c][4 * jj + 2 * h], acc[c][4 * jj + 2 * h + 1]);
      }
    }
}

static int max_smem_optin() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return bytes;
}

template <int NC>
static cudaError_t launch_ff(const CUtensorMap& tx, const CUtensorMap& tw1,
                             const CUtensorMap& tw2, const bf16* b1, bf16* out,
                             int M, int K, int N, int C, int n_ct,
                             cudaStream_t stream) {
  constexpr uint32_t SLOT = ff_slot_bytes<NC>();
  const size_t fixed = SW128_ATOM + (size_t)((K + BK - 1) / BK) * X_BOX + 8;
  const long room = (long)max_smem_optin() - (long)fixed;
  int slots = (int)(room / (SLOT + 16));
  slots = slots < FF_MAX_SLOTS ? slots : FF_MAX_SLOTS;
  if (slots < 2) return cudaErrorInvalidValue;  // x too wide to stay resident
  const size_t bytes = fixed + (size_t)slots * (SLOT + 16);
  static unsigned opted_in = 0;  // the card's limit covers every K
  cudaError_t e = allow_smem_once(ff_kernel<NC>, max_smem_optin(), opted_in);
  if (e != cudaSuccess) return e;
  const dim3 grid((M + BM - 1) / BM, n_ct);
  ff_kernel<NC><<<grid, FF_THREADS, bytes, stream>>>(tx, tw1, tw2, b1, out, M,
                                                      K, N, C, slots);
  return cudaGetLastError();
}

}  // namespace mdk

extern "C" {

// x: (M, K); w1: (2N, K); b1: (2N,) or null; out: (M, N), all bf16, 16-byte
// aligned; K and N multiples of 8
int mdk_geglu(const void* x, const void* w1, const void* b1, void* out, int M,
              int K, int N, void* stream) {
  using namespace mdk;
  if (M <= 0 || K <= 0 || K % 8 || N <= 0 || N % 8 ||
      !aligned16({x, w1, b1, out}))
    return (int)cudaErrorInvalidValue;
  CUtensorMap tx, tw;
  cudaError_t e = wg::encode_2d(&tx, x, M, K, BM, BK,
                                CU_TENSOR_MAP_SWIZZLE_128B);
  if (e == cudaSuccess)
    e = wg::encode_2d(&tw, w1, 2L * N, K, GG_BN, BK,
                      CU_TENSOR_MAP_SWIZZLE_128B);
  static unsigned opted_in = 0;
  if (e == cudaSuccess) e = allow_smem_once(geglu_kernel, GG_SMEM, opted_in);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((N + GG_BN - 1) / GG_BN, (M + BM - 1) / BM);
  geglu_kernel<<<grid, GG_THREADS, GG_SMEM,
                 static_cast<cudaStream_t>(stream)>>>(
      tx, tw, static_cast<const bf16*>(b1), static_cast<bf16*>(out), M, K, N);
  return (int)cudaGetLastError();
}

#define MDK_FF_CASE(NC)                                                    \
  case NC:                                                                 \
    return (int)launch_ff<NC>(tx, tw1, tw2, static_cast<const bf16*>(b1), \
                              static_cast<bf16*>(out), M, K, N, C, n_ct,   \
                              static_cast<cudaStream_t>(stream));

// x: (M, K); w1: (2N, K); b1: (2N,) or null; w2: (C, N); out: (M, C), all
// bf16, 16-byte aligned; K, N and C multiples of 8, and x's 128-row block
// must stay resident beside a two-slot ring (K <= 704).
int mdk_ff(const void* x, const void* w1, const void* b1, const void* w2,
           void* out, int M, int K, int N, int C, void* stream) {
  using namespace mdk;
  if (M <= 0 || K <= 0 || K % 8 || N <= 0 || N % 8 || C <= 0 || C % 8 ||
      !aligned16({x, w1, b1, w2, out}))
    return (int)cudaErrorInvalidValue;
  // output tiles of 64 columns, at most FF_MAX_NC a block, spread evenly
  // over the fewest blocks along y
  const int tiles = (C + 63) / 64;
  const int n_ct = (tiles + FF_MAX_NC - 1) / FF_MAX_NC;
  const int nc = (tiles + n_ct - 1) / n_ct;
  CUtensorMap tx, tw1, tw2;
  cudaError_t e = wg::encode_2d(&tx, x, M, K, BM, BK,
                                CU_TENSOR_MAP_SWIZZLE_128B);
  if (e == cudaSuccess)
    e = wg::encode_2d(&tw1, w1, 2L * N, K, FF_CHUNK, BK,
                      CU_TENSOR_MAP_SWIZZLE_128B);
  if (e == cudaSuccess)
    e = wg::encode_2d(&tw2, w2, C, N, 64, FF_CHUNK,
                      CU_TENSOR_MAP_SWIZZLE_64B);
  if (e != cudaSuccess) return (int)e;
  switch (nc) {
    MDK_FF_CASE(1)
    MDK_FF_CASE(2)
    MDK_FF_CASE(3)
    MDK_FF_CASE(4)
    MDK_FF_CASE(5)
  }
  return (int)cudaErrorInvalidValue;
}

#undef MDK_FF_CASE

// Mean host microseconds of one tensor-map encoding, as K3 and K4 do on
// every call (three and two of them), over `iters` encodings of a
// (4096, 1024) bf16 map, the one-time lookup of the driver's entry point
// left out; -1 if the driver lacks it.
float mdk_tensor_map_encode_us(int iters) {
  CUtensorMap map;
  const void* fake = reinterpret_cast<const void*>(uintptr_t(1) << 40);
  if (mdk::wg::encode_tiled() == nullptr) return -1.0f;  // found once, untimed
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < iters; ++i)
    if (mdk::wg::encode_2d(&map, fake, 4096, 1024, 128, 64,
                           CU_TENSOR_MAP_SWIZZLE_128B) != cudaSuccess)
      return -1.0f;
  const std::chrono::duration<float, std::micro> dt =
      std::chrono::steady_clock::now() - t0;
  return dt.count() / (iters > 0 ? iters : 1);
}

}  // extern "C"
