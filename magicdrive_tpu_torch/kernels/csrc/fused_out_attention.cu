// The out-projection of K8 and of the K8 pair for Hopper (sm_90a).
//
// K7, K8 and the K8 pair replace the Pallas kernels
// magicdrive_tpu/kernels/fused_attention.py
//  * _fused_kernel (K7; launcher _fused_fwd_impl, entry fused_qkv_attention):
//    o_h = softmax((x_q Wq_h) scale (x_kv Wk_h)^T) (x_kv Wv_h) per head,
//    written as (B, Lq, H*D): K1's function;
//  * _fused_kernel_out (K8; launcher _fused_fwd_impl with wout, entry
//    fused_qkv_out_attention): y = sum_h bf16(o_h) Wout_h^T, fp32
//    accumulation, one cast, no bias, written as (B, Lq, C_out);
//  * _fused_kernel_out2 (the K8 pair; launcher _pair_fwd_impl, entry
//    fused_qkv_out_attention_pair): per head the two neighbours' normalised
//    outputs summed in fp32 before the cast (K2's function over any
//    neighbour table), then as K8.
//
// Design. The TPU kernels keep o in VMEM and recompute k/v per q block; both
// are tile plans, not the contract. Here each is K1's or K2's launches
// (kvstat_attention.cu, proj_attend.cuh: k/v projected once into a
// (B, H, Lk, D) workspace, then one block per (64-row q tile, head, batch)
// on the register-tile core), and K8 and its pair add this file's kernel,
// which multiplies the bf16 (B*Lq, H*D) output by Wout^T. The summed heads of
// the contract are one product over K = H*D with an fp32 accumulator, so the
// cast points are the Pallas kernels': bf16 o_h (the pair: one cast of the
// fp32 sum), fp32 accumulation over every head, one bf16 cast. The o
// workspace (10.75 MB at the 28x50 level with 12 views) costs about 6 us of
// device-memory traffic to write and read back.
//
// The out-projection (out_project_kernel) is a plain matrix product,
// y (M, N) = o (M, K) . Wout^T with Wout (N, K) in nn.Linear layout, built as
// K4 (geglu.cu) is: a block of 128 rows x 64 output columns, two consumer
// warpgroups of 64 rows and one producer warp that keeps TMA loads of
// 128-byte swizzled 64-deep K chunks in flight through a four-stage mbarrier
// ring; SS wgmma (m64n64k16) accumulates in fp32 registers. The epilogue casts
// once to bf16, stages the 128 x 64 tile in the drained ring and writes it as
// 16-byte vectors. TMA zero-fills the ragged edges (rows past M, K columns past
// H*D = 80 say, Wout rows past N), and rows and columns past M and N are not
// stored. One thread writes each output element, with no atomics, so two calls
// on the same inputs are bitwise equal.
//
// Bound. At the path's shapes (M = 16,800, K = N = 320 at level 0; M = 4,200,
// K = N = 640 at level 1) the product is 3.44 GFLOP (3.5 us at the bf16
// tensor peak) against 21.7 or 10.8 MB of o, Wout and y (6.5 or 3.2 us at
// 3.35 TB/s): bound by bytes at level 0. The grid runs the output-column
// tiles of one row block side by side (blockIdx.x), so o comes from device
// memory about once and from L2 for the other tiles.
#include "common.cuh"
#include "wgmma_tile.cuh"

namespace mdk {

constexpr int OP_THREADS = 288;    // warpgroups 0-1 consume, warp 8 produces
constexpr int OP_CONSUMERS = 256;
constexpr int OP_BM = 128, OP_BN = 64, OP_BK = 64, OP_STAGES = 4;
constexpr uint32_t OP_A_BOX = OP_BM * OP_BK * 2;  // 128 rows of o, 16 KB
constexpr uint32_t OP_B_BOX = OP_BN * OP_BK * 2;  // 64 rows of Wout, 8 KB
constexpr uint32_t OP_STAGE = OP_A_BOX + OP_B_BOX;
constexpr uint32_t OP_WG_ROWS = 64 * OP_BK * 2;   // a warpgroup's 64 rows
constexpr int OP_LDC = OP_BN + 8;  // bf16 pitch of the staged output tile
constexpr size_t OP_SMEM = wg::SW128_ATOM + OP_STAGES * OP_STAGE +
                           2 * OP_STAGES * 8;
static_assert(OP_BM * OP_LDC * 2 <= OP_STAGES * OP_STAGE,
              "the output tile is staged in the ring");

__global__ void __launch_bounds__(OP_THREADS, 2)
out_project_kernel(const __grid_constant__ CUtensorMap tm_o,
                   const __grid_constant__ CUtensorMap tm_w,
                   bf16* __restrict__ out, int M, int K, int N) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = wg::smem_u32(smem_raw);
  const uint32_t base = (raw + wg::SW128_ATOM - 1) & ~(wg::SW128_ATOM - 1);
  const uint32_t bars = base + OP_STAGES * OP_STAGE;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (OP_STAGES + s); };
  const int n0 = blockIdx.x * OP_BN, m0 = blockIdx.y * OP_BM;
  const int KT = (K + OP_BK - 1) / OP_BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < OP_STAGES; ++s) {
      wg::mbar_init(full(s), 1);
      wg::mbar_init(empty(s), OP_CONSUMERS);
    }
    wg::mbar_fence_init();
  }
  __syncthreads();

  if (warp == 8) {  // producer: o rows m0.., then Wout rows n0.., per chunk
    if (lane == 0) {
      wg::tma_prefetch_map(&tm_o);
      wg::tma_prefetch_map(&tm_w);
      int s = 0;
      uint32_t phase = 0;
      for (int kt = 0; kt < KT; ++kt) {
        wg::mbar_wait(empty(s), phase ^ 1);
        wg::mbar_expect_tx(full(s), OP_STAGE);
        const uint32_t st = base + s * OP_STAGE;
        wg::tma_load_2d(st, &tm_o, full(s), kt * OP_BK, m0);
        wg::tma_load_2d(st + OP_A_BOX, &tm_w, full(s), kt * OP_BK, n0);
        if (++s == OP_STAGES) s = 0, phase ^= 1;
      }
    }
    return;
  }

  // consumer warpgroup w: rows m0 + 64 w .. + 63 of the 64 output columns
  const int w = warp / 4;
  float d[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.0f;
  int s = 0, prev = 0;
  uint32_t phase = 0;
  for (int kt = 0; kt < KT; ++kt) {
    wg::mbar_wait(full(s), phase);
    const uint32_t st = base + s * OP_STAGE;
    wg::mma_fence();
#pragma unroll
    for (int kk = 0; kk < OP_BK / 16; ++kk)
      wg::mma_ss_n64(d, wg::sw128(st + w * OP_WG_ROWS + 32 * kk),
                     wg::sw128(st + OP_A_BOX + 32 * kk));
    wg::mma_commit();
    if (kt > 0) {  // the previous chunk's products are done: free its slot
      wg::mma_wait<1>();
      wg::mbar_arrive(empty(prev));
    }
    prev = s;
    if (++s == OP_STAGES) s = 0, phase ^= 1;
  }
  wg::mma_wait<0>();
  wg::fence_operands(d);

  // epilogue: every load was consumed, so once both warpgroups' products
  // are done the ring is free; the tile is cast once, staged there and
  // leaves as 16-byte vectors
  asm volatile("bar.sync 1, %0;\n" ::"n"(OP_CONSUMERS) : "memory");
  bf16* cs = reinterpret_cast<bf16*>(smem_raw + (base - raw));
  const int g = lane / 4, q = lane % 4;
  const int r0 = 64 * w + 16 * (warp % 4) + g;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint32_t*>(cs + (r0 + 8 * h) * OP_LDC + 8 * j +
                                   2 * q) =
          wg::pack_bf16(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
  asm volatile("bar.sync 1, %0;\n" ::"n"(OP_CONSUMERS) : "memory");
  constexpr int VPR = OP_BN / 8;  // vectors a row
  for (int i = threadIdx.x; i < OP_BM * VPR; i += OP_CONSUMERS) {
    const int r = i / VPR, c = (i % VPR) * 8;
    if (m0 + r < M && n0 + c < N)  // N % 8 == 0: the whole vector is in
      *reinterpret_cast<uint4*>(out + (long)(m0 + r) * N + n0 + c) =
          *reinterpret_cast<const uint4*>(cs + r * OP_LDC + c);
  }
}

}  // namespace mdk

extern "C" {

// o: (M, K) bf16, the heads' output (B*Lq rows of H*D); wout: (N, K) bf16 in
// nn.Linear layout; out: (M, N) bf16. K and N multiples of 8 (16-byte TMA
// strides and stores), every pointer 16-byte aligned.
int mdk_out_project(const void* o, const void* wout, void* out, int M, int K,
                    int N, void* stream) {
  using namespace mdk;
  if (M <= 0 || K <= 0 || K % 8 || N <= 0 || N % 8 ||
      (M + OP_BM - 1) / OP_BM > 65535 || !aligned16({o, wout, out}))
    return (int)cudaErrorInvalidValue;
  CUtensorMap to, tw;
  cudaError_t e = wg::encode_2d(&to, o, M, K, OP_BM, OP_BK,
                                CU_TENSOR_MAP_SWIZZLE_128B);
  if (e == cudaSuccess)
    e = wg::encode_2d(&tw, wout, N, K, OP_BN, OP_BK,
                      CU_TENSOR_MAP_SWIZZLE_128B);
  static unsigned opted_in = 0;
  if (e == cudaSuccess)
    e = allow_smem_once(out_project_kernel, OP_SMEM, opted_in);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((N + OP_BN - 1) / OP_BN, (M + OP_BM - 1) / OP_BM);
  out_project_kernel<<<grid, OP_THREADS, OP_SMEM,
                       static_cast<cudaStream_t>(stream)>>>(
      to, tw, static_cast<bf16*>(out), M, K, N);
  return (int)cudaGetLastError();
}

}  // extern "C"
