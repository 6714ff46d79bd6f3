// K1: kv-stationary projection-fused attention for Hopper (sm_90a).
//
// Replaces the Pallas kernels magicdrive_tpu/kernels/fused_attention.py
// _fused_kvstat_kernel / _fused_kvstat_group_kernel (launcher
// _kvstat_fwd_impl, entry fused_kvstat_attention): per (batch, head)
// k = x_kv.Wk_h and v = x_kv.Wv_h projected once, q = bf16((x_q.Wq_h)*scale)
// per q block, o = softmax(q k^T) v with fp32 logits and statistics, p cast
// to bf16 before P.V, o divided by the row sum in fp32; no mask or bias.
//
// The TPU kernel kept one (batch, head)'s whole k/v resident in fast memory.
// At L=1400, D=40 that is already 224 KB in bf16, the whole of an SM's
// shared memory, so K1 is two launches here:
//  1. kv_project_kernel writes k and v once per (batch, head) into a
//     (B, H, Lk, D) bf16 workspace: the stand-in for kv-stationary scratch.
//     K2, K7, K8 and the K8 pair run it too. It was a WMMA GEMM with
//     synchronous loads and 2-byte stores through an fp32 tile, and took
//     0.1045 of K1's 0.3558 ms at L=1400 once the attention below was
//     redesigned (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md); it is now
//     mma.sync on a three-stage cp.async ring with 16-byte stores.
//  2. kvstat_kernel<DP, 1> (proj_attend.cuh) projects a 64-row q tile in
//     registers and streams the head's k/v tiles with an online softmax.
//
// Bound. At the 28x50 level (12 views, Lq=Lk=1400, C=320, 8 heads of 40)
// the function needs 40.4 GFLOP, three quarters of it the logits and P.V
// (4*Lq*Lk*D a head), against 22 MB of inputs and output: 0.041 ms of
// operations at the bf16 tensor peak against 0.007 ms of bytes. At attn2
// (Lk=238 context tokens of width 768) the bytes come close: 27 MB (0.008
// ms) against 11.4 GFLOP (0.0115 ms). Each block reads its head's k/v once
// from L2; q never reaches device memory.
//
// Design against the six faults of the WMMA core it replaced (attend_tile,
// deleted once K7 and K8 moved to this core too):
//  1. logits went to shared memory in fp32: they stay in mma.sync C
//     fragments (m16n8k16 on ldmatrix fragments);
//  2. the softmax ran row by row across a warp, two 5-step reductions a
//     row: each thread keeps two rows' statistics, reduced over the four
//     threads of a row with two shuffles (tile::online_softmax);
//  3. p made a round trip through shared memory: two C fragments cast to
//     bf16 are the A fragment of P.V (tile::c_to_a);
//  4. the o accumulator lived in shared memory, reloaded and restored per
//     k tile: it stays in registers, rescaled in place;
//  5. the loads were synchronous, two barriers per k/v tile and per C chunk
//     of the projection: both stream through three-stage cp.async rings
//     with one barrier per tile or chunk, and the first k/v tile is in
//     flight during the projection;
//  6. the shared-memory plan was about 70 KB at DP=48: it is 43,008 B (the
//     k/v ring, with the projection ring laid over its stages 1 and 2), so
//     registers, not shared memory, set the blocks per SM.
// The block shape (64 q rows, one head, four warps) is K5's forward, which
// runs at 1.08x the flash SDPA forward on this card (PERF.md): the
// grid has ceil(Lq/64)*H*B blocks (2,112 at L=1400), enough to fill the
// 132 SMs several times over, and the x_q tile each of the 8 heads re-reads
// comes from L2 (x_q is 10.75 MB at L=1400). Looping the heads inside a
// block would cut that re-read but shrink the grid eightfold.
#include "proj_attend.cuh"

namespace mdk {

constexpr int PRJ_BM = 64, PRJ_BN = 64, PRJ_KC = 32, PRJ_THREADS = 128;
constexpr int PRJ_STAGES = 3;
constexpr int PRJ_LDX = PRJ_KC + 8;  // chunk pitch (bf16): ldmatrix rows
                                     // fall in distinct bank groups
constexpr int PRJ_LDC = PRJ_BN + 8;  // output tile pitch (bf16)

// out_z[b, h, l, d] = sum_c x[b*Lk + l, c] * W_z[h*D + d, c] for z = k, v
// (blockIdx.z picks k or v), cast to bf16: a GEMM with M = B*Lk, N = H*D,
// K = Ck on 64 x 64 tiles, four warps of 32 x 32. The x and W rows of each
// 32-wide K chunk stream through a three-stage cp.async ring; mma.sync
// accumulates in fp32 registers; the tile is cast to bf16 through shared
// memory and leaves as 16-byte vectors, each 8 columns of one head (D is a
// multiple of 8), into the (B, H, Lk, D) layout.
__global__ void __launch_bounds__(PRJ_THREADS)
kv_project_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wk,
                  const bf16* __restrict__ wv, bf16* __restrict__ kout,
                  bf16* __restrict__ vout, int M, int Lk, int Ck, int H,
                  int D) {
  constexpr int CHUNK = (PRJ_BM + PRJ_BN) * PRJ_LDX;  // x rows, then W rows
  __shared__ __align__(128) bf16 ring[PRJ_STAGES * CHUNK];
  static_assert(PRJ_BM * PRJ_LDC <= PRJ_STAGES * CHUNK,
                "the output tile reuses the ring");

  const bf16* w = blockIdx.z == 0 ? wk : wv;
  bf16* out = blockIdx.z == 0 ? kout : vout;
  const int N = H * D;
  const int m0 = blockIdx.x * PRJ_BM, n0 = blockIdx.y * PRJ_BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wr = (warp / 2) * 32, wc = (warp % 2) * 32;
  const int nc = (Ck + PRJ_KC - 1) / PRJ_KC;
  auto load_chunk = [&](int c) {
    tile::cp_chunk<PRJ_BM, PRJ_BN, PRJ_KC, PRJ_LDX>(
        ring + (c % PRJ_STAGES) * CHUNK, x, m0, M, w, n0, N, c * PRJ_KC, Ck);
  };

  for (int c = 0; c < PRJ_STAGES - 1; ++c) {
    if (c < nc) load_chunk(c);
    tile::cp_commit();
  }
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
  for (int c = 0; c < nc; ++c) {
    tile::cp_wait<PRJ_STAGES - 2>();
    __syncthreads();  // chunk c landed; every warp is done with chunk c - 1
    if (c + PRJ_STAGES - 1 < nc) load_chunk(c + PRJ_STAGES - 1);
    tile::cp_commit();
    const bf16* xs = ring + (c % PRJ_STAGES) * CHUNK;
    const bf16* ws = xs + PRJ_BM * PRJ_LDX;
#pragma unroll
    for (int kk = 0; kk < PRJ_KC / 16; ++kk) {
      uint32_t a[2][4], b[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        tile::load_a<PRJ_LDX>(a[i], xs, wr + i * 16, kk * 16);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        tile::load_bt<PRJ_LDX>(b[j], ws, wc + j * 16, kk * 16);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          tile::mma(acc[i][2 * j], a[i], b[j][0], b[j][1]);
          tile::mma(acc[i][2 * j + 1], a[i], b[j][2], b[j][3]);
        }
    }
  }
  tile::cp_wait<0>();
  __syncthreads();  // every warp is done with the ring

  // the bf16 tile through shared memory, then 16-byte vectors out
  bf16* cs = ring;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<uint32_t*>(
            cs + (wr + i * 16 + g + 8 * r) * PRJ_LDC + wc + j * 8 + 2 * t) =
            tile::pack_bf16(acc[i][j][2 * r], acc[i][j][2 * r + 1]);
  __syncthreads();
  constexpr int VPR = PRJ_BN / 8;
  for (int i = threadIdx.x; i < PRJ_BM * VPR; i += PRJ_THREADS) {
    const int r = i / VPR, c = (i - r * VPR) * 8;
    const int gm = m0 + r, gn = n0 + c;
    if (gm < M && gn < N) {
      const int bb = gm / Lk, l = gm - bb * Lk, h = gn / D, d = gn - h * D;
      *reinterpret_cast<uint4*>(out + (((long)bb * H + h) * Lk + l) * D + d) =
          *reinterpret_cast<const uint4*>(cs + r * PRJ_LDC + c);
    }
  }
}

cudaError_t launch_kv_project(const bf16* x, const bf16* wk, const bf16* wv,
                              bf16* k, bf16* v, int B, int Lk, int Ck, int H,
                              int D, cudaStream_t stream) {
  // rows of Ck and of D bf16 are whole 16-byte vectors
  if (B <= 0 || Lk <= 0 || Ck <= 0 || Ck % 8 || H <= 0 || D <= 0 || D % 8 ||
      (long)H * D > 65535L * PRJ_BN || !aligned16({x, wk, wv, k, v}))
    return cudaErrorInvalidValue;
  const int M = B * Lk, N = H * D;
  const dim3 grid((M + PRJ_BM - 1) / PRJ_BM, (N + PRJ_BN - 1) / PRJ_BN, 2);
  kv_project_kernel<<<grid, PRJ_THREADS, 0, stream>>>(x, wk, wv, k, v, M, Lk,
                                                      Ck, H, D);
  return cudaGetLastError();
}

}  // namespace mdk

extern "C" {

// x: (B, Lk, Ck) bf16; wk, wv: (H*D, Ck) nn.Linear layout;
// k, v: (B, H, Lk, D) bf16 workspaces
int mdk_kv_project(const void* x, const void* wk, const void* wv, void* k,
                   void* v, int B, int Lk, int Ck, int H, int D,
                   void* stream) {
  using mdk::bf16;
  return (int)mdk::launch_kv_project(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wk),
      static_cast<const bf16*>(wv), static_cast<bf16*>(k),
      static_cast<bf16*>(v), B, Lk, Ck, H, D,
      static_cast<cudaStream_t>(stream));
}

// xq: (B, Lq, C); wq: (H*D, C); k, v: (B, H, Lk, D) from mdk_kv_project;
// out: (B, Lq, H*D) bf16 at the logical head depth
int mdk_kvstat_attention(const void* xq, const void* wq, const void* k,
                         const void* v, void* out, int B, int Lq, int C,
                         int Lk, int H, int D, float scale, void* stream) {
  using mdk::bf16;
  return (int)mdk::launch_kvstat<1>(
      static_cast<const bf16*>(xq), static_cast<const bf16*>(wq),
      static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), B, Lq, C, Lk, H, D, scale, nullptr, 1,
      static_cast<cudaStream_t>(stream));
}

const char* mdk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
