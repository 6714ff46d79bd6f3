// The projection-fused attention core on register tiles, for Hopper
// (sm_90a), and the K1/K2 kernel built on it. K1 (kvstat_attention.cu) and
// K2 (kvstat_pair_attention.cu) run the core once per block, and so do K7
// (K1's launches), K8 (K1's, then the out-projection of
// fused_out_attention.cu) and the K8 pair (K2's, then the out-projection).
//
// proj_attend: one 64-row q tile of one (batch, head) on four warps, each
// owning 16 rows, from flash_tile.cuh's pieces:
//  1. q = bf16((x_q tile . Wq_h^T in fp32) * scale), the Pallas kernels'
//     cast point. The x_q rows and the head's D rows of Wq stream through a
//     three-stage cp.async ring of 32-wide C chunks; mma.sync accumulates in
//     fp32 registers, and the scaled C fragments become the A fragments of
//     q k^T (c_to_a). q never reaches shared or device memory.
//  2. For each of NSRC key/value sources, 64-key tiles of the (B, H, Lk, D)
//     bf16 workspace stream through a three-stage cp.async ring: only the D
//     real columns are copied, the pad columns [D, DP) are zeroed once per
//     buffer, and rows past Lk arrive as zeros with -inf logits. K2's two
//     sources are one stream of tiles, so the ring does not drain between
//     them. Logits, p and the o accumulator stay in registers: the
//     quad-shuffle online softmax with fp32 statistics, p cast to bf16 as the
//     A fragment of P.V, o rescaled in place.
//  3. Each source's o is divided by its own row sum in fp32. With NSRC == 2
//     the first source's normalised o is parked once in shared memory (each
//     thread its own fragment elements, so no barrier) and added in fp32 to
//     the second's before the one bf16 cast.
// The projection ring lies over k/v stages 1.., so the first k/v tile is in
// flight while q is projected.
#pragma once

#include "common.cuh"
#include "flash_tile.cuh"

namespace mdk {
namespace tile {

constexpr int PA_BQ = 64;       // q rows of a block: four warps of 16
constexpr int PA_BK = 64;       // keys of a k/v tile
constexpr int PA_KC = 32;       // C columns of a projection chunk
constexpr int PA_THREADS = 128;
constexpr int PA_STAGES = 3;    // k/v tiles in the ring
constexpr int PA_PSTAGES = 3;   // projection chunks in the ring

template <int DP, int NSRC>
struct ProjAttendSmem {
  static constexpr int LD = DP + 8;        // k/v tile pitch (bf16)
  static constexpr int LDX = PA_KC + 8;    // projection chunk pitch (bf16)
  static constexpr int TILE = PA_BK * LD;  // bf16 of a k or a v tile
  static constexpr size_t STAGE = 2 * sizeof(bf16) * TILE;  // k, then v
  static constexpr int CHUNK = (PA_BQ + DP) * LDX;  // x_q rows, then Wq rows
  static constexpr size_t PROJ = PA_PSTAGES * sizeof(bf16) * CHUNK;
  static constexpr size_t RING = PA_STAGES * STAGE > STAGE + PROJ
                                     ? PA_STAGES * STAGE
                                     : STAGE + PROJ;
  // NSRC == 2: the first source's normalised o, fp32, 64 rows x DP
  static constexpr size_t PARK = NSRC == 2 ? sizeof(float) * PA_BQ * DP : 0;
  static constexpr size_t BYTES = RING + PARK;
};

// o = the normalised attention output, in fp32 C fragments, of this warp's
// 16 rows of the q tile at row q0 (summed over the sources when NSRC == 2).
// xq: the batch's (Lq, C) rows; wq: the head's (D, C) rows of Wq; k_i, v_i:
// source i's (Lk, D) rows. C and D are multiples of 8, every row 16-byte
// aligned. Called by all PA_THREADS threads of the block.
template <int DP, int NSRC>
__device__ __forceinline__ void proj_attend(
    unsigned char* smem, const bf16* xq, const bf16* wq, const bf16* k0,
    const bf16* v0, const bf16* k1, const bf16* v1, int Lq, int C, int Lk,
    int D, float scale, int q0, float (&o)[DP / 8][4]) {
  using S = ProjAttendSmem<DP, NSRC>;
  constexpr int LD = S::LD, LDX = S::LDX;
  constexpr int NK = DP / 16, NO = DP / 8, NS = PA_BK / 8;
  bf16* ring = reinterpret_cast<bf16*>(smem);
  bf16* proj = ring + 2 * S::TILE;  // over k/v stages 1..
  const int warp = threadIdx.x / 32, t = threadIdx.x & 3;
  const int nt = (Lk + PA_BK - 1) / PA_BK;  // k/v tiles of one source
  const int n_tiles = NSRC * nt;
  const int nc = (C + PA_KC - 1) / PA_KC;   // projection chunks

  auto stage = [&](int it) { return ring + (it % PA_STAGES) * 2 * S::TILE; };
  auto load_kv = [&](int it) {
    const bool second = NSRC == 2 && it >= nt;
    const int kv0 = (second ? it - nt : it) * PA_BK;
    bf16* ks = stage(it);
    cp_rows<PA_BK, LD>(ks, second ? k1 : k0, kv0, Lk, D);
    cp_rows<PA_BK, LD>(ks + S::TILE, second ? v1 : v0, kv0, Lk, D);
  };
  // x_q rows q0.. (zeros past Lq), then Wq rows 0..DP-1 (zeros past D)
  auto load_chunk = [&](int c) {
    cp_chunk<PA_BQ, DP, PA_KC, LDX>(proj + (c % PA_PSTAGES) * S::CHUNK, xq,
                                    q0, Lq, wq, 0, D, c * PA_KC, C);
  };

  __syncthreads();  // a caller's loop: every warp is done with the last call
  zero_pad_cols<DP, LD>(ring, 2 * PA_BK, D);  // stage 0's k and v tiles
  load_kv(0);
  cp_commit();
  for (int c = 0; c < PA_PSTAGES - 1; ++c) {
    if (c < nc) load_chunk(c);
    cp_commit();
  }

  // ---- 1. q = x_q Wq^T in fp32 registers ----
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.0f;  // q's accumulator for now
  for (int c = 0; c < nc; ++c) {
    cp_wait<PA_PSTAGES - 2>();
    __syncthreads();  // chunk c landed; every warp is done with chunk c - 1
    if (c + PA_PSTAGES - 1 < nc) load_chunk(c + PA_PSTAGES - 1);
    cp_commit();
    const bf16* xs = proj + (c % PA_PSTAGES) * S::CHUNK;
    const bf16* ws = xs + PA_BQ * LDX;
#pragma unroll
    for (int kk = 0; kk < PA_KC / 16; ++kk) {
      uint32_t a[4];
      load_a<LDX>(a, xs, warp * 16, kk * 16);
#pragma unroll
      for (int n2 = 0; n2 < NK; ++n2) {
        uint32_t b[4];
        load_bt<LDX>(b, ws, n2 * 16, kk * 16);
        mma(o[2 * n2], a, b[0], b[1]);
        mma(o[2 * n2 + 1], a, b[2], b[3]);
      }
    }
  }
  uint32_t qf[NK][4];  // bf16(q * scale) as the A fragments of q k^T
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      o[2 * kk][e] *= scale;
      o[2 * kk + 1][e] *= scale;
    }
    c_to_a(qf[kk], o[2 * kk], o[2 * kk + 1]);
  }

  __syncthreads();  // every warp is done with the projection ring
#pragma unroll
  for (int i = 1; i < PA_STAGES; ++i)
    zero_pad_cols<DP, LD>(stage(i), 2 * PA_BK, D);
  for (int i = 1; i < PA_STAGES - 1; ++i) {
    if (i < n_tiles) load_kv(i);
    cp_commit();
  }

  // ---- 2. stream the k/v tiles of each source ----
  float m[2], l[2];
  auto restart = [&]() {
#pragma unroll
    for (int j = 0; j < NO; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = 0.0f;
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.0f;
  };
  // o /= the row sums over the quad, in fp32
  auto normalise = [&]() {
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) inv[r] = 1.0f / quad_sum(l[r]);
#pragma unroll
    for (int j = 0; j < NO; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] *= inv[e >> 1];
  };
  float* park = reinterpret_cast<float*>(smem + S::RING);  // NSRC == 2
  restart();
  for (int it = 0; it < n_tiles; ++it) {
    cp_wait<PA_STAGES - 2>();
    __syncthreads();  // tile it landed; every warp is done with tile it - 1
    if (it + PA_STAGES - 1 < n_tiles) load_kv(it + PA_STAGES - 1);
    cp_commit();
    const bf16* ks = stage(it);
    const bf16* vs = ks + S::TILE;

    // s = q k^T for the warp's 16 rows x 64 keys, fp32 in registers
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk)
#pragma unroll
      for (int j = 0; j < NS / 2; ++j) {
        uint32_t b[4];
        load_bt<LD>(b, ks, j * 16, kk * 16);
        mma(s[2 * j], qf[kk], b[0], b[1]);
        mma(s[2 * j + 1], qf[kk], b[2], b[3]);
      }
    const int kv0 = (NSRC == 2 && it >= nt ? it - nt : it) * PA_BK;
    if (kv0 + PA_BK > Lk) {
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (kv0 + j * 8 + 2 * t + (e & 1) >= Lk) s[j][e] = -INFINITY;
    }

    float alpha[2];
    online_softmax<NS>(s, m, l, alpha);
#pragma unroll
    for (int j = 0; j < NO; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] *= alpha[e >> 1];

    // o += bf16(p) v, p straight from the logit registers
#pragma unroll
    for (int kc = 0; kc < PA_BK / 16; ++kc) {
      uint32_t pa[4];
      c_to_a(pa, s[2 * kc], s[2 * kc + 1]);
#pragma unroll
      for (int n2 = 0; n2 < NO / 2; ++n2) {
        uint32_t b[4];
        load_b<LD>(b, vs, kc * 16, n2 * 16);
        mma(o[2 * n2], pa, b[0], b[1]);
        mma(o[2 * n2 + 1], pa, b[2], b[3]);
      }
    }

    if (NSRC == 2 && it == nt - 1) {  // the first source is done: park it
      normalise();
#pragma unroll
      for (int j = 0; j < NO; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          park[(j * 4 + e) * PA_THREADS + threadIdx.x] = o[j][e];
      restart();
    }
  }
  cp_wait<0>();

  // ---- 3. normalise, and add the parked first source ----
  normalise();
  if (NSRC == 2) {
#pragma unroll
    for (int j = 0; j < NO; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[j][e] += park[(j * 4 + e) * PA_THREADS + threadIdx.x];
  }
}

}  // namespace tile

// ---------------------------------------------------------------------------
// K1 (NSRC == 1) and K2 (NSRC == 2): grid (q tiles of 64 rows, H, B), one
// (batch, head, q tile) per block. K1's block reads the k/v workspace of its
// own batch b. K2's source i of batch b = (sample, view v) reads the
// workspace of view table[i][v] of the same sample, batch
// b - v + table[i][v]: table is the neighbour table, int32 [2][n_views] in
// device memory, whose entries the caller has checked to lie in
// [0, n_views). The nuScenes ring is the table (v + s_i) % n_views. The
// tile goes from registers to out (B, Lq, H*D) at the head's columns.
// ---------------------------------------------------------------------------

// Two blocks an SM allow 255 registers a thread; ptxas's own cap spilled
// K5's forward, whose register plan this kernel shares (flash_attention.cu).
template <int DP, int NSRC>
__global__ void __launch_bounds__(tile::PA_THREADS, 2)
kvstat_kernel(const bf16* __restrict__ xq, const bf16* __restrict__ wq,
              const bf16* __restrict__ kws, const bf16* __restrict__ vws,
              bf16* __restrict__ out, int Lq, int C, int Lk, int H, int D,
              float scale, const int* __restrict__ table, int n_views) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int q0 = blockIdx.x * tile::PA_BQ, h = blockIdx.y, b = blockIdx.z;
  auto head = [&](int i) {
    const int v = b % n_views;
    const int kb = NSRC == 1 ? b : b - v + __ldg(table + i * n_views + v);
    return ((long)kb * H + h) * Lk * D;
  };
  const long s0 = head(0), s1 = NSRC == 2 ? head(1) : s0;
  float o[DP / 8][4];
  tile::proj_attend<DP, NSRC>(smem, xq + (long)b * Lq * C,
                              wq + (long)h * D * C, kws + s0, vws + s0,
                              kws + s1, vws + s1, Lq, C, Lk, D, scale, q0, o);
  const float one[2] = {1.0f, 1.0f};
  tile::store_rows<DP / 8>(out + (long)b * Lq * H * D + (long)h * D, o, one,
                           q0 + (threadIdx.x / 32) * 16, Lq, D, (long)H * D);
}

template <int DP, int NSRC>
static cudaError_t launch_kvstat_dp(dim3 grid, const bf16* xq,
                                    const bf16* wq, const bf16* k,
                                    const bf16* v, bf16* out, int Lq, int C,
                                    int Lk, int H, int D, float scale,
                                    const int* table, int n_views,
                                    cudaStream_t stream) {
  auto kern = kvstat_kernel<DP, NSRC>;
  const size_t bytes = tile::ProjAttendSmem<DP, NSRC>::BYTES;
  const cudaError_t e = allow_smem(kern, bytes);
  if (e != cudaSuccess) return e;
  kern<<<grid, tile::PA_THREADS, bytes, stream>>>(
      xq, wq, k, v, out, Lq, C, Lk, H, D, scale, table, n_views);
  return cudaGetLastError();
}

template <int NSRC>
static cudaError_t launch_kvstat(const bf16* xq, const bf16* wq,
                                 const bf16* k, const bf16* v, bf16* out,
                                 int B, int Lq, int C, int Lk, int H, int D,
                                 float scale, const int* table,
                                 int n_views, cudaStream_t stream) {
  // rows of C and of D bf16 are whole 16-byte vectors for cp.async
  if (B <= 0 || B > 65535 || Lq <= 0 || Lk <= 0 || C <= 0 || C % 8 ||
      H <= 0 || H > 65535 || D <= 0 || D > 128 || D % 8 || n_views <= 0 ||
      B % n_views || (NSRC == 2 && table == nullptr) ||
      !aligned16({xq, wq, k, v, out}))
    return cudaErrorInvalidValue;
  const dim3 grid((Lq + tile::PA_BQ - 1) / tile::PA_BQ, H, B);
#define MDK_KVSTAT_CASE(DPV)                                                \
  case DPV:                                                                 \
    return launch_kvstat_dp<DPV, NSRC>(grid, xq, wq, k, v, out, Lq, C, Lk,  \
                                       H, D, scale, table, n_views,         \
                                       stream);
  switch ((D + 15) / 16 * 16) {
    MDK_KVSTAT_CASE(16)
    MDK_KVSTAT_CASE(32)
    MDK_KVSTAT_CASE(48)
    MDK_KVSTAT_CASE(64)
    MDK_KVSTAT_CASE(80)
    MDK_KVSTAT_CASE(96)
    MDK_KVSTAT_CASE(112)
    MDK_KVSTAT_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef MDK_KVSTAT_CASE
}

}  // namespace mdk
