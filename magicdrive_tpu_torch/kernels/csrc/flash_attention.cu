// K5 (flash forward with logsumexp) and K6 (FlashAttention-2 backward, two
// launches) for Hopper (sm_90a).
//
// K5 replaces magicdrive_tpu/kernels/flash_attention.py _fwd_kernel /
// _fwd_kernel_nk1 (launcher _flash_fwd): on (BH, L, D) bf16 tensors with q
// already scaled, o = softmax(q k^T) v with keys >= kv_len masked, fp32
// online softmax, p cast to bf16 before PV, o = acc / l (l = 0 guarded), and
// lse = m + log l per row in fp32.
// K6 replaces _bwd_dq_kernel and _bwd_dkv_kernel (launcher _flash_bwd):
// p = exp(q k^T - lse) and delta = rowsum(dO * O) in fp32,
// ds = p (dO v^T - delta); dq = sum_k ds k, dv = sum_q p^T dO,
// dk = sum_q ds^T q, each accumulated in fp32 with ds and p cast to bf16
// before the products. The dq launch computes delta once per row and writes
// it to a (BH, Lq) fp32 workspace that the dk/dv launch reads.
//
// The port runs them in the backward of K1, K2, K8 and the K8 pair
// (kernels/autograd.py), where q, k and v are recomputed from the saved
// hidden states.
//
// Bound: at the 224x400 level-0 shape (L=1400, D=40) each (batch*head)
// row of the forward does 4*Lq*Lk*D flops against 2*(Lq+2*Lk)*D bytes, and
// the backward 2.5x the forward's products; the logits never reach device
// memory, so the products bind. The (BH, L, 1) lse layout and the 128-lane
// padding of the TPU kernels are TPU layouts: lse is (BH, L) here, and the
// head depth (a multiple of 8) is padded to a multiple of 16 in shared
// memory only, with zeros written once.
//
// Design (FlashAttention-2's, flash_tile.cuh): four warps, each owning 16
// rows of the block's 64; mma.sync m16n8k16 bf16 -> fp32 on ldmatrix
// fragments; every logit, probability, dS and accumulator stays in
// registers, and the softmax statistics reduce over the four threads of a
// row. The streamed 64-row tiles come through a three-stage cp.async ring,
// so the next tiles are in flight while the tensor cores work, with one
// barrier per tile.
//  * forward: a block owns 64 q rows; Q fragments load once into
//    registers; k/v tiles stream; p turns into the A fragments of P.V in
//    registers; the o accumulator is rescaled in registers;
//  * dq: a block owns 64 q rows (Q and dO fragments in registers, lse and
//    delta per row in registers) and streams k/v tiles; dq += dS.K takes K
//    through ldmatrix.trans;
//  * dk/dv: a block owns 64 k rows, each warp 16 of them (K and V
//    fragments in registers up to a head depth of 80), and streams q tiles
//    with their lse and delta in the same ring stage; each warp computes
//    S^T = K.Q^T and dP^T = V.dO^T for its own keys, so p^T and dS^T are
//    the A fragments of dV += p^T.dO and dK += dS^T.Q, and no warp reads
//    another's.
// Every output element is written by exactly one block and no atomics are
// used, so the results are deterministic.
#include "common.cuh"
#include "flash_tile.cuh"

namespace mdk {
namespace {

constexpr int FB = 64;         // rows of a q tile and of a k/v tile
constexpr int FTHREADS = 128;  // four warps of 16 rows
constexpr int FSTAGES = 3;     // tiles in the copy ring
constexpr int FCH = 16;        // keys (dq) or q rows (dk/dv) per register step
// The forward and dq kernels ask for two blocks an SM, which allows 255
// registers a thread: with no block count ptxas capped some of their
// instances at 80 or 128 registers and spilled. The dk/dv kernel takes no
// block count: given one, ptxas spent up to 255 registers and spilled at
// DP = 128, and without one it spills at no DP.
constexpr int FMIN_BLOCKS = 2;

template <int DP>
struct FlashTiles {
  static constexpr int LD = DP + 8;
  static constexpr int TILE = FB * LD;  // bf16 elements of one tile
  static constexpr size_t TILE_BYTES = sizeof(bf16) * TILE;
  // forward: the q tile, then the ring of (k, v) tiles
  static constexpr size_t FWD = TILE_BYTES * (1 + 2 * FSTAGES);
  // dq: the q and dO tiles, the ring of (k, v), then the block's delta
  static constexpr size_t DQ = TILE_BYTES * (2 + 2 * FSTAGES) +
                               sizeof(float) * FB;
  // dk/dv: the k and v tiles, then the ring of (q, dO, lse, delta)
  static constexpr size_t DKV_STAGE = 2 * TILE_BYTES + 2 * sizeof(float) * FB;
  static constexpr size_t DKV = 2 * TILE_BYTES + FSTAGES * DKV_STAGE;
};

template <int N>
__device__ __forceinline__ void zero(float (&c)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.0f;
}

// ---------------------------------------------------------------------------
// K5: forward with lse
// ---------------------------------------------------------------------------

template <int DP>
__global__ void __launch_bounds__(FTHREADS, FMIN_BLOCKS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, int Lq, int Lk, int D,
                 int kv_len) {
  using T = FlashTiles<DP>;
  constexpr int LD = T::LD, NK = DP / 16, NO = DP / 8, NS = FB / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ring = qs + T::TILE;  // stage i: k at ring + 2 i TILE, v after it

  const int q0 = blockIdx.x * FB;
  const long bh = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = lane & 3;
  const bf16* kb = k + bh * Lk * D;
  const bf16* vb = v + bh * Lk * D;
  const int n_tiles = (kv_len + FB - 1) / FB;
  auto load_kv = [&](int it) {
    bf16* ks = ring + (it % FSTAGES) * 2 * T::TILE;
    tile::cp_rows<FB, LD>(ks, kb, it * FB, kv_len, D);
    tile::cp_rows<FB, LD>(ks + T::TILE, vb, it * FB, kv_len, D);
  };

  tile::zero_pad_cols<DP, LD>(qs, FB * (1 + 2 * FSTAGES), D);
  tile::cp_rows<FB, LD>(qs, q + bh * Lq * D, q0, Lq, D);
  for (int i = 0; i < FSTAGES - 1; ++i) {
    if (i < n_tiles) load_kv(i);
    tile::cp_commit();
  }

  uint32_t qf[NK][4];
  float acc[NO][4];
  zero(acc);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  for (int it = 0; it < n_tiles; ++it) {
    tile::cp_wait<FSTAGES - 2>();
    __syncthreads();  // tile it landed; every warp is done with tile it - 1
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < NK; ++kk)
        tile::load_a<LD>(qf[kk], qs, warp * 16, kk * 16);
    }
    if (it + FSTAGES - 1 < n_tiles) load_kv(it + FSTAGES - 1);
    tile::cp_commit();
    const bf16* ks = ring + (it % FSTAGES) * 2 * T::TILE;
    const bf16* vs = ks + T::TILE;

    // s = q k^T for the warp's 16 rows x 64 keys, fp32 in registers
    float s[NS][4];
    zero(s);
#pragma unroll
    for (int kk = 0; kk < NK; ++kk)
#pragma unroll
      for (int j = 0; j < NS / 2; ++j) {
        uint32_t b[4];
        tile::load_bt<LD>(b, ks, j * 16, kk * 16);
        tile::mma(s[2 * j], qf[kk], b[0], b[1]);
        tile::mma(s[2 * j + 1], qf[kk], b[2], b[3]);
      }
    const int kv0 = it * FB;
    if (kv0 + FB > kv_len) {
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (kv0 + j * 8 + 2 * t + (e & 1) >= kv_len) s[j][e] = -INFINITY;
    }

    float alpha[2];
    tile::online_softmax<NS>(s, m, l, alpha);
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // o += bf16(p) v, p straight from the logit registers
#pragma unroll
    for (int kc = 0; kc < FB / 16; ++kc) {
      uint32_t pa[4];
      tile::c_to_a(pa, s[2 * kc], s[2 * kc + 1]);
#pragma unroll
      for (int n2 = 0; n2 < NO / 2; ++n2) {
        uint32_t b[4];
        tile::load_b<LD>(b, vs, kc * 16, n2 * 16);
        tile::mma(acc[2 * n2], pa, b[0], b[1]);
        tile::mma(acc[2 * n2 + 1], pa, b[2], b[3]);
      }
    }
  }
  tile::cp_wait<0>();

  // o = acc / l (l = 0 guarded), lse = m + log l
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = tile::quad_sum(l[r]);
    if (l[r] == 0.0f) l[r] = 1.0f;
    inv[r] = 1.0f / l[r];
  }
  const int row0 = q0 + warp * 16;
  tile::store_rows<NO>(o + bh * Lq * D, acc, inv, row0, Lq, D, D);
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + lane / 4 + 8 * r;
      if (row < Lq) lse[bh * Lq + row] = m[r] + logf(l[r]);
    }
  }
}

// ---------------------------------------------------------------------------
// K6 (1 of 2): delta and dq, one block per 64 q rows streaming k/v tiles
// ---------------------------------------------------------------------------

template <int DP>
__global__ void __launch_bounds__(FTHREADS, FMIN_BLOCKS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ o,
                    const float* __restrict__ lse,
                    const bf16* __restrict__ dout, bf16* __restrict__ dq,
                    float* __restrict__ delta, int Lq, int Lk, int D,
                    int kv_len) {
  using T = FlashTiles<DP>;
  constexpr int LD = T::LD, NK = DP / 16, NO = DP / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* dos = qs + T::TILE;
  bf16* ring = dos + T::TILE;  // stage i: k at ring + 2 i TILE, v after it
  float* delta_s = reinterpret_cast<float*>(ring + 2 * FSTAGES * T::TILE);

  const int q0 = blockIdx.x * FB;
  const long bh = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const bf16* kb = k + bh * Lk * D;
  const bf16* vb = v + bh * Lk * D;
  const int n_tiles = (kv_len + FB - 1) / FB;
  auto load_kv = [&](int it) {
    bf16* ks = ring + (it % FSTAGES) * 2 * T::TILE;
    tile::cp_rows<FB, LD>(ks, kb, it * FB, kv_len, D);
    tile::cp_rows<FB, LD>(ks + T::TILE, vb, it * FB, kv_len, D);
  };

  tile::zero_pad_cols<DP, LD>(qs, FB * (2 + 2 * FSTAGES), D);
  tile::cp_rows<FB, LD>(qs, q + bh * Lq * D, q0, Lq, D);
  tile::cp_rows<FB, LD>(dos, dout + bh * Lq * D, q0, Lq, D);
  for (int i = 0; i < FSTAGES - 1; ++i) {
    if (i < n_tiles) load_kv(i);
    tile::cp_commit();
  }

  // delta = rowsum(dO * O) in fp32 while the copies fly: two threads a row,
  // 16-byte loads; written once for the dk/dv launch
  {
    const int r = threadIdx.x / 2, half = threadIdx.x % 2;
    const int row = q0 + r;
    float d = 0.0f;
    if (row < Lq) {
      const bf16* orow = o + (bh * Lq + row) * D;
      const bf16* drow = dout + (bh * Lq + row) * D;
      for (int c = half * 8; c < D; c += 16) {
        const uint4 ov = *reinterpret_cast<const uint4*>(orow + c);
        const uint4 dv = *reinterpret_cast<const uint4*>(drow + c);
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 a = __bfloat1622float2(o2[i]);
          const float2 b = __bfloat1622float2(d2[i]);
          d += a.x * b.x + a.y * b.y;
        }
      }
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    if (half == 0) {
      delta_s[r] = d;
      if (row < Lq) delta[bh * Lq + row] = d;
    }
  }
  const int row0 = q0 + warp * 16;
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    lse_r[r] = row < Lq ? lse[bh * Lq + row] : 0.0f;
  }

  uint32_t qf[NK][4], dof[NK][4];
  float acc[NO][4];
  zero(acc);
  for (int it = 0; it < n_tiles; ++it) {
    tile::cp_wait<FSTAGES - 2>();
    __syncthreads();  // tile it landed; every warp is done with tile it - 1
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        tile::load_a<LD>(qf[kk], qs, warp * 16, kk * 16);
        tile::load_a<LD>(dof[kk], dos, warp * 16, kk * 16);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) delta_r[r] = delta_s[warp * 16 + g + 8 * r];
    }
    if (it + FSTAGES - 1 < n_tiles) load_kv(it + FSTAGES - 1);
    tile::cp_commit();
    const bf16* ks = ring + (it % FSTAGES) * 2 * T::TILE;
    const bf16* vs = ks + T::TILE;
    const int kv0 = it * FB;

#pragma unroll
    for (int c = 0; c < FB / FCH; ++c) {
      // s = q k^T and dp = dO v^T for 16 keys
      float s[2][4], dp[2][4];
      zero(s);
      zero(dp);
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        uint32_t b[4];
        tile::load_bt<LD>(b, ks, c * FCH, kk * 16);
        tile::mma(s[0], qf[kk], b[0], b[1]);
        tile::mma(s[1], qf[kk], b[2], b[3]);
        tile::load_bt<LD>(b, vs, c * FCH, kk * 16);
        tile::mma(dp[0], dof[kk], b[0], b[1]);
        tile::mma(dp[1], dof[kk], b[2], b[3]);
      }
      // ds = p (dp - delta), p = exp(s - lse), 0 at keys >= kv_len
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kv0 + c * FCH + j * 8 + 2 * t + (e & 1);
          const float p =
              key < kv_len ? __expf(s[j][e] - lse_r[e >> 1]) : 0.0f;
          s[j][e] = p * (dp[j][e] - delta_r[e >> 1]);
        }
      // dq += bf16(ds) k
      uint32_t da[4];
      tile::c_to_a(da, s[0], s[1]);
#pragma unroll
      for (int n2 = 0; n2 < NO / 2; ++n2) {
        uint32_t b[4];
        tile::load_b<LD>(b, ks, c * FCH, n2 * 16);
        tile::mma(acc[2 * n2], da, b[0], b[1]);
        tile::mma(acc[2 * n2 + 1], da, b[2], b[3]);
      }
    }
  }
  tile::cp_wait<0>();
  const float one[2] = {1.0f, 1.0f};
  tile::store_rows<NO>(dq + bh * Lq * D, acc, one, row0, Lq, D, D);
}

// ---------------------------------------------------------------------------
// K6 (2 of 2): dk and dv, one block per 64 k rows streaming q tiles
// ---------------------------------------------------------------------------

template <int DP>
__global__ void __launch_bounds__(FTHREADS)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const bf16* __restrict__ dout, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int Lq, int Lk, int D,
                     int kv_len) {
  using T = FlashTiles<DP>;
  constexpr int LD = T::LD, NK = DP / 16, NO = DP / 8;
  // the K and V fragments stay in registers up to DP = 80; deeper heads
  // reload them from the resident tiles, which keeps the accumulators of
  // dK and dV out of local memory
  constexpr bool KV_REGS = DP <= 80;
  constexpr int NKR = KV_REGS ? NK : 1;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + T::TILE;
  unsigned char* ring = smem + 2 * T::TILE_BYTES;
  // stage i: q tile, dO tile, then FB lse and FB delta values
  auto stage_q = [&](int it) {
    return reinterpret_cast<bf16*>(ring + (it % FSTAGES) * T::DKV_STAGE);
  };

  const int k0 = blockIdx.x * FB;
  const long bh = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int kw0 = k0 + warp * 16;  // this warp's keys
  const bf16* qb = q + bh * Lq * D;
  const bf16* dob = dout + bh * Lq * D;
  // keys past kv_len get zero gradients: such a block streams nothing
  const int n_tiles = k0 < kv_len ? (Lq + FB - 1) / FB : 0;
  auto load_q = [&](int it) {
    bf16* qs = stage_q(it);
    float* rs = reinterpret_cast<float*>(qs + 2 * T::TILE);
    tile::cp_rows<FB, LD>(qs, qb, it * FB, Lq, D);
    tile::cp_rows<FB, LD>(qs + T::TILE, dob, it * FB, Lq, D);
    tile::cp_vec<FB>(rs, lse + bh * Lq, it * FB, Lq);
    tile::cp_vec<FB>(rs + FB, delta + bh * Lq, it * FB, Lq);
  };

  tile::zero_pad_cols<DP, LD>(ks, 2 * FB, D);
#pragma unroll
  for (int i = 0; i < FSTAGES; ++i)
    tile::zero_pad_cols<DP, LD>(stage_q(i), 2 * FB, D);
  tile::cp_rows<FB, LD>(ks, k + bh * Lk * D, k0, kv_len, D);
  tile::cp_rows<FB, LD>(vs, v + bh * Lk * D, k0, kv_len, D);
  for (int i = 0; i < FSTAGES - 1; ++i) {
    if (i < n_tiles) load_q(i);
    tile::cp_commit();
  }

  uint32_t kf[NKR][4], vf[NKR][4];
  float dk_acc[NO][4], dv_acc[NO][4];
  zero(dk_acc);
  zero(dv_acc);
  for (int it = 0; it < n_tiles; ++it) {
    tile::cp_wait<FSTAGES - 2>();
    __syncthreads();  // tile it landed; every warp is done with tile it - 1
    if (KV_REGS && it == 0) {
#pragma unroll
      for (int kk = 0; kk < NKR; ++kk) {
        tile::load_a<LD>(kf[kk], ks, warp * 16, kk * 16);
        tile::load_a<LD>(vf[kk], vs, warp * 16, kk * 16);
      }
    }
    if (it + FSTAGES - 1 < n_tiles) load_q(it + FSTAGES - 1);
    tile::cp_commit();
    const bf16* qs = stage_q(it);
    const bf16* dos = qs + T::TILE;
    const float* lse_s = reinterpret_cast<const float*>(qs + 2 * T::TILE);
    const float* delta_s = lse_s + FB;
    const int qt0 = it * FB;

#pragma unroll
    for (int c = 0; c < FB / FCH; ++c) {
      // s^T = k q^T and dp^T = v dO^T for the warp's 16 keys x 16 q rows
      float st[2][4], dpt[2][4];
      zero(st);
      zero(dpt);
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        uint32_t ka[4], va[4], b[4];
        if constexpr (KV_REGS) {
#pragma unroll
          for (int e = 0; e < 4; ++e) ka[e] = kf[kk][e], va[e] = vf[kk][e];
        } else {
          tile::load_a<LD>(ka, ks, warp * 16, kk * 16);
          tile::load_a<LD>(va, vs, warp * 16, kk * 16);
        }
        tile::load_bt<LD>(b, qs, c * FCH, kk * 16);
        tile::mma(st[0], ka, b[0], b[1]);
        tile::mma(st[1], ka, b[2], b[3]);
        tile::load_bt<LD>(b, dos, c * FCH, kk * 16);
        tile::mma(dpt[0], va, b[0], b[1]);
        tile::mma(dpt[1], va, b[2], b[3]);
      }
      // p^T = exp(s^T - lse), ds^T = p^T (dp^T - delta), by q column;
      // 0 at keys >= kv_len and q rows >= Lq
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = c * FCH + j * 8 + 2 * t + (e & 1);
          const bool ok = kw0 + g + 8 * (e >> 1) < kv_len && qt0 + qc < Lq;
          const float p = ok ? __expf(st[j][e] - lse_s[qc]) : 0.0f;
          dpt[j][e] = p * (dpt[j][e] - delta_s[qc]);
          st[j][e] = p;
        }
      // dv += bf16(p^T) dO, dk += bf16(ds^T) q
      uint32_t pa[4], da[4];
      tile::c_to_a(pa, st[0], st[1]);
      tile::c_to_a(da, dpt[0], dpt[1]);
#pragma unroll
      for (int n2 = 0; n2 < NO / 2; ++n2) {
        uint32_t b[4];
        tile::load_b<LD>(b, dos, c * FCH, n2 * 16);
        tile::mma(dv_acc[2 * n2], pa, b[0], b[1]);
        tile::mma(dv_acc[2 * n2 + 1], pa, b[2], b[3]);
        tile::load_b<LD>(b, qs, c * FCH, n2 * 16);
        tile::mma(dk_acc[2 * n2], da, b[0], b[1]);
        tile::mma(dk_acc[2 * n2 + 1], da, b[2], b[3]);
      }
    }
  }
  tile::cp_wait<0>();
  const float one[2] = {1.0f, 1.0f};
  tile::store_rows<NO>(dk + bh * Lk * D, dk_acc, one, kw0, Lk, D, D);
  tile::store_rows<NO>(dv + bh * Lk * D, dv_acc, one, kw0, Lk, D, D);
}

// ---------------------------------------------------------------------------

enum class FlashOp { kFwd, kDq, kDkv };

struct FlashArgs {
  const bf16 *q, *k, *v, *o, *dout;
  const float *lse_in, *delta_in;
  bf16 *o_out, *d0, *d1;
  float *lse_out, *delta_out;
  int BH, Lq, Lk, D, kv_len;
};

template <typename Kernel, typename... Args>
static cudaError_t launch(Kernel kern, dim3 grid, size_t bytes,
                          cudaStream_t stream, Args... args) {
  const cudaError_t e = allow_smem(kern, bytes);
  if (e != cudaSuccess) return e;
  kern<<<grid, FTHREADS, bytes, stream>>>(args...);
  return cudaGetLastError();
}

template <int DP>
static cudaError_t launch_flash_dp(FlashOp op, const FlashArgs& a,
                                   cudaStream_t stream) {
  using T = FlashTiles<DP>;
  const int rows = op == FlashOp::kDkv ? a.Lk : a.Lq;
  const dim3 grid((rows + FB - 1) / FB, a.BH);
  switch (op) {
    case FlashOp::kFwd:
      return launch(flash_fwd_kernel<DP>, grid, T::FWD, stream, a.q, a.k,
                    a.v, a.o_out, a.lse_out, a.Lq, a.Lk, a.D, a.kv_len);
    case FlashOp::kDq:
      return launch(flash_bwd_dq_kernel<DP>, grid, T::DQ, stream, a.q, a.k,
                    a.v, a.o, a.lse_in, a.dout, a.d0, a.delta_out, a.Lq,
                    a.Lk, a.D, a.kv_len);
    default:
      return launch(flash_bwd_dkv_kernel<DP>, grid, T::DKV, stream, a.q,
                    a.k, a.v, a.lse_in, a.delta_in, a.dout, a.d0, a.d1,
                    a.Lq, a.Lk, a.D, a.kv_len);
  }
}

static cudaError_t launch_flash(FlashOp op, const FlashArgs& a,
                                cudaStream_t stream) {
  // rows of D bf16 are whole 16-byte vectors for cp.async
  if (a.BH <= 0 || a.BH > 65535 || a.Lq <= 0 || a.Lk <= 0 || a.D <= 0 ||
      a.D > 128 || a.D % 8 || a.kv_len <= 0 || a.kv_len > a.Lk ||
      !aligned16({a.q, a.k, a.v, a.o, a.dout, a.o_out, a.d0, a.d1}))
    return cudaErrorInvalidValue;
  switch ((a.D + 15) / 16 * 16) {
    case 16:
      return launch_flash_dp<16>(op, a, stream);
    case 32:
      return launch_flash_dp<32>(op, a, stream);
    case 48:
      return launch_flash_dp<48>(op, a, stream);
    case 64:
      return launch_flash_dp<64>(op, a, stream);
    case 80:
      return launch_flash_dp<80>(op, a, stream);
    case 96:
      return launch_flash_dp<96>(op, a, stream);
    case 112:
      return launch_flash_dp<112>(op, a, stream);
    case 128:
      return launch_flash_dp<128>(op, a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace mdk

extern "C" {

// q: (BH, Lq, D); k, v: (BH, Lk, D); o: (BH, Lq, D), all bf16 with D a
// multiple of 8 and 16-byte aligned; lse: (BH, Lq) fp32. Keys at positions
// >= kv_len are masked.
int mdk_flash_fwd(const void* q, const void* k, const void* v, void* o,
                  void* lse, int BH, int Lq, int Lk, int D, int kv_len,
                  void* stream) {
  using mdk::bf16;
  mdk::FlashArgs a{};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.o_out = static_cast<bf16*>(o);
  a.lse_out = static_cast<float*>(lse);
  a.BH = BH, a.Lq = Lq, a.Lk = Lk, a.D = D, a.kv_len = kv_len;
  return (int)mdk::launch_flash(mdk::FlashOp::kFwd, a,
                                static_cast<cudaStream_t>(stream));
}

// q, o, dout, dq: (BH, Lq, D); k, v: (BH, Lk, D), all bf16; lse: (BH, Lq)
// fp32 from mdk_flash_fwd; delta: (BH, Lq) fp32 out, rowsum(dout * o)
int mdk_flash_bwd_dq(const void* q, const void* k, const void* v,
                     const void* o, const void* lse, const void* dout,
                     void* dq, void* delta, int BH, int Lq, int Lk, int D,
                     int kv_len, void* stream) {
  using mdk::bf16;
  mdk::FlashArgs a{};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.o = static_cast<const bf16*>(o);
  a.lse_in = static_cast<const float*>(lse);
  a.dout = static_cast<const bf16*>(dout);
  a.d0 = static_cast<bf16*>(dq);
  a.delta_out = static_cast<float*>(delta);
  a.BH = BH, a.Lq = Lq, a.Lk = Lk, a.D = D, a.kv_len = kv_len;
  return (int)mdk::launch_flash(mdk::FlashOp::kDq, a,
                                static_cast<cudaStream_t>(stream));
}

// q, dout: (BH, Lq, D); k, v, dk, dv: (BH, Lk, D), all bf16; lse and delta
// (from mdk_flash_bwd_dq): (BH, Lq) fp32
int mdk_flash_bwd_dkv(const void* q, const void* k, const void* v,
                      const void* lse, const void* delta, const void* dout,
                      void* dk, void* dv, int BH, int Lq, int Lk, int D,
                      int kv_len, void* stream) {
  using mdk::bf16;
  mdk::FlashArgs a{};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.lse_in = static_cast<const float*>(lse);
  a.delta_in = static_cast<const float*>(delta);
  a.dout = static_cast<const bf16*>(dout);
  a.d0 = static_cast<bf16*>(dk);
  a.d1 = static_cast<bf16*>(dv);
  a.BH = BH, a.Lq = Lq, a.Lk = Lk, a.D = D, a.kv_len = kv_len;
  return (int)mdk::launch_flash(mdk::FlashOp::kDkv, a,
                                static_cast<cudaStream_t>(stream));
}

}  // extern "C"
