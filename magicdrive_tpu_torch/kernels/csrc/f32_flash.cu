// The fp32 instances of K5 (flash forward with logsumexp) and K6 (the
// FlashAttention-2 backward, two launches) for Hopper (sm_90a).
//
// Replace the fp32 instances of magicdrive_tpu/kernels/flash_attention.py
// flash_attention's forward (_fwd_kernel) and backward (_bwd_dq_kernel,
// _bwd_dkv_kernel), which an fp32 run reaches in the backward of K1, K2, K8
// and the K8 pair (kernels/autograd.py recomputes q, k and v at the working
// dtype) and on the projected route. On (BH, L, D) fp32 tensors with q
// already scaled, keys at positions >= kv_len masked, and every cast point
// of the bf16 contract (flash_attention.cu) the identity:
//   K5: o = softmax(q k^T) v, lse = m + log l per row;
//   K6: p = exp(q k^T - lse), delta = rowsum(dO * O), ds = p (dO v^T -
//       delta); dq = ds k, dk = ds^T q, dv = p^T dO.
// The dq launch writes delta to a (BH, Lq) workspace that the dk/dv launch
// reads, and every output element is written by exactly one block: no
// atomics, so two calls are bitwise equal. dk and dv of masked keys are 0.
//
// Bound: at the training path's L=1400, D=40 the forward needs 4 Lq Lk D
// flops a (batch, head) row and the backward 2.5 times that, against
// O((Lq + Lk) D) bytes; at the 67 TFLOP/s fp32 rate the operations bind.
//
// Design, on f32_tile.cuh's FFMA tiles and attention core (4 warps a block,
// a warp owning its rows for the whole walk; 32-row streamed tiles at
// DP <= 48, 16-row tiles deeper):
//  * forward: a block owns BR q rows, its q tile copied once; f32::attend
//    streams the k/v tiles below kv_len. BR comes from the grid: of the two
//    geometries of FwdGeom (attend_ti rows a thread, or half as many in
//    more blocks an SM), the one whose grid over (BH, Lq) costs the least
//    on the card's busiest SM at its measured rate (fwd_geometry, on
//    f32_tile.cuh's sm_rounds); a row's arithmetic is the same in both, so
//    the output is too;
//  * dq: a block owns BR q rows (q and dO resident, lse and delta of its
//    rows in registers) and streams k/v tiles through a two-stage cp.async
//    ring: s = q k^T and dp = dO v^T against the stage's rows, ds through
//    the warp's tile, k^T transposed from the stage, dq += ds k; two
//    barriers a tile;
//  * dk/dv: a block owns BR keys (k and v resident) and streams q/dO tiles
//    with their lse and delta through the ring: s^T = k q^T and dp^T =
//    v dO^T, p then ds through the warp's tile as the A operand of dv +=
//    p^T dO and dk += ds^T q against the stage's transposed q and dO; two
//    barriers a tile (the warp's tile changes hands within the warp).
//    Deeper than 48 a thread owns 3 keys (two register blocks of 6 or 8
//    keys x D / 8 columns would not fit its registers).
#include "f32_tile.cuh"

namespace mdk {
namespace f32 {
namespace {

struct Args {
  const float *q, *k, *v, *o, *dout, *lse_in, *delta_in;
  float *o_out, *lse_out, *d0, *d1, *delta_out;
  int BH, Lq, Lk, D, kv_len;
};

// Blocks an SM the backward kernels are compiled for (their register
// blocks: s, dp and dq; or s^T, dp^T, dk and dv), and the k steps their
// products unroll (KU of fma_rows).
constexpr int BWD_MIN_BLOCKS = 2, BWD_KU = 2;

// Keys a thread of the dk/dv kernel owns (rows ty + 4 i, i < TI): two
// register blocks of 8 keys x D / 8 columns (dk and dv) at the shallow
// depths; deeper, blocks of 48 keys (3 a thread), which run three an SM up
// to DP = 80: the path's L = 350 in one wave of 48 x 8 blocks.
__host__ __device__ constexpr int dkv_ti(int DP) { return DP <= 48 ? 8 : 3; }
__host__ __device__ constexpr int dkv_min_blocks(int DP) {
  return DP > 48 && DP <= 80 ? 3 : BWD_MIN_BLOCKS;
}

// K5's geometry GI at depth instance DP: 0 the attention core's (attend_ti
// rows a thread, attend_min_blocks blocks an SM), 1 half as many rows a
// block, four blocks an SM where the shared memory holds them (else
// three), for grids that leave geometry 0's slots empty (the path's
// BH = 48, L = 350: 192 blocks of 96 rows on 396 slots; 384 of 48 rows).
// BLOCKS: the blocks an SM holds (launch bound and shared memory); EFF:
// the rate a full SM reaches, in percent of geometry 0's (chip_smoke.py
// ``fwd_rates``, NVIDIA H100 80GB HBM3 at 700 W: 89.4-89.5 at D = 40 for
// DP <= 48, 80.5-80.6 at D = 80 deeper).
constexpr int FWD_GEOMETRIES = 2;

template <int DP, int GI>
struct FwdGeom {
  static constexpr int TI = GI == 0 ? attend_ti(DP) : attend_ti(DP) / 2;
  static constexpr int BR = AttendGeom<DP, TI>::BR;
  static constexpr size_t BYTES = AttendSmem<DP, TI>::BYTES;
  static constexpr int MIN_BLOCKS =
      GI == 0 ? attend_min_blocks(DP)
              : smem_blocks(BYTES) < 4 ? smem_blocks(BYTES) : 4;
  static constexpr int BLOCKS =
      smem_blocks(BYTES) < MIN_BLOCKS ? smem_blocks(BYTES) : MIN_BLOCKS;
  static constexpr int EFF = GI == 0 ? 100 : DP <= 48 ? 89 : 81;
  static_assert(BLOCKS >= 1 && MIN_BLOCKS >= 1, "a block fits an SM");
};

template <int DP, int GI>
__global__ void __launch_bounds__(AttendGeom<DP>::NT,
                                  FwdGeom<DP, GI>::MIN_BLOCKS)
flash_fwd_f32_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int TI = FwdGeom<DP, GI>::TI;
  using G = AttendGeom<DP, TI>;
  const int q0 = blockIdx.x * G::BR;
  const long qb = (long)blockIdx.y * a.Lq * a.D;
  const long kb = (long)blockIdx.y * a.Lk * a.D;
  cp_rows<G::NT, G::BR, DP, G::LR>(smem + AttendSmem<DP, TI>::Q, a.q + qb,
                                   q0, a.Lq, a.D);
  cp_commit();  // awaited with attend's first stage
  float m[TI], l[TI], o[TI][G::TD];
  attend<DP, attend_ku<DP, TI>()>(smem, a.k + kb, a.v + kb, a.Lk, a.kv_len,
                                  a.D, m, l, o);
  const int arow = warp() * 4 * TI + lane_ty(), tx = lane_tx();
#pragma unroll
  for (int i = 0; i < TI; ++i) {
    const int r = q0 + arow + 4 * i;
    if (r >= a.Lq) continue;
    const float inv = 1.0f / l[i];
#pragma unroll
    for (int j = 0; j < G::TD; ++j) {
      const int d = tx + 8 * j;
      if (d < a.D) a.o_out[qb + (long)r * a.D + d] = o[i][j] * inv;
    }
    if (tx == 0) a.lse_out[(long)blockIdx.y * a.Lq + r] = m[i] + logf(l[i]);
  }
}

// Shared memory of the dq kernel (floats): q and dO [BR][LR], lse and delta
// [BR], the ring of k/v stages (two of [KT][LR] k rows then v rows), k^T
// [DP][LT] and the warps' ds tiles [W][4 TI][LP].
template <int DP>
struct DqSmem {
  using G = AttendGeom<DP>;
  static constexpr int Q = 0, DO = Q + G::BR * G::LR, LSE = DO + G::BR * G::LR,
                       DELTA = LSE + G::BR, RING = DELTA + G::BR,
                       STAGE = 2 * G::KT * G::LR, KTT = RING + 2 * STAGE,
                       DS = KTT + DP * G::LT,
                       FLOATS = DS + G::W * 4 * G::TI * G::LP;
  static constexpr size_t BYTES = sizeof(float) * FLOATS;
};

template <int DP>
__global__ void __launch_bounds__(AttendGeom<DP>::NT, BWD_MIN_BLOCKS)
flash_dq_f32_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  using G = AttendGeom<DP>;
  using S = DqSmem<DP>;
  constexpr int NT = G::NT, BR = G::BR, KT = G::KT, TI = G::TI, TJ = G::TJ,
                TD = G::TD;
  const int q0 = blockIdx.x * BR, D = a.D;
  const long qb = (long)blockIdx.y * a.Lq * D;
  const long kb = (long)blockIdx.y * a.Lk * D;
  const long rb = (long)blockIdx.y * a.Lq;
  const int arow = warp() * 4 * TI + lane_ty(), tx = lane_tx();
  cp_rows<NT, BR, DP, G::LR>(smem + S::Q, a.q + qb, q0, a.Lq, D);
  cp_rows<NT, BR, DP, G::LR>(smem + S::DO, a.dout + qb, q0, a.Lq, D);
  cp_kv_stage<DP>(smem + S::RING, a.k + kb, a.v + kb, 0, a.Lk, D);
  cp_commit();
  // delta = rowsum(dO * O): four threads a row, every fourth float4 each
  for (int r = threadIdx.x >> 2; r < BR; r += NT / 4) {
    const int part = threadIdx.x & 3;
    const bool in = q0 + r < a.Lq;
    float sum = 0.0f;
    if (in) {
      const float4* dor =
          reinterpret_cast<const float4*>(a.dout + qb + (long)(q0 + r) * D);
      const float4* orow =
          reinterpret_cast<const float4*>(a.o + qb + (long)(q0 + r) * D);
      for (int c = part; c < D / 4; c += 4) {
        const float4 x = __ldg(dor + c), y = __ldg(orow + c);
        sum += x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    if (part == 0) {
      smem[S::DELTA + r] = sum;
      smem[S::LSE + r] = in ? __ldg(a.lse_in + rb + q0 + r) : 0.0f;
      if (in) a.delta_out[rb + q0 + r] = sum;
    }
  }
  __syncthreads();  // the statistics are in
  float lse2[TI], delta[TI];
#pragma unroll
  for (int i = 0; i < TI; ++i) {
    lse2[i] = smem[S::LSE + arow + 4 * i] * LOG2E;
    delta[i] = smem[S::DELTA + arow + 4 * i];
  }
  const float* qa = smem + S::Q + arow * G::LR;
  const float* da = smem + S::DO + arow * G::LR;
  float* kt = smem + S::KTT;
  float* ds = smem + S::DS + warp() * 4 * TI * G::LP;
  float dq[TI][TD];
  zero(dq);
  const int T = (a.kv_len + KT - 1) / KT;
  for (int t = 0; t < T; ++t) {
    cp_wait<0>();
    __syncthreads();  // stage t is in; every thread is done with t - 1
    if (t + 1 < T)
      cp_kv_stage<DP>(smem + S::RING + ((t + 1) & 1) * S::STAGE, a.k + kb,
                      a.v + kb, (t + 1) * KT, a.Lk, D);
    cp_commit();
    const float* ks = smem + S::RING + (t & 1) * S::STAGE;
    transpose<NT, KT, DP, G::LR, G::LT>(kt, ks);
    float s[TI][TJ], dp[TI][TJ];
    zero(s);
    zero(dp);
    fma_rows<TI, TJ, TJ, 0, G::LR, G::LR, DP, BWD_KU>(s, qa, ks + tx * G::LR);
    fma_rows<TI, TJ, TJ, 0, G::LR, G::LR, DP, BWD_KU>(
        dp, da, ks + (KT + tx) * G::LR);
#pragma unroll
    for (int j = 0; j < TJ; ++j) {
      const bool key = t * KT + tx + 8 * j < a.kv_len;
#pragma unroll
      for (int i = 0; i < TI; ++i) {
        const float p = key ? exp2f(fmaf(s[i][j], LOG2E, -lse2[i])) : 0.0f;
        s[i][j] = p * (dp[i][j] - delta[i]);  // ds
      }
    }
    put_rows<TI, TJ, G::LP>(ds, s);
    __syncthreads();  // k^T is in (and the warp's ds)
    fma_rows<TI, TD, TD, 0, G::LP, G::LT, KT, BWD_KU>(
        dq, ds + lane_ty() * G::LP, kt + tx * G::LT);
  }
#pragma unroll
  for (int i = 0; i < TI; ++i) {
    const int r = q0 + arow + 4 * i;
    if (r >= a.Lq) continue;
#pragma unroll
    for (int j = 0; j < TD; ++j) {
      const int d = tx + 8 * j;
      if (d < D) a.d0[qb + (long)r * D + d] = dq[i][j];
    }
  }
}

// Shared memory of the dk/dv kernel (floats): k and v [BR][LR], the ring
// of q/dO stages (two of [KT][LR] q rows, dO rows, then KT lse and KT
// delta), q^T and dO^T [DP][LT] and the warps' p / ds tiles
// [W][4 TI][LP].
template <int DP>
struct DkvSmem {
  using G = AttnGeom<DP, dkv_ti(DP)>;
  static constexpr int K = 0, V = K + G::BR * G::LR, RING = V + G::BR * G::LR,
                       STAGE = 2 * G::KT * G::LR + 2 * G::KT,
                       QT = RING + 2 * STAGE, DOT = QT + DP * G::LT,
                       PB = DOT + DP * G::LT,
                       FLOATS = PB + G::W * 4 * G::TI * G::LP;
  static constexpr size_t BYTES = sizeof(float) * FLOATS;
};

template <int DP>
__global__ void __launch_bounds__(AttnGeom<DP, dkv_ti(DP)>::NT,
                                  dkv_min_blocks(DP))
flash_dkv_f32_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  using G = AttnGeom<DP, dkv_ti(DP)>;
  using S = DkvSmem<DP>;
  constexpr int NT = G::NT, BR = G::BR, KT = G::KT, TI = G::TI, TJ = G::TJ,
                TD = G::TD, LR = G::LR;
  const int j0 = blockIdx.x * BR, D = a.D;
  const long qb = (long)blockIdx.y * a.Lq * D;
  const long kb = (long)blockIdx.y * a.Lk * D;
  const long rb = (long)blockIdx.y * a.Lq;
  const int ty = lane_ty(), tx = lane_tx();
  const int arow = warp() * 4 * TI + ty;  // the thread's first key
  float dk[TI][TD], dv[TI][TD];
  zero(dk);
  zero(dv);
  if (j0 < a.kv_len) {  // a tile of masked keys only has zero gradients
    auto load = [&](int t) {
      float* st = smem + S::RING + (t & 1) * S::STAGE;
      cp_rows<NT, KT, DP, LR>(st, a.q + qb, t * KT, a.Lq, D);
      cp_rows<NT, KT, DP, LR>(st + KT * LR, a.dout + qb, t * KT, a.Lq, D);
      cp_vec<KT>(st + 2 * KT * LR, a.lse_in + rb, t * KT, a.Lq);
      cp_vec<KT>(st + 2 * KT * LR + KT, a.delta_in + rb, t * KT, a.Lq);
    };
    cp_rows<NT, BR, DP, LR>(smem + S::K, a.k + kb, j0, a.Lk, D);
    cp_rows<NT, BR, DP, LR>(smem + S::V, a.v + kb, j0, a.Lk, D);
    load(0);
    cp_commit();
    const float* ka = smem + S::K + arow * LR;
    const float* va = smem + S::V + arow * LR;
    float* qt = smem + S::QT;
    float* dot = smem + S::DOT;
    float* pb = smem + S::PB + warp() * 4 * TI * G::LP;
    const int T = (a.Lq + KT - 1) / KT;
    for (int t = 0; t < T; ++t) {
      cp_wait<0>();
      __syncthreads();  // stage t is in; every thread is done with t - 1
      if (t + 1 < T) load(t + 1);
      cp_commit();
      const float* qs = smem + S::RING + (t & 1) * S::STAGE;
      const float* dos = qs + KT * LR;
      const float* lse = qs + 2 * KT * LR;
      transpose<NT, KT, DP, LR, G::LT>(qt, qs);
      transpose<NT, KT, DP, LR, G::LT>(dot, dos);
      // s^T and dp^T: rows are the block's keys, columns the tile's q rows
      float st[TI][TJ], dpt[TI][TJ];
      zero(st);
      zero(dpt);
      fma_rows<TI, TJ, TJ, 0, LR, LR, DP, BWD_KU>(st, ka, qs + tx * LR);
      fma_rows<TI, TJ, TJ, 0, LR, LR, DP, BWD_KU>(dpt, va, dos + tx * LR);
#pragma unroll
      for (int j = 0; j < TJ; ++j) {
        const int c = tx + 8 * j;
        const bool row = t * KT + c < a.Lq;
        const float l2 = lse[c] * LOG2E, delta = lse[KT + c];
#pragma unroll
        for (int i = 0; i < TI; ++i) {
          const bool key = j0 + arow + 4 * i < a.kv_len;
          const float p =
              row && key ? exp2f(fmaf(st[i][j], LOG2E, -l2)) : 0.0f;
          st[i][j] = p;
          dpt[i][j] = p * (dpt[i][j] - delta);  // ds^T
        }
      }
      put_rows<TI, TJ, G::LP>(pb, st);
      __syncthreads();  // q^T and dO^T are in (and the warp's p)
      fma_rows<TI, TD, TD, 0, G::LP, G::LT, KT, BWD_KU>(dv, pb + ty * G::LP,
                                                       dot + tx * G::LT);
      __syncwarp();  // the warp is done with p
      put_rows<TI, TJ, G::LP>(pb, dpt);
      __syncwarp();
      fma_rows<TI, TD, TD, 0, G::LP, G::LT, KT, BWD_KU>(dk, pb + ty * G::LP,
                                                       qt + tx * G::LT);
    }
  }
#pragma unroll
  for (int i = 0; i < TI; ++i) {
    const int j = j0 + arow + 4 * i;
    if (j >= a.Lk) continue;
#pragma unroll
    for (int c = 0; c < TD; ++c) {
      const int d = tx + 8 * c;
      if (d < D) {
        a.d0[kb + (long)j * D + d] = dk[i][c];
        a.d1[kb + (long)j * D + d] = dv[i][c];
      }
    }
  }
}

enum class Op { kFwd, kDq, kDkv };

// The cost of K5's grid over (BH, Lq) in geometry GI: sm_rounds of its
// blocks, BLOCKS at once, each BR q rows, at the geometry's rate.
template <int DP, int GI>
double fwd_cost(int BH, int Lq, int sms) {
  using F = FwdGeom<DP, GI>;
  const long blocks = (long)BH * ((Lq + F::BR - 1) / F::BR);
  return sm_rounds(blocks, sms, F::BLOCKS) * F::BR * 100.0 / F::EFF;
}

// K5's geometry for the grid over (BH, Lq) on the current card: the
// cheaper by fwd_cost (0 at a tie); -1 when the card cannot be asked.
template <int DP>
int fwd_geometry(int BH, int Lq) {
  const int sms = card_sms();
  if (sms <= 0) return -1;
  return fwd_cost<DP, 1>(BH, Lq, sms) < fwd_cost<DP, 0>(BH, Lq, sms) ? 1 : 0;
}

// A kernel with its threads, rows a block and dynamic bytes; ``slot``
// numbers it among the depth's kernels (K5's geometries, then dq, dk/dv)
// for its shared memory's opt-in, once per device.
struct Launch {
  void (*kern)(Args);
  int threads, rows;
  size_t bytes;
  int slot;
};

// op's kernel at depth instance DP, K5's in geometry gi.
template <int DP>
Launch launch_of(Op op, int gi) {
  switch (op) {
    case Op::kFwd:
      if (gi == 1)
        return {flash_fwd_f32_kernel<DP, 1>, AttendGeom<DP>::NT,
                FwdGeom<DP, 1>::BR, FwdGeom<DP, 1>::BYTES, 1};
      return {flash_fwd_f32_kernel<DP, 0>, AttendGeom<DP>::NT,
              FwdGeom<DP, 0>::BR, FwdGeom<DP, 0>::BYTES, 0};
    case Op::kDq:
      return {flash_dq_f32_kernel<DP>, AttendGeom<DP>::NT,
              AttendGeom<DP>::BR, DqSmem<DP>::BYTES, FWD_GEOMETRIES};
    default:
      return {flash_dkv_f32_kernel<DP>, DkvSmem<DP>::G::NT,
              DkvSmem<DP>::G::BR, DkvSmem<DP>::BYTES, FWD_GEOMETRIES + 1};
  }
}

template <int DP>
cudaError_t opt_in(const Launch& l) {
  static unsigned opted_in[FWD_GEOMETRIES + 2] = {};
  return allow_smem_once(l.kern, l.bytes, opted_in[l.slot]);
}

// op's kernel at depth instance DP for the grid over (BH, Lq): K5's
// geometry from fwd_geometry; -1 in ``ok`` when the card cannot be asked.
template <int DP>
Launch launch_for(Op op, int BH, int Lq, bool& ok) {
  const int gi = op == Op::kFwd ? fwd_geometry<DP>(BH, Lq) : 0;
  ok = gi >= 0;
  return launch_of<DP>(op, gi < 0 ? 0 : gi);
}

template <int DP>
cudaError_t launch_dp(Op op, const Args& a, cudaStream_t stream) {
  bool ok = false;
  const Launch l = launch_for<DP>(op, a.BH, a.Lq, ok);
  if (!ok) return cudaErrorInvalidDevice;
  const cudaError_t e = opt_in<DP>(l);
  if (e != cudaSuccess) return e;
  const int rows = op == Op::kDkv ? a.Lk : a.Lq;
  const dim3 grid((rows + l.rows - 1) / l.rows, a.BH);
  l.kern<<<grid, l.threads, l.bytes, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t launch(Op op, const Args& a, cudaStream_t stream) {
  // rows of D floats are whole 16-byte vectors
  if (a.BH <= 0 || a.BH > 65535 || a.Lq <= 0 || a.Lk <= 0 || a.D <= 0 ||
      a.D > 128 || a.D % 8 || a.kv_len <= 0 || a.kv_len > a.Lk ||
      !aligned16({a.q, a.k, a.v, a.o, a.dout, a.o_out, a.d0, a.d1}))
    return cudaErrorInvalidValue;
#define MDK_FLASH_CASE(DPV) \
  case DPV:                 \
    return launch_dp<DPV>(op, a, stream);
  switch (depth_instance(a.D)) {
    MDK_F32_DEPTHS(MDK_FLASH_CASE)
    default:
      return cudaErrorInvalidValue;
  }
#undef MDK_FLASH_CASE
}

// The tile of op's kernel at depth D for the grid over (BH, Lq) (K5's
// choice; dq and dk/dv have one): what 0 the rows a block owns, 1 the rows
// of a streamed tile, 2 the blocks an SM holds (the card's occupancy for
// its registers and shared memory); -1 for what it does not take.
template <int DP>
int tile_of(Op op, int BH, int Lq, int what) {
  bool ok = false;
  const Launch l = launch_for<DP>(op, BH, Lq, ok);
  if (!ok) return -1;
  if (what == 0) return l.rows;
  if (what == 1)
    return op == Op::kDkv ? DkvSmem<DP>::G::KT : AttendGeom<DP>::KT;
  int blocks = -1;
  if (what != 2 || opt_in<DP>(l) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, l.kern,
                                                    l.threads, l.bytes) !=
          cudaSuccess)
    return -1;
  return blocks;
}

int tile(Op op, int BH, int Lq, int D, int what) {
  if (BH <= 0 || Lq <= 0) return -1;
#define MDK_TILE_CASE(DPV) \
  case DPV:                \
    return tile_of<DPV>(op, BH, Lq, what);
  switch (D > 0 && D % 8 == 0 ? depth_instance(D) : 0) {
    MDK_F32_DEPTHS(MDK_TILE_CASE)
    default:
      return -1;
  }
#undef MDK_TILE_CASE
}

}  // namespace
}  // namespace f32
}  // namespace mdk

extern "C" {

// q: (BH, Lq, D); k, v: (BH, Lk, D); o: (BH, Lq, D), all fp32 with D a
// multiple of 8 and 16-byte aligned; lse: (BH, Lq) fp32. Keys at positions
// >= kv_len are masked.
int mdk_flash_fwd_f32(const void* q, const void* k, const void* v, void* o,
                      void* lse, int BH, int Lq, int Lk, int D, int kv_len,
                      void* stream) {
  mdk::f32::Args a{};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.o_out = static_cast<float*>(o);
  a.lse_out = static_cast<float*>(lse);
  a.BH = BH, a.Lq = Lq, a.Lk = Lk, a.D = D, a.kv_len = kv_len;
  return (int)mdk::f32::launch(mdk::f32::Op::kFwd, a,
                               static_cast<cudaStream_t>(stream));
}

// q, o, dout, dq: (BH, Lq, D); k, v: (BH, Lk, D), all fp32; lse: (BH, Lq)
// from mdk_flash_fwd_f32; delta: (BH, Lq) out, rowsum(dout * o)
int mdk_flash_bwd_dq_f32(const void* q, const void* k, const void* v,
                         const void* o, const void* lse, const void* dout,
                         void* dq, void* delta, int BH, int Lq, int Lk, int D,
                         int kv_len, void* stream) {
  mdk::f32::Args a{};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.o = static_cast<const float*>(o);
  a.lse_in = static_cast<const float*>(lse);
  a.dout = static_cast<const float*>(dout);
  a.d0 = static_cast<float*>(dq);
  a.delta_out = static_cast<float*>(delta);
  a.BH = BH, a.Lq = Lq, a.Lk = Lk, a.D = D, a.kv_len = kv_len;
  return (int)mdk::f32::launch(mdk::f32::Op::kDq, a,
                               static_cast<cudaStream_t>(stream));
}

// q, dout: (BH, Lq, D); k, v, dk, dv: (BH, Lk, D), all fp32; lse and delta
// (from mdk_flash_bwd_dq_f32): (BH, Lq)
int mdk_flash_bwd_dkv_f32(const void* q, const void* k, const void* v,
                          const void* lse, const void* delta,
                          const void* dout, void* dk, void* dv, int BH,
                          int Lq, int Lk, int D, int kv_len, void* stream) {
  mdk::f32::Args a{};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.lse_in = static_cast<const float*>(lse);
  a.delta_in = static_cast<const float*>(delta);
  a.dout = static_cast<const float*>(dout);
  a.d0 = static_cast<float*>(dk);
  a.d1 = static_cast<float*>(dv);
  a.BH = BH, a.Lq = Lq, a.Lk = Lk, a.D = D, a.kv_len = kv_len;
  return (int)mdk::f32::launch(mdk::f32::Op::kDkv, a,
                               static_cast<cudaStream_t>(stream));
}

// The tile of the fp32 flash kernels at head depth D (a multiple of 8, at
// most 128) for a launch over BH (batch, head) rows of Lq q rows (the
// forward's geometry comes from that grid): op 0 the forward, 1 dq, 2
// dk/dv; what 0 the rows a block owns (q rows, keys for dk/dv), 1 the rows
// of a streamed tile, 2 the blocks an SM holds on the current card; -1 for
// anything else.
int mdk_flash_f32_tile(int op, int BH, int Lq, int D, int what) {
  if (op < 0 || op > 2) return -1;
  return mdk::f32::tile(static_cast<mdk::f32::Op>(op), BH, Lq, D, what);
}

}  // extern "C"
