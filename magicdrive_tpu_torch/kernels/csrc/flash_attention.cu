// K5 (flash forward with logsumexp) and K6 (FlashAttention-2 backward, two
// launches) for Hopper (sm_90a).
//
// K5 replaces magicdrive_tpu/kernels/flash_attention.py _fwd_kernel /
// _fwd_kernel_nk1 (launcher _flash_fwd): on (BH, L, D) bf16 tensors with q
// already scaled, o = softmax(q k^T) v with keys >= kv_len masked, fp32
// online softmax, p cast to bf16 before PV, o = acc / l (l = 0 guarded), and
// lse = m + log l per row in fp32.
// K6 replaces _bwd_dq_kernel and _bwd_dkv_kernel (launcher _flash_bwd):
// p = exp(q k^T - lse), delta = rowsum(dO * O) computed in the kernel,
// ds = p (dO v^T - delta); dq = sum_k ds k, dv = sum_q p^T dO,
// dk = sum_q ds^T q, each accumulated in fp32 with ds and p cast to bf16
// before the products.
//
// The port runs them in the backward of K1 and K2 (kernels/autograd.py),
// where q, k and v are recomputed from the saved hidden states.
//
// Bound: at the 224x400 level-0 shape (L=1400, D=40) each (batch*head)
// row of the forward does 4*Lq*Lk*D flops against 2*(Lq+2*Lk)*D bytes, and
// the backward 2.5x the forward's products; the logits never reach device
// memory. The (BH, L, 1) lse layout and the 128-lane padding of the TPU
// kernels are TPU layouts: lse is (BH, L) here, and the head depth is padded
// to a multiple of 16 in shared memory only (zeros), as in K1.
//
// Design: one block of four warps per 64-row tile, WMMA m16n16k16 bf16 with
// fp32 accumulation (common.cuh), statistics in fp32.
//  * forward: a block owns 64 q rows (16 per warp) and streams 64-row k/v
//    tiles, as K1's attention core does after its q projection;
//  * dq: a block owns 64 q rows and streams k/v tiles; each warp keeps its
//    16 rows' dq accumulators in registers;
//  * dk/dv: a block owns 64 k rows and streams q tiles; p and ds of a q
//    tile are built row-wise (16 q rows per warp) in shared memory, then
//    each warp multiplies their transposes into the dk and dv accumulators
//    of its 16 k rows, kept in registers.
// Every output element is written by exactly one block and no atomics are
// used, so the results are deterministic.
#include "common.cuh"

namespace mdk {

constexpr int FA_B = 64;  // rows of a q tile and of a k/v tile
constexpr int FA_THREADS = 128;

// col-major A operand: element (i, j) at j*ld + i, i.e. the transpose of a
// row-major tile
using FragAt =
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;

template <int DP>
struct FlashLayout {
  static constexpr int LDT = DP + 8;     // bf16 q/k/v/dO tiles
  static constexpr int LDS = FA_B + 4;   // fp32 logits tiles
  static constexpr int LDP = FA_B + 8;   // bf16 p / ds tiles
  static constexpr int LDO = DP + 4;     // fp32 output staging
  static constexpr size_t T0 = 0;
  static constexpr size_t T1 = align128(T0 + sizeof(bf16) * FA_B * LDT);
  static constexpr size_t T2 = align128(T1 + sizeof(bf16) * FA_B * LDT);
  static constexpr size_t T3 = align128(T2 + sizeof(bf16) * FA_B * LDT);
  static constexpr size_t S0 = align128(T3 + sizeof(bf16) * FA_B * LDT);
  static constexpr size_t S1 = align128(S0 + sizeof(float) * FA_B * LDS);
  static constexpr size_t P0 = align128(S1 + sizeof(float) * FA_B * LDS);
  static constexpr size_t P1 = align128(P0 + sizeof(bf16) * FA_B * LDP);
  static constexpr size_t OS = align128(P1 + sizeof(bf16) * FA_B * LDP);
  static constexpr size_t RW = align128(OS + sizeof(float) * FA_B * LDO);
  // two per-row fp32 vectors (lse, delta)
  static constexpr size_t BYTES = align128(RW + sizeof(float) * 2 * FA_B);
};

// C (16 x 64 fp32, row-major at dst) = A rows [r0, r0+16) of a (64, DP) bf16
// tile times the transpose of a (64, DP) bf16 tile
template <int DP>
static __device__ __forceinline__ void rows_times_t(float* dst, int ldd,
                                                    const bf16* a,
                                                    const bf16* b, int r0) {
  constexpr int LDT = FlashLayout<DP>::LDT;
#pragma unroll
  for (int j = 0; j < FA_B / 16; ++j) {
    FragC c;
    wmma::fill_fragment(c, 0.0f);
#pragma unroll
    for (int kk = 0; kk < DP; kk += 16) {
      FragA fa;
      FragBt fb;
      wmma::load_matrix_sync(fa, a + r0 * LDT + kk, LDT);
      wmma::load_matrix_sync(fb, b + j * 16 * LDT + kk, LDT);
      wmma::mma_sync(c, fa, fb, c);
    }
    wmma::store_matrix_sync(dst + r0 * ldd + j * 16, c, ldd,
                            wmma::mem_row_major);
  }
}

// Write the 16 rows [r0, r0+16) of an fp32 staging tile to a (L, D) bf16
// matrix at row offset row0, rows < L only.
static __device__ __forceinline__ void store_rows(bf16* dst, const float* src,
                                                  int lds, int r0, int row0,
                                                  int L, int D, int lane) {
  for (int i = lane; i < 16 * D; i += 32) {
    const int r = r0 + i / D, c = i % D;
    if (row0 + r < L)
      dst[(long)(row0 + r) * D + c] = __float2bfloat16(src[r * lds + c]);
  }
}

// Per row of the warp's 16 rows [r0, r0+16) of the q tile at q0:
// lse (0 past Lq) and delta = rowsum(dO * O) in fp32 (0 past Lq).
static __device__ __forceinline__ void row_stats(
    float* lse_s, float* delta_s, const float* lse, const bf16* o,
    const bf16* dout, int q0, int r0, int Lq, int D, int lane) {
  for (int r = 0; r < 16; ++r) {
    const int row = q0 + r0 + r;
    float d = 0.0f;
    if (row < Lq)
      for (int c = lane; c < D; c += 32)
        d += __bfloat162float(dout[(long)row * D + c]) *
             __bfloat162float(o[(long)row * D + c]);
    d = warp_sum(d);
    if (lane == 0) {
      delta_s[r0 + r] = row < Lq ? d : 0.0f;
      lse_s[r0 + r] = row < Lq ? lse[row] : 0.0f;
    }
  }
}

// p = exp(s - lse) and ds = p (dp - delta) for the warp's 16 rows, zero at
// q rows >= Lq and key columns >= kv_len; both cast to bf16.
template <int DP>
static __device__ __forceinline__ void probs_and_dlogits(
    bf16* ps, bf16* dss, const float* ss, const float* dps,
    const float* lse_s, const float* delta_s, int r0, int q0, int Lq,
    int kv0, int kv_len, int lane) {
  using Lay = FlashLayout<DP>;
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int row = r0 + r;
    const bool row_ok = q0 + row < Lq;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = lane + 32 * h;
      const bool ok = row_ok && kv0 + col < kv_len;
      const float p =
          ok ? __expf(ss[row * Lay::LDS + col] - lse_s[row]) : 0.0f;
      const float ds = p * (dps[row * Lay::LDS + col] - delta_s[row]);
      if (ps != nullptr) ps[row * Lay::LDP + col] = __float2bfloat16(p);
      dss[row * Lay::LDP + col] = __float2bfloat16(ds);
    }
  }
}

// ---------------------------------------------------------------------------
// K5: forward with lse
// ---------------------------------------------------------------------------

template <int DP>
__global__ void __launch_bounds__(FA_THREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, int Lq, int Lk, int D,
                 int kv_len) {
  using Lay = FlashLayout<DP>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem + Lay::T0);
  bf16* ks = reinterpret_cast<bf16*>(smem + Lay::T1);
  bf16* vs = reinterpret_cast<bf16*>(smem + Lay::T2);
  float* ss = reinterpret_cast<float*>(smem + Lay::S0);
  bf16* ps = reinterpret_cast<bf16*>(smem + Lay::P0);
  float* os = reinterpret_cast<float*>(smem + Lay::OS);

  const int q0 = blockIdx.x * FA_B;
  const long bh = blockIdx.y;
  const int lane = threadIdx.x % 32;
  const int r0 = (threadIdx.x / 32) * 16;
  constexpr int NF = DP / 16;
  const bf16* kb = k + bh * Lk * D;
  const bf16* vb = v + bh * Lk * D;

  load_tile(qs, Lay::LDT, q + bh * Lq * D, D, FA_B, DP, q0, 0, Lq, D);
  for (int i = lane; i < 16 * DP; i += 32)
    os[(r0 + i / DP) * Lay::LDO + i % DP] = 0.0f;
  float m_r[16], l_r[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    m_r[r] = -INFINITY;
    l_r[r] = 0.0f;
  }

  for (int kv0 = 0; kv0 < kv_len; kv0 += FA_B) {
    __syncthreads();  // q is loaded; every warp is done with the last tile
    load_tile(ks, Lay::LDT, kb, D, FA_B, DP, kv0, 0, kv_len, D);
    load_tile(vs, Lay::LDT, vb, D, FA_B, DP, kv0, 0, kv_len, D);
    __syncthreads();

    rows_times_t<DP>(ss, Lay::LDS, qs, ks, r0);
    __syncwarp();

    // online softmax, one row at a time across the warp (2 keys a lane);
    // the first tile always holds a key (kv_len >= 1), so m is finite
    const bool ok0 = kv0 + lane < kv_len;
    const bool ok1 = kv0 + lane + 32 < kv_len;
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int row = r0 + r;
      const float s0 = ok0 ? ss[row * Lay::LDS + lane] : -INFINITY;
      const float s1 = ok1 ? ss[row * Lay::LDS + lane + 32] : -INFINITY;
      const float m_new = fmaxf(m_r[r], warp_max(fmaxf(s0, s1)));
      const float p0 = ok0 ? __expf(s0 - m_new) : 0.0f;
      const float p1 = ok1 ? __expf(s1 - m_new) : 0.0f;
      const float alpha = __expf(m_r[r] - m_new);  // 0 on the first tile
      l_r[r] = l_r[r] * alpha + warp_sum(p0 + p1);
      m_r[r] = m_new;
      ps[row * Lay::LDP + lane] = __float2bfloat16(p0);
      ps[row * Lay::LDP + lane + 32] = __float2bfloat16(p1);
      for (int c = lane; c < DP; c += 32) os[row * Lay::LDO + c] *= alpha;
    }
    __syncwarp();

    // o += p . v (fp32 accumulator in shared memory)
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      FragC acc;
      wmma::load_matrix_sync(acc, os + r0 * Lay::LDO + j * 16, Lay::LDO,
                             wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < FA_B; kk += 16) {
        FragA a;
        FragB b;
        wmma::load_matrix_sync(a, ps + r0 * Lay::LDP + kk, Lay::LDP);
        wmma::load_matrix_sync(b, vs + kk * Lay::LDT + j * 16, Lay::LDT);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(os + r0 * Lay::LDO + j * 16, acc, Lay::LDO,
                              wmma::mem_row_major);
    }
    __syncwarp();
  }

  // o = acc / l (l = 0 guarded), lse = m + log l
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int row = r0 + r;
    const float l = l_r[r] == 0.0f ? 1.0f : l_r[r];
    const float inv_l = 1.0f / l;
    for (int c = lane; c < DP; c += 32) os[row * Lay::LDO + c] *= inv_l;
    if (lane == 0 && q0 + row < Lq) lse[bh * Lq + q0 + row] = m_r[r] + logf(l);
  }
  __syncwarp();
  store_rows(o + bh * Lq * D, os, Lay::LDO, r0, q0, Lq, D, lane);
}

// ---------------------------------------------------------------------------
// K6 (1 of 2): dq, one block per 64 q rows streaming k/v tiles
// ---------------------------------------------------------------------------

template <int DP>
__global__ void __launch_bounds__(FA_THREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ o,
                    const float* __restrict__ lse,
                    const bf16* __restrict__ dout, bf16* __restrict__ dq,
                    int Lq, int Lk, int D, int kv_len) {
  using Lay = FlashLayout<DP>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem + Lay::T0);
  bf16* dos = reinterpret_cast<bf16*>(smem + Lay::T1);
  bf16* ks = reinterpret_cast<bf16*>(smem + Lay::T2);
  bf16* vs = reinterpret_cast<bf16*>(smem + Lay::T3);
  float* ss = reinterpret_cast<float*>(smem + Lay::S0);
  float* dps = reinterpret_cast<float*>(smem + Lay::S1);
  bf16* dss = reinterpret_cast<bf16*>(smem + Lay::P1);
  float* os = reinterpret_cast<float*>(smem + Lay::OS);
  float* lse_s = reinterpret_cast<float*>(smem + Lay::RW);
  float* delta_s = lse_s + FA_B;

  const int q0 = blockIdx.x * FA_B;
  const long bh = blockIdx.y;
  const int lane = threadIdx.x % 32;
  const int r0 = (threadIdx.x / 32) * 16;
  constexpr int NF = DP / 16;
  const bf16* kb = k + bh * Lk * D;
  const bf16* vb = v + bh * Lk * D;

  load_tile(qs, Lay::LDT, q + bh * Lq * D, D, FA_B, DP, q0, 0, Lq, D);
  load_tile(dos, Lay::LDT, dout + bh * Lq * D, D, FA_B, DP, q0, 0, Lq, D);
  row_stats(lse_s, delta_s, lse + bh * Lq, o + bh * Lq * D,
            dout + bh * Lq * D, q0, r0, Lq, D, lane);

  FragC acc[NF];
#pragma unroll
  for (int j = 0; j < NF; ++j) wmma::fill_fragment(acc[j], 0.0f);

  for (int kv0 = 0; kv0 < kv_len; kv0 += FA_B) {
    __syncthreads();
    load_tile(ks, Lay::LDT, kb, D, FA_B, DP, kv0, 0, kv_len, D);
    load_tile(vs, Lay::LDT, vb, D, FA_B, DP, kv0, 0, kv_len, D);
    __syncthreads();

    rows_times_t<DP>(ss, Lay::LDS, qs, ks, r0);    // s = q k^T
    rows_times_t<DP>(dps, Lay::LDS, dos, vs, r0);  // dp = dO v^T
    __syncwarp();
    probs_and_dlogits<DP>(nullptr, dss, ss, dps, lse_s, delta_s, r0, q0, Lq,
                          kv0, kv_len, lane);
    __syncwarp();

    // dq += ds . k
#pragma unroll
    for (int kk = 0; kk < FA_B; kk += 16) {
      FragA a;
      wmma::load_matrix_sync(a, dss + r0 * Lay::LDP + kk, Lay::LDP);
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        FragB b;
        wmma::load_matrix_sync(b, ks + kk * Lay::LDT + j * 16, Lay::LDT);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
  }

#pragma unroll
  for (int j = 0; j < NF; ++j)
    wmma::store_matrix_sync(os + r0 * Lay::LDO + j * 16, acc[j], Lay::LDO,
                            wmma::mem_row_major);
  __syncwarp();
  store_rows(dq + bh * Lq * D, os, Lay::LDO, r0, q0, Lq, D, lane);
}

// ---------------------------------------------------------------------------
// K6 (2 of 2): dk and dv, one block per 64 k rows streaming q tiles
// ---------------------------------------------------------------------------

template <int DP>
__global__ void __launch_bounds__(FA_THREADS)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ o,
                     const float* __restrict__ lse,
                     const bf16* __restrict__ dout, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int Lq, int Lk, int D,
                     int kv_len) {
  using Lay = FlashLayout<DP>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem + Lay::T0);
  bf16* dos = reinterpret_cast<bf16*>(smem + Lay::T1);
  bf16* ks = reinterpret_cast<bf16*>(smem + Lay::T2);
  bf16* vs = reinterpret_cast<bf16*>(smem + Lay::T3);
  float* ss = reinterpret_cast<float*>(smem + Lay::S0);
  float* dps = reinterpret_cast<float*>(smem + Lay::S1);
  bf16* ps = reinterpret_cast<bf16*>(smem + Lay::P0);
  bf16* dss = reinterpret_cast<bf16*>(smem + Lay::P1);
  float* os = reinterpret_cast<float*>(smem + Lay::OS);
  float* lse_s = reinterpret_cast<float*>(smem + Lay::RW);
  float* delta_s = lse_s + FA_B;

  const int kv0 = blockIdx.x * FA_B;
  const long bh = blockIdx.y;
  const int lane = threadIdx.x % 32;
  const int r0 = (threadIdx.x / 32) * 16;  // q rows of p/ds; k rows of dk/dv
  constexpr int NF = DP / 16;
  const bf16* qb = q + bh * Lq * D;
  const bf16* ob = o + bh * Lq * D;
  const bf16* dob = dout + bh * Lq * D;

  // rows in [kv_len, Lk) load as zeros and get zero gradients
  load_tile(ks, Lay::LDT, k + bh * Lk * D, D, FA_B, DP, kv0, 0, kv_len, D);
  load_tile(vs, Lay::LDT, v + bh * Lk * D, D, FA_B, DP, kv0, 0, kv_len, D);

  FragC dk_acc[NF], dv_acc[NF];
#pragma unroll
  for (int j = 0; j < NF; ++j) {
    wmma::fill_fragment(dk_acc[j], 0.0f);
    wmma::fill_fragment(dv_acc[j], 0.0f);
  }

  for (int q0 = 0; q0 < Lq; q0 += FA_B) {
    __syncthreads();  // every warp is done with the last q tile's p and ds
    load_tile(qs, Lay::LDT, qb, D, FA_B, DP, q0, 0, Lq, D);
    load_tile(dos, Lay::LDT, dob, D, FA_B, DP, q0, 0, Lq, D);
    row_stats(lse_s, delta_s, lse + bh * Lq, ob, dob, q0, r0, Lq, D, lane);
    __syncthreads();

    // this warp's 16 q rows against the block's 64 keys
    rows_times_t<DP>(ss, Lay::LDS, qs, ks, r0);    // s = q k^T
    rows_times_t<DP>(dps, Lay::LDS, dos, vs, r0);  // dp = dO v^T
    __syncwarp();
    probs_and_dlogits<DP>(ps, dss, ss, dps, lse_s, delta_s, r0, q0, Lq, kv0,
                          kv_len, lane);
    __syncthreads();  // the products below read every warp's rows

    // this warp's 16 k rows: dv += p^T dO, dk += ds^T q over the 64 q rows
#pragma unroll
    for (int kk = 0; kk < FA_B; kk += 16) {
      FragAt pt, dst;
      wmma::load_matrix_sync(pt, ps + kk * Lay::LDP + r0, Lay::LDP);
      wmma::load_matrix_sync(dst, dss + kk * Lay::LDP + r0, Lay::LDP);
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        FragB b;
        wmma::load_matrix_sync(b, dos + kk * Lay::LDT + j * 16, Lay::LDT);
        wmma::mma_sync(dv_acc[j], pt, b, dv_acc[j]);
        wmma::load_matrix_sync(b, qs + kk * Lay::LDT + j * 16, Lay::LDT);
        wmma::mma_sync(dk_acc[j], dst, b, dk_acc[j]);
      }
    }
  }

#pragma unroll
  for (int j = 0; j < NF; ++j)
    wmma::store_matrix_sync(os + r0 * Lay::LDO + j * 16, dv_acc[j], Lay::LDO,
                            wmma::mem_row_major);
  __syncwarp();
  store_rows(dv + bh * Lk * D, os, Lay::LDO, r0, kv0, Lk, D, lane);
  __syncwarp();
#pragma unroll
  for (int j = 0; j < NF; ++j)
    wmma::store_matrix_sync(os + r0 * Lay::LDO + j * 16, dk_acc[j], Lay::LDO,
                            wmma::mem_row_major);
  __syncwarp();
  store_rows(dk + bh * Lk * D, os, Lay::LDO, r0, kv0, Lk, D, lane);
}

// ---------------------------------------------------------------------------

enum class FlashOp { kFwd, kDq, kDkv };

struct FlashArgs {
  const bf16 *q, *k, *v, *o, *dout;
  const float* lse_in;
  bf16 *o_out, *d0, *d1;
  float* lse_out;
  int BH, Lq, Lk, D, kv_len;
};

template <int DP>
static cudaError_t launch_flash_dp(FlashOp op, const FlashArgs& a,
                                   cudaStream_t stream) {
  const size_t bytes = FlashLayout<DP>::BYTES;
  const int rows = op == FlashOp::kDkv ? a.Lk : a.Lq;
  const dim3 grid((rows + FA_B - 1) / FA_B, a.BH);
  cudaError_t e = cudaSuccess;
  if (op == FlashOp::kFwd) {
    auto kern = flash_fwd_kernel<DP>;
    e = allow_smem(kern, bytes);
    if (e != cudaSuccess) return e;
    kern<<<grid, FA_THREADS, bytes, stream>>>(a.q, a.k, a.v, a.o_out,
                                              a.lse_out, a.Lq, a.Lk, a.D,
                                              a.kv_len);
  } else if (op == FlashOp::kDq) {
    auto kern = flash_bwd_dq_kernel<DP>;
    e = allow_smem(kern, bytes);
    if (e != cudaSuccess) return e;
    kern<<<grid, FA_THREADS, bytes, stream>>>(a.q, a.k, a.v, a.o, a.lse_in,
                                              a.dout, a.d0, a.Lq, a.Lk, a.D,
                                              a.kv_len);
  } else {
    auto kern = flash_bwd_dkv_kernel<DP>;
    e = allow_smem(kern, bytes);
    if (e != cudaSuccess) return e;
    kern<<<grid, FA_THREADS, bytes, stream>>>(a.q, a.k, a.v, a.o, a.lse_in,
                                              a.dout, a.d0, a.d1, a.Lq, a.Lk,
                                              a.D, a.kv_len);
  }
  return cudaGetLastError();
}

static cudaError_t launch_flash(FlashOp op, const FlashArgs& a,
                                cudaStream_t stream) {
  if (a.BH <= 0 || a.BH > 65535 || a.Lq <= 0 || a.Lk <= 0 || a.D <= 0 ||
      a.D > 128 || a.kv_len <= 0 || a.kv_len > a.Lk)
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

}  // namespace mdk

extern "C" {

// q: (BH, Lq, D); k, v: (BH, Lk, D); o: (BH, Lq, D), all bf16; lse: (BH, Lq)
// fp32. Keys at positions >= kv_len are masked.
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
// fp32 from mdk_flash_fwd
int mdk_flash_bwd_dq(const void* q, const void* k, const void* v,
                     const void* o, const void* lse, const void* dout,
                     void* dq, int BH, int Lq, int Lk, int D, int kv_len,
                     void* stream) {
  using mdk::bf16;
  mdk::FlashArgs a{};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.o = static_cast<const bf16*>(o);
  a.lse_in = static_cast<const float*>(lse);
  a.dout = static_cast<const bf16*>(dout);
  a.d0 = static_cast<bf16*>(dq);
  a.BH = BH, a.Lq = Lq, a.Lk = Lk, a.D = D, a.kv_len = kv_len;
  return (int)mdk::launch_flash(mdk::FlashOp::kDq, a,
                                static_cast<cudaStream_t>(stream));
}

// as mdk_flash_bwd_dq; dk, dv: (BH, Lk, D) bf16
int mdk_flash_bwd_dkv(const void* q, const void* k, const void* v,
                      const void* o, const void* lse, const void* dout,
                      void* dk, void* dv, int BH, int Lq, int Lk, int D,
                      int kv_len, void* stream) {
  using mdk::bf16;
  mdk::FlashArgs a{};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.o = static_cast<const bf16*>(o);
  a.lse_in = static_cast<const float*>(lse);
  a.dout = static_cast<const bf16*>(dout);
  a.d0 = static_cast<bf16*>(dk);
  a.d1 = static_cast<bf16*>(dv);
  a.BH = BH, a.Lq = Lq, a.Lk = Lk, a.D = D, a.kv_len = kv_len;
  return (int)mdk::launch_flash(mdk::FlashOp::kDkv, a,
                                static_cast<cudaStream_t>(stream));
}

}  // extern "C"
