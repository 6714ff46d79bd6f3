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
// Design, on f32_tile.cuh's FFMA tiles (256 threads, 64-row tiles):
//  * forward: a block owns 64 q rows, q^T staged once; f32::attend streams
//    the k/v tiles below kv_len;
//  * dq: a block owns 64 q rows (q^T and dO^T resident, lse and delta per
//    row) and streams k/v tiles: s = q k^T and dp = dO v^T from k-major
//    tiles, ds^T through shared memory, dq += ds k on the tile's rows;
//  * dk/dv: a block owns 64 keys (k^T and v^T resident) and streams q
//    tiles with their lse and delta: s^T = k q^T and dp^T = v dO^T, p and
//    ds staged in turn through one shared tile as the A operand of
//    dv += p^T dO and dk += ds^T q.
#include "f32_tile.cuh"

namespace mdk {
namespace f32 {
namespace {

struct Args {
  const float *q, *k, *v, *o, *dout, *lse_in, *delta_in;
  float *o_out, *lse_out, *d0, *d1, *delta_out;
  int BH, Lq, Lk, D, kv_len;
};

template <int DP>
__global__ void __launch_bounds__(THREADS)
flash_fwd_f32_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  using S = AttendSmem<DP>;
  constexpr int TN = DP / 16;
  const int q0 = blockIdx.x * BM;
  const long qb = (long)blockIdx.y * a.Lq * a.D;
  const long kb = (long)blockIdx.y * a.Lk * a.D;
  load_rows<DP, true, false>(smem + S::QT, nullptr, a.q + qb, q0, a.Lq, a.D);
  float m[TM], l[TM], o[TM][TN];
  attend<DP>(smem, a.k + kb, a.v + kb, a.Lk, a.kv_len, a.D, m, l, o);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = q0 + ty() * TM + i;
    if (r >= a.Lq) continue;
    const float inv = 1.0f / l[i];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int d = tx() + 16 * j;
      if (d < a.D) a.o_out[qb + (long)r * a.D + d] = o[i][j] * inv;
    }
    if (tx() == 0) a.lse_out[(long)blockIdx.y * a.Lq + r] = m[i] + logf(l[i]);
  }
}

// Shared memory of the dq kernel (floats): q^T, dO^T, k^T, v^T [DP][LDT],
// k [64][DP], ds^T [64][LDT], lse and delta [64].
template <int DP>
struct DqSmem {
  static constexpr int QT = 0, DOT = QT + DP * LDT, KT = DOT + DP * LDT,
                       VT = KT + DP * LDT, K = VT + DP * LDT,
                       DST = K + BM * DP, LSE = DST + BM * LDT,
                       DELTA = LSE + BM, FLOATS = DELTA + BM;
  static constexpr size_t BYTES = sizeof(float) * FLOATS;
};

template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
flash_dq_f32_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  using S = DqSmem<DP>;
  constexpr int TN = DP / 16;
  const int q0 = blockIdx.x * BM, D = a.D;
  const long qb = (long)blockIdx.y * a.Lq * D;
  const long kb = (long)blockIdx.y * a.Lk * D;
  const long rb = (long)blockIdx.y * a.Lq;
  float* qt = smem + S::QT;
  float* dot = smem + S::DOT;
  float* kt = smem + S::KT;
  float* vt = smem + S::VT;
  float* ks = smem + S::K;
  float* dst = smem + S::DST;
  load_rows<DP, true, false>(qt, nullptr, a.q + qb, q0, a.Lq, D);
  load_rows<DP, true, false>(dot, nullptr, a.dout + qb, q0, a.Lq, D);
  {  // delta = rowsum(dO * O): four threads a row, D/4 columns each
    const int r = threadIdx.x >> 2, part = threadIdx.x & 3;
    const bool in = q0 + r < a.Lq;
    float sum = 0.0f;
    if (in) {
      const float* dor = a.dout + qb + (long)(q0 + r) * D;
      const float* orow = a.o + qb + (long)(q0 + r) * D;
      for (int d = part; d < D; d += 4) sum += __ldg(dor + d) * __ldg(orow + d);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    if (part == 0) {
      smem[S::DELTA + r] = sum;
      smem[S::LSE + r] = in ? __ldg(a.lse_in + rb + q0 + r) : 0.0f;
      if (in) a.delta_out[rb + q0 + r] = sum;
    }
  }
  float dq[TM][TN];
  zero(dq);
  for (int t0 = 0; t0 < a.kv_len; t0 += BM) {
    __syncthreads();  // the statistics are in; every thread is done with
                      // the previous tile
    load_rows<DP, true, true>(kt, ks, a.k + kb, t0, a.Lk, D);
    load_rows<DP, true, false>(vt, nullptr, a.v + kb, t0, a.Lk, D);
    __syncthreads();
    float s[TM][4], dp[TM][4];
    zero(s);
    zero(dp);
    fma_tile<4, DP>(s, qt, LDT, kt, LDT);
    fma_tile<4, DP>(dp, dot, LDT, vt, LDT);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = ty() * TM + i;
      const float lse = smem[S::LSE + r], delta = smem[S::DELTA + r];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p =
            t0 + tx() + 16 * j < a.kv_len ? expf(s[i][j] - lse) : 0.0f;
        s[i][j] = p * (dp[i][j] - delta);  // ds
      }
    }
    put_t(dst, s);
    __syncthreads();
    fma_tile<TN, BM>(dq, dst, LDT, ks, DP);
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = q0 + ty() * TM + i;
    if (r >= a.Lq) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int d = tx() + 16 * j;
      if (d < D) a.d0[qb + (long)r * D + d] = dq[i][j];
    }
  }
}

// Shared memory of the dk/dv kernel (floats): k^T, v^T, q^T, dO^T
// [DP][LDT], q and dO [64][DP], the p / ds tile [64][LDT], lse and delta
// [64].
template <int DP>
struct DkvSmem {
  static constexpr int KT = 0, VT = KT + DP * LDT, QT = VT + DP * LDT,
                       DOT = QT + DP * LDT, Q = DOT + DP * LDT,
                       DO = Q + BM * DP, P = DO + BM * DP, LSE = P + BM * LDT,
                       DELTA = LSE + BM, FLOATS = DELTA + BM;
  static constexpr size_t BYTES = sizeof(float) * FLOATS;
};

template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
flash_dkv_f32_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  using S = DkvSmem<DP>;
  constexpr int TN = DP / 16;
  const int j0 = blockIdx.x * BM, D = a.D;
  const long qb = (long)blockIdx.y * a.Lq * D;
  const long kb = (long)blockIdx.y * a.Lk * D;
  const long rb = (long)blockIdx.y * a.Lq;
  float* kt = smem + S::KT;
  float* vt = smem + S::VT;
  float* qt = smem + S::QT;
  float* dot = smem + S::DOT;
  float* qs = smem + S::Q;
  float* dos = smem + S::DO;
  float* ps = smem + S::P;
  float dk[TM][TN], dv[TM][TN];
  zero(dk);
  zero(dv);
  if (j0 < a.kv_len) {  // a tile of masked keys only has zero gradients
    load_rows<DP, true, false>(kt, nullptr, a.k + kb, j0, a.Lk, D);
    load_rows<DP, true, false>(vt, nullptr, a.v + kb, j0, a.Lk, D);
    for (int i0 = 0; i0 < a.Lq; i0 += BM) {
      __syncthreads();  // every thread is done with the previous q tile
      load_rows<DP, true, true>(qt, qs, a.q + qb, i0, a.Lq, D);
      load_rows<DP, true, true>(dot, dos, a.dout + qb, i0, a.Lq, D);
      if (threadIdx.x < BM) {
        const int i = i0 + threadIdx.x;
        smem[S::LSE + threadIdx.x] = i < a.Lq ? __ldg(a.lse_in + rb + i) : 0.0f;
        smem[S::DELTA + threadIdx.x] =
            i < a.Lq ? __ldg(a.delta_in + rb + i) : 0.0f;
      }
      __syncthreads();
      // s^T and dp^T: rows are the block's keys, columns the tile's q rows
      float st[TM][4], dpt[TM][4];
      zero(st);
      zero(dpt);
      fma_tile<4, DP>(st, kt, LDT, qt, LDT);
      fma_tile<4, DP>(dpt, vt, LDT, dot, LDT);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = tx() + 16 * j;
        const float lse = smem[S::LSE + i], delta = smem[S::DELTA + i];
        const bool row = i0 + i < a.Lq;
#pragma unroll
        for (int r = 0; r < TM; ++r) {
          const bool key = j0 + ty() * TM + r < a.kv_len;
          const float p = row && key ? expf(st[r][j] - lse) : 0.0f;
          st[r][j] = p;
          dpt[r][j] = p * (dpt[r][j] - delta);  // ds^T
        }
      }
      put_t(ps, st);  // ps[i][j] = p
      __syncthreads();
      fma_tile<TN, BM>(dv, ps, LDT, dos, DP);
      __syncthreads();  // every thread is done with p
      put_t(ps, dpt);   // ps[i][j] = ds
      __syncthreads();
      fma_tile<TN, BM>(dk, ps, LDT, qs, DP);
    }
  }
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int j = j0 + ty() * TM + r;
    if (j >= a.Lk) continue;
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int d = tx() + 16 * c;
      if (d < D) {
        a.d0[kb + (long)j * D + d] = dk[r][c];
        a.d1[kb + (long)j * D + d] = dv[r][c];
      }
    }
  }
}

enum class Op { kFwd, kDq, kDkv };

template <int DP>
cudaError_t launch_dp(Op op, const Args& a, cudaStream_t stream) {
  const int rows = op == Op::kDkv ? a.Lk : a.Lq;
  const dim3 grid((rows + BM - 1) / BM, a.BH);
  cudaError_t e;
  switch (op) {
    case Op::kFwd:
      if ((e = allow_smem(flash_fwd_f32_kernel<DP>, AttendSmem<DP>::BYTES)))
        return e;
      flash_fwd_f32_kernel<DP><<<grid, THREADS, AttendSmem<DP>::BYTES,
                                 stream>>>(a);
      break;
    case Op::kDq:
      if ((e = allow_smem(flash_dq_f32_kernel<DP>, DqSmem<DP>::BYTES)))
        return e;
      flash_dq_f32_kernel<DP><<<grid, THREADS, DqSmem<DP>::BYTES, stream>>>(a);
      break;
    case Op::kDkv:
      if ((e = allow_smem(flash_dkv_f32_kernel<DP>, DkvSmem<DP>::BYTES)))
        return e;
      flash_dkv_f32_kernel<DP><<<grid, THREADS, DkvSmem<DP>::BYTES,
                                 stream>>>(a);
      break;
  }
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
  switch ((a.D + 15) / 16 * 16) {
    MDK_F32_DEPTHS(MDK_FLASH_CASE)
    default:
      return cudaErrorInvalidValue;
  }
#undef MDK_FLASH_CASE
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

}  // extern "C"
