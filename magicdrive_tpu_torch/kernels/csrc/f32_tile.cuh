// The fp32 pieces of the hand-written kernels' fp32 instances, for Hopper
// (sm_90a): a register-blocked FFMA product tile staged through shared
// memory, the loaders that stage operands for it, and the attention core
// that K1/K2 (f32_attention.cu) and K5 (f32_flash.cu) run.
//
// The fp32 instances of K1-K8 keep fp32 arithmetic end to end: every cast
// point of the bf16 contract (kernels/reference.py) is the identity, so the
// products accumulate fp32 operands in fp32. Hopper's tensor cores take fp32
// only as TF32 (about three decimal digits), which reads near 1e-3 of
// max|ref| on these shapes, ten times past the fp32 gate (chip_smoke.py
// KERNEL_TOL_F32): the products here are FFMA on the CUDA cores.
//
// Bound: the CUDA cores' fp32 rate, 67 TFLOP/s on an H100 SXM (the tensor
// cores' 989 bf16 TFLOP/s do not apply), so every product of these kernels
// is bound by operations rather than bytes at the path's shapes.
//
// Design (the simple, right tile first; speed is later work):
//  * a block is 256 threads, a 16 x 16 grid (ty, tx); a block tile has 64
//    rows, and thread (ty, tx) owns rows ty*4 .. ty*4+3 and the interleaved
//    columns tx + 16 j, so the 16 threads of a row read 16 consecutive
//    words of the B operand (no bank conflict) and store 16 consecutive
//    words of the output (coalesced);
//  * both operands of every product are staged k-major in shared memory
//    (A as [k][row] with a pitch of 68 floats, read as one float4 a step;
//    B as [k][column]), so one k step is one 16-byte load of A, TN loads of
//    B and 4*TN FFMAs into registers;
//  * operands arrive from device memory as 16-byte vectors (rows of a
//    multiple of 4 floats, 16-byte aligned), are zero-filled outside the
//    tensor, and a transposed copy is scattered into the k-major tile.
#pragma once

#include "common.cuh"

namespace mdk {
namespace f32 {

constexpr int THREADS = 256;  // 16 x 16
constexpr int BM = 64;        // rows of a block tile
constexpr int TM = 4;         // rows a thread
constexpr int LDT = BM + 4;   // pitch of a k-major tile of 64 rows (floats)
constexpr int KC = 16;        // k depth of a streamed GEMM chunk

__device__ __forceinline__ int tx() { return threadIdx.x & 15; }
__device__ __forceinline__ int ty() { return threadIdx.x >> 4; }

template <int TN>
__device__ __forceinline__ void zero(float (&acc)[TM][TN]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
}

// acc[i][j] += sum_{k < K} A[k * lda + ty*4 + i] * B[k * ldb + tx + 16 j]:
// A k-major with 16-byte aligned rows (lda a multiple of 4), B k-major.
template <int TN, int K>
__device__ __forceinline__ void fma_tile(float (&acc)[TM][TN],
                                         const float* __restrict__ A,
                                         int lda,
                                         const float* __restrict__ B,
                                         int ldb) {
  const float* a = A + ty() * TM;
  const float* b = B + tx();
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float4 av = *reinterpret_cast<const float4*>(a + k * lda);
    float bv[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) bv[j] = b[k * ldb + 16 * j];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      acc[0][j] = fmaf(av.x, bv[j], acc[0][j]);
      acc[1][j] = fmaf(av.y, bv[j], acc[1][j]);
      acc[2][j] = fmaf(av.z, bv[j], acc[2][j]);
      acc[3][j] = fmaf(av.w, bv[j], acc[3][j]);
    }
  }
}

// Thread (ty, tx)'s 16-byte vector of a 64-row x KC chunk of src (rows x K,
// row-major) at rows r0.. and columns k0..: row threadIdx/4, columns
// (threadIdx%4)*4.. ; zero outside the tensor (K a multiple of 4). Called
// with (rows beyond the first 64) as r0 + 64 for taller tiles.
__device__ __forceinline__ float4 fetch_chunk(const float* __restrict__ src,
                                              int rows, int K, int r0,
                                              int k0) {
  const int r = r0 + (threadIdx.x >> 2), k = k0 + (threadIdx.x & 3) * 4;
  if (r < rows && k < K)
    return __ldg(reinterpret_cast<const float4*>(src + (long)r * K + k));
  return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// The chunk vector of fetch_chunk, transposed into a k-major tile at row
// offset r_off: dst[k * ld + r_off + row].
__device__ __forceinline__ void put_chunk(float* dst, int ld, int r_off,
                                          float4 v) {
  const int r = r_off + (threadIdx.x >> 2), k = (threadIdx.x & 3) * 4;
  dst[(k + 0) * ld + r] = v.x;
  dst[(k + 1) * ld + r] = v.y;
  dst[(k + 2) * ld + r] = v.z;
  dst[(k + 3) * ld + r] = v.w;
}

// Rows [r0, r0 + 64) of src (n_rows x D, row-major, D a multiple of 4)
// into shared memory, zero outside the tensor and in the pad columns
// [D, DP): transposed into tT[d * LDT + r] (T) and as rows into
// t[r * DP + d] (R).
template <int DP, bool T, bool R>
__device__ __forceinline__ void load_rows(float* tT, float* t,
                                          const float* __restrict__ src,
                                          int r0, int n_rows, int D) {
  constexpr int V4 = DP / 4;
  for (int i = threadIdx.x; i < BM * V4; i += THREADS) {
    const int r = i / V4, d = (i - r * V4) * 4;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r0 + r < n_rows && d < D)
      v = __ldg(reinterpret_cast<const float4*>(src + (long)(r0 + r) * D +
                                                d));
    if (T) {
      tT[(d + 0) * LDT + r] = v.x;
      tT[(d + 1) * LDT + r] = v.y;
      tT[(d + 2) * LDT + r] = v.z;
      tT[(d + 3) * LDT + r] = v.w;
    }
    if (R) *reinterpret_cast<float4*>(t + r * DP + d) = v;
  }
}

// A thread's 4 x TN values, transposed into a k-major tile: dst[(tx + 16 j)
// * LDT + ty*4 + i] = v[i][j] (the A operand of the next product).
template <int TN>
__device__ __forceinline__ void put_t(float* dst, const float (&v)[TM][TN]) {
#pragma unroll
  for (int j = 0; j < TN; ++j)
    *reinterpret_cast<float4*>(dst + (tx() + 16 * j) * LDT + ty() * TM) =
        make_float4(v[0][j], v[1][j], v[2][j], v[3][j]);
}

// Max and sum over the 16 threads of a row (lanes of one half-warp).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Shared memory of the attention core (floats): q^T [DP][LDT], k^T
// [DP][LDT], v [64][DP], p^T [64][LDT].
template <int DP>
struct AttendSmem {
  static constexpr int QT = 0, KT = QT + DP * LDT, V = KT + DP * LDT,
                       PT = V + BM * DP, FLOATS = PT + BM * LDT;
  static constexpr size_t BYTES = sizeof(float) * FLOATS;
};

// One source's attention for the block's 64 q rows, q^T already in
// smem[QT] (pad columns zero): for every 64-key tile below kv_len of the
// (Lk, D) rows k and v, s = q k^T, the online softmax with its statistics
// in m and l (each thread holds its 4 rows' copies), p^T staged in shared
// memory and o += p v; keys at positions >= kv_len take no part. o is the
// unnormalised sum, l the row sums.
template <int DP>
__device__ __forceinline__ void attend(float* smem,
                                       const float* __restrict__ k,
                                       const float* __restrict__ v, int Lk,
                                       int kv_len, int D, float (&m)[TM],
                                       float (&l)[TM],
                                       float (&o)[TM][DP / 16]) {
  using S = AttendSmem<DP>;
  float* qt = smem + S::QT;
  float* kt = smem + S::KT;
  float* vs = smem + S::V;
  float* pt = smem + S::PT;
#pragma unroll
  for (int i = 0; i < TM; ++i) m[i] = -INFINITY, l[i] = 0.0f;
  zero(o);
  for (int t0 = 0; t0 < kv_len; t0 += BM) {
    __syncthreads();  // every thread is done with the previous tile
    load_rows<DP, true, false>(kt, nullptr, k, t0, Lk, D);
    load_rows<DP, false, true>(nullptr, vs, v, t0, Lk, D);
    __syncthreads();
    float s[TM][4];
    zero(s);
    fma_tile<4, DP>(s, qt, LDT, kt, LDT);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (t0 + tx() + 16 * j >= kv_len)
#pragma unroll
        for (int i = 0; i < TM; ++i) s[i][j] = -INFINITY;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float mx = row_max(fmaxf(fmaxf(s[i][0], s[i][1]),
                                     fmaxf(s[i][2], s[i][3])));
      const float m_new = fmaxf(m[i], mx);  // finite: key t0 is valid
      const float alpha = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DP / 16; ++j) o[i][j] *= alpha;
    }
    put_t(pt, s);
    __syncthreads();
    fma_tile<DP / 16, BM>(o, pt, LDT, vs, DP);
  }
}

// The head depth padded to the tile's 16-column step, as a template switch.
#define MDK_F32_DEPTHS(CASE) \
  CASE(16) CASE(32) CASE(48) CASE(64) CASE(80) CASE(96) CASE(112) CASE(128)

}  // namespace f32
}  // namespace mdk
