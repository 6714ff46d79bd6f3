// Register-tile pieces of the Hopper attention kernels: bf16 mma.sync
// (m16n8k16, fp32 accumulate) on fragments loaded by ldmatrix, the
// conversion of an accumulator tile into the A operand of the next product,
// the online-softmax row statistics over the four threads that share a row,
// and a cp.async ring of shared-memory tiles.
//
// Fragment layout (PTX ISA, mma.m16n8k16 with .bf16): lane = 4 g + t.
//  * A (16 x 16, row-major): a[0] = (g, 2t..2t+1), a[1] = (g+8, 2t..),
//    a[2] = (g, 2t+8..), a[3] = (g+8, 2t+8..);
//  * B (16 x 8): b[0] = (k 2t..2t+1, n g), b[1] = (k 2t+8.., n g);
//  * C (16 x 8, fp32): c[0..1] = (g, 2t..2t+1), c[2..3] = (g+8, 2t..2t+1).
// So two C tiles that cover columns [0, 8) and [8, 16) of 16 rows, cast to
// bf16 pairs, are the A fragment of a product over those 16 columns: the
// probabilities of a softmax never leave the registers.
//
// Shared tiles are row-major with a pitch of DP + 8 bf16 (DP a multiple of
// 16): the eight 16-byte rows of an ldmatrix then fall in eight distinct
// 4-bank groups, and every row starts 16-byte aligned for cp.async.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace mdk {
namespace tile {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- the copy ring -------------------------------------------------------

// 16 bytes global -> shared, in flight until cp_wait; zeros when !valid
// (src is then not read, but must still be a mapped address).
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes global -> shared (fp32 row statistics), zeros when !valid
__device__ __forceinline__ void cp4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start copying rows [row0, row0 + ROWS) of a row-major (L, D) bf16 matrix
// into a shared tile of pitch LD: only the D real columns (D a multiple of
// 8), zeros for rows >= row_end. Called by all threads of the block.
template <int ROWS, int LD>
__device__ __forceinline__ void cp_rows(bf16* dst, const bf16* src, int row0,
                                        int row_end, int D) {
  const int vpr = D / 8;
  for (int i = threadIdx.x; i < ROWS * vpr; i += blockDim.x) {
    const int r = i / vpr, c = (i - r * vpr) * 8;
    const bool ok = row0 + r < row_end;
    cp16(dst + r * LD + c, src + (long)(ok ? row0 + r : 0) * D + c, ok);
  }
}

// Start copying one K chunk of the two operands of a product a b^T, both
// row-major bf16 with K columns (K a multiple of 8), into a shared tile of
// pitch LD: rows [a0, a0 + RA) of a (zeros at rows >= a_end), then rows
// [b0, b0 + RB) of b (zeros at rows >= b_end), each at columns
// [col0, col0 + KC) (zeros past K). Called by all threads of the block.
template <int RA, int RB, int KC, int LD>
__device__ __forceinline__ void cp_chunk(bf16* dst, const bf16* a, int a0,
                                         int a_end, const bf16* b, int b0,
                                         int b_end, int col0, int K) {
  constexpr int VPR = KC / 8;
  for (int i = threadIdx.x; i < (RA + RB) * VPR; i += blockDim.x) {
    const int r = i / VPR, cc = (i - r * VPR) * 8, col = col0 + cc;
    const bool is_a = r < RA;
    const int row = is_a ? a0 + r : b0 + r - RA;
    const bool ok = row < (is_a ? a_end : b_end) && col < K;
    cp16(dst + r * LD + cc, (is_a ? a : b) + (ok ? (long)row * K + col : 0),
         ok);
  }
}

// Start copying entries [i0, i0 + N) of an fp32 vector, zeros at >= end.
template <int N>
__device__ __forceinline__ void cp_vec(float* dst, const float* src, int i0,
                                       int end) {
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    const bool ok = i0 + i < end;
    cp4(dst + i, src + (ok ? i0 + i : 0), ok);
  }
}

// Zero columns [D, DP) of `rows` rows of pitch LD: the depth padding, which
// the copies never write. Once per kernel, before the first barrier.
template <int DP, int LD>
__device__ __forceinline__ void zero_pad_cols(bf16* t, int rows, int D) {
  const int w = DP - D;
  if (w == 0) return;
  const bf16 z = __float2bfloat16(0.0f);
  for (int i = threadIdx.x; i < rows * w; i += blockDim.x)
    t[(i / w) * LD + D + i % w] = z;
}

// ---- fragments -----------------------------------------------------------

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a b (m16n8k16, bf16 in, fp32 accumulate)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment (rows r0..r0+15, columns c0..c0+15) of a shared tile.
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* t,
                                       int r0, int c0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(a, t + (r0 + (lane & 15)) * LD + c0 + (lane >> 4) * 8);
}

// B fragments of a product with the transpose of a shared tile: B(k, n) =
// t(n, k) for n in [n0, n0 + 16) and k in [k0, k0 + 16). b[0..1] are the
// fragment of columns n0..n0+7, b[2..3] of n0+8..n0+15.
template <int LD>
__device__ __forceinline__ void load_bt(uint32_t (&b)[4], const bf16* t,
                                        int n0, int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(b, t + (n0 + (lane & 7) + (lane >> 4) * 8) * LD + k0 +
                 ((lane >> 3) & 1) * 8);
}

// B fragments of a product with a shared tile itself: B(k, n) = t(k, n)
// for k in [k0, k0 + 16) and n in [n0, n0 + 16), through ldmatrix.trans;
// b[0..1] for columns n0..n0+7, b[2..3] for n0+8..n0+15.
template <int LD>
__device__ __forceinline__ void load_b(uint32_t (&b)[4], const bf16* t,
                                       int k0, int n0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4_t(b, t + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + n0 +
                   (lane >> 4) * 8);
}

// The A fragment of columns [0, 16) from two fp32 C tiles (columns [0, 8)
// and [8, 16)), cast to bf16.
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// ---- row statistics ------------------------------------------------------

// max and sum over the four threads (t = 0..3) that hold a row's columns
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// One k/v tile of the online softmax for a warp's 16 rows. s holds the
// fp32 logits of NT 8-column tiles (already -inf where masked; every row
// has at least one finite logit); m and l are the running max and this
// thread's partial sum of rows g and g + 8. On return s holds
// p = exp(s - m_new), l the updated partial sums, and alpha the factor by
// which the caller rescales its accumulator rows.
template <int NT>
__device__ __forceinline__ void online_softmax(float (&s)[NT][4],
                                               float (&m)[2], float (&l)[2],
                                               float (&alpha)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = m[r];
#pragma unroll
    for (int j = 0; j < NT; ++j)
      mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
    mx = quad_max(mx);
    alpha[r] = __expf(m[r] - mx);  // 0 on the first tile (m = -inf)
    m[r] = mx;
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][2 * r] = __expf(s[j][2 * r] - mx);
      s[j][2 * r + 1] = __expf(s[j][2 * r + 1] - mx);
      sum += s[j][2 * r] + s[j][2 * r + 1];
    }
    l[r] = l[r] * alpha[r] + sum;
  }
}

// Store a warp's 16-row fp32 accumulator (NT 8-column tiles), times the
// per-row factor scale[0] (row g) and scale[1] (row g + 8), as bf16 pairs
// into a row-major matrix of row pitch ld at rows row0.., columns < D, rows
// < L.
template <int NT>
__device__ __forceinline__ void store_rows(bf16* dst, const float (&c)[NT][4],
                                           const float (&scale)[2], int row0,
                                           int L, int D, long ld) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= L) continue;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = j * 8 + 2 * t;
      if (col < D)
        *reinterpret_cast<uint32_t*>(dst + row * ld + col) =
            pack_bf16(c[j][2 * r] * scale[r], c[j][2 * r + 1] * scale[r]);
    }
  }
}

}  // namespace tile
}  // namespace mdk
