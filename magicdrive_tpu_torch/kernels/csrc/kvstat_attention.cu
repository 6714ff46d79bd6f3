// K1: kv-stationary projection-fused attention for Hopper (sm_90a).
//
// Replaces the Pallas kernels magicdrive_tpu/kernels/fused_attention.py
// _fused_kvstat_kernel / _fused_kvstat_group_kernel (launcher
// _kvstat_fwd_impl, entry fused_kvstat_attention): per (batch, head)
// k = x_kv.Wk_h and v = x_kv.Wv_h projected once, q = (x_q.Wq_h)*scale per
// q block, o = softmax(q k^T) v with fp32 statistics, no mask or bias.
//
// The TPU kernel kept one (batch, head)'s whole k/v resident in fast memory.
// At L=1400, D=40 that is already 224 KB in bf16, the whole of an SM's
// shared memory, so K1 is two launches here:
//  1. kv_project_kernel writes k and v once per (batch, head) into a
//     (B, H, Lk, D) bf16 workspace: the stand-in for kv-stationary scratch.
//  2. attention_kernel (common.cuh) fuses the q-tile projection and streams
//     k/v tiles through shared memory with an online softmax.
// Bound: at the 28x50 level (Lq=Lk=1400, D=40) the logits and PV products
// (4*Lq*Lk*D flops per head) outweigh the projections (2*(Lq*C + 2*Lk*C)*D);
// each block reads its head's k/v once from L2, and q never reaches device
// memory. The lane padding, head groups and group-major output of the TPU
// kernel are TPU layouts and have no counterpart here.
#include "common.cuh"

namespace mdk {

constexpr int PRJ_BM = 64, PRJ_BN = 64, PRJ_KC = 32, PRJ_THREADS = 128;

// out_z[b, h, l, d] = sum_c x[b*Lk + l, c] * W_z[h*D + d, c] for z = k, v
// (blockIdx.z picks k or v), cast to bf16. A tiled GEMM with M = B*Lk,
// N = H*D, K = Ck; four warps of 32x32 each.
__global__ void __launch_bounds__(PRJ_THREADS)
kv_project_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wk,
                  const bf16* __restrict__ wv, bf16* __restrict__ kout,
                  bf16* __restrict__ vout, int M, int Lk, int Ck, int H,
                  int D) {
  constexpr int LDX = PRJ_KC + 8, LDC = PRJ_BN + 4;
  __shared__ __align__(128) bf16 xs[PRJ_BM * LDX];
  __shared__ __align__(128) bf16 ws[PRJ_BN * LDX];
  __shared__ __align__(128) float cs[PRJ_BM * LDC];

  const bf16* w = blockIdx.z == 0 ? wk : wv;
  bf16* out = blockIdx.z == 0 ? kout : vout;
  const int N = H * D;
  const int n0 = blockIdx.x * PRJ_BN;
  const int m0 = blockIdx.y * PRJ_BM;
  const int warp = threadIdx.x / 32;
  const int wr = (warp / 2) * 32, wc = (warp % 2) * 32;

  FragC acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < Ck; k0 += PRJ_KC) {
    load_tile(xs, LDX, x, Ck, PRJ_BM, PRJ_KC, m0, k0, M, Ck);
    load_tile(ws, LDX, w, Ck, PRJ_BN, PRJ_KC, n0, k0, N, Ck);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < PRJ_KC; kk += 16) {
      FragA a[2];
      FragBt bt[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], xs + (wr + i * 16) * LDX + kk, LDX);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bt[j], ws + (wc + j * 16) * LDX + kk, LDX);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], bt[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(cs + (wr + i * 16) * LDC + wc + j * 16,
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();
  for (int i = threadIdx.x; i < PRJ_BM * PRJ_BN; i += PRJ_THREADS) {
    const int r = i / PRJ_BN, c = i % PRJ_BN;
    const int gm = m0 + r, gn = n0 + c;
    if (gm < M && gn < N) {
      const int bb = gm / Lk, l = gm % Lk, h = gn / D, d = gn % D;
      out[(((long)bb * H + h) * Lk + l) * D + d] =
          __float2bfloat16(cs[r * LDC + c]);
    }
  }
}

cudaError_t launch_kv_project(const bf16* x, const bf16* wk, const bf16* wv,
                              bf16* k, bf16* v, int B, int Lk, int Ck, int H,
                              int D, cudaStream_t stream) {
  if (B <= 0 || Lk <= 0 || Ck <= 0 || Ck % 8 || H <= 0 || D <= 0)
    return cudaErrorInvalidValue;
  const int M = B * Lk, N = H * D;
  const dim3 grid((N + PRJ_BN - 1) / PRJ_BN, (M + PRJ_BM - 1) / PRJ_BM, 2);
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
  return (int)mdk::launch_attention<1>(
      static_cast<const bf16*>(xq), static_cast<const bf16*>(wq),
      static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), B, Lq, C, Lk, H, D, scale, 0, 0, 1,
      static_cast<cudaStream_t>(stream));
}

const char* mdk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
