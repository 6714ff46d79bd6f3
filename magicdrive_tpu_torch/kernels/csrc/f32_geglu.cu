// The fp32 instances of K4 (stage 1 of the GEGLU FeedForward) and K3 (the
// whole FeedForward but its stage-2 bias) for Hopper (sm_90a).
//
// Replace the fp32 instances of magicdrive_tpu/kernels/geglu.py fused_geglu
// and fused_ff, which an fp32 run of the JAX package reaches with the
// element size 4 (core/transformer.py FeedForward, ff_full_fusion_fits);
// at fp32 every bf16 cast point of their contract is the identity:
//   K4: g = (x Wv^T + bv) * gelu_erf(x Wg^T + bg), Wv/Wg the value and gate
//       halves of W1 (2N, K);
//   K3: y = g W2^T, W2 (C, N).
//
// Bound. At the 224x400 level 0 (M = 12*1400 rows, K = 320, N = 1280,
// C = 320) K3 needs 41.3 GFLOP against 31 MB of fp32 inputs and output:
// 0.62 ms at the 67 TFLOP/s fp32 rate against 0.009 ms of bytes.
//
// Design, on f32_tile.cuh's FFMA tiles:
//  * geglu_f32_kernel: a block owns 64 rows x 64 columns of g; the value and
//    gate halves accumulate side by side over KC-deep chunks that share the
//    x chunk, and the exact GELU (erff) and the product run in registers;
//  * ff_f32_kernel<NC>: a block owns 64 rows and 64*NC columns of y. The
//    whole stage-1 row block at N = 1280 would be 320 KB in fp32, past the
//    227 KB a block can have, so the block walks N in chunks of 64: the
//    chunk's g (64 x 64) is computed as in K4, staged transposed in shared
//    memory, and multiplied by the chunk's W2 columns into the y
//    accumulator, 64 x 64*NC fp32 in registers for the whole walk. g never
//    reaches device memory. As the bf16 K3, wider outputs split over blocks
//    along y (at most 5 tiles of 64 a block), each walking the whole N.
#include "f32_tile.cuh"

namespace mdk {
namespace f32 {

constexpr int FF_MAX_NC = 5;  // 64-column output tiles a block, at most

// hv, hg (64 x 64 of the block) = x[m0.., :K] Wv[n0.., :K]^T and the gate's,
// Wv = w1 rows [0, N), Wg = rows [N, 2N), over KC-deep chunks; the next
// chunk is fetched into registers while the current one is multiplied.
// smem: 3 [KC][LDT] tiles.
__device__ __forceinline__ void stage1(float (&hv)[TM][4], float (&hg)[TM][4],
                                       float* smem, const float* x,
                                       const float* w1, int M, int K, int N,
                                       int m0, int n0) {
  float* xs = smem;
  float* vs = smem + KC * LDT;
  float* gs = smem + 2 * KC * LDT;
  const float* wv = w1 + (long)n0 * K;
  const float* wg = w1 + ((long)N + n0) * K;
  const int nr = N - n0;  // the rows of each half from n0 on
  float4 rx = fetch_chunk(x, M, K, m0, 0), rv = fetch_chunk(wv, nr, K, 0, 0),
         rg = fetch_chunk(wg, nr, K, 0, 0);
  zero(hv);
  zero(hg);
  for (int k0 = 0; k0 < K; k0 += KC) {
    __syncthreads();  // every thread is done with the previous chunk
    put_chunk(xs, LDT, 0, rx);
    put_chunk(vs, LDT, 0, rv);
    put_chunk(gs, LDT, 0, rg);
    __syncthreads();
    if (k0 + KC < K) {
      rx = fetch_chunk(x, M, K, m0, k0 + KC);
      rv = fetch_chunk(wv, nr, K, 0, k0 + KC);
      rg = fetch_chunk(wg, nr, K, 0, k0 + KC);
    }
    fma_tile<4, KC>(hv, xs, LDT, vs, LDT);
    fma_tile<4, KC>(hg, xs, LDT, gs, LDT);
  }
}

// g = (hv + bv) * gelu_erf(hg + bg) in place in hv, for columns n0 + tx +
// 16 j; columns past N are zero.
__device__ __forceinline__ void gate(float (&hv)[TM][4],
                                     const float (&hg)[TM][4],
                                     const float* b1, int N, int n0) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + tx() + 16 * j;
    const bool in = n < N;
    const float bv = in && b1 != nullptr ? __ldg(b1 + n) : 0.0f;
    const float bg = in && b1 != nullptr ? __ldg(b1 + N + n) : 0.0f;
#pragma unroll
    for (int i = 0; i < TM; ++i)
      hv[i][j] = in ? (hv[i][j] + bv) * gelu_erf(hg[i][j] + bg) : 0.0f;
  }
}

__global__ void __launch_bounds__(THREADS)
geglu_f32_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                 const float* __restrict__ b1, float* __restrict__ out,
                 int M, int K, int N) {
  __shared__ __align__(16) float smem[3 * KC * LDT];
  const int n0 = blockIdx.x * BM, m0 = blockIdx.y * BM;
  float hv[TM][4], hg[TM][4];
  stage1(hv, hg, smem, x, w1, M, K, N, m0, n0);
  gate(hv, hg, b1, N, n0);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty() * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx() + 16 * j;
      if (n < N) out[(long)m * N + n] = hv[i][j];
    }
  }
}

// Shared memory of ff_f32_kernel<NC> (floats): stage 1's three chunk tiles,
// g^T [64][LDT] and a [KC][64*NC] chunk of W2^T.
template <int NC>
struct FFSmem {
  static constexpr int CT = BM * NC;
  static constexpr int S1 = 0, GT = 3 * KC * LDT, W2 = GT + BM * LDT,
                       FLOATS = W2 + KC * CT;
  static constexpr size_t BYTES = sizeof(float) * FLOATS;
};

// grid (row blocks of 64, column blocks of 64*NC): y[m0.., c0..] =
// sum over N chunks of g_chunk W2[c0.., chunk]^T.
template <int NC>
__global__ void __launch_bounds__(THREADS, 1)
ff_f32_kernel(const float* __restrict__ x, const float* __restrict__ w1,
              const float* __restrict__ b1, const float* __restrict__ w2,
              float* __restrict__ out, int M, int K, int N, int C) {
  extern __shared__ __align__(16) float smem[];
  using S = FFSmem<NC>;
  constexpr int TN = 4 * NC;
  const int m0 = blockIdx.x * BM, c0 = blockIdx.y * S::CT;
  float* gt = smem + S::GT;
  float* w2s = smem + S::W2;
  const float* w2c = w2 + (long)c0 * N;  // the block's output columns
  const int cr = C - c0;                 // its rows of W2
  float y[TM][TN];
  zero(y);
  for (int n0 = 0; n0 < N; n0 += BM) {
    float hv[TM][4], hg[TM][4];
    stage1(hv, hg, smem + S::S1, x, w1, M, K, N, m0, n0);
    gate(hv, hg, b1, N, n0);
    __syncthreads();  // every thread is done with the previous g^T
    put_t(gt, hv);
    // y += g W2[c0.., n0 + kc..]^T, KC columns of the chunk at a time
    for (int kc = 0; kc < BM; kc += KC) {
      float4 rw[NC];
#pragma unroll
      for (int r = 0; r < NC; ++r)
        rw[r] = fetch_chunk(w2c, cr, N, r * BM, n0 + kc);
      __syncthreads();  // g^T is in; every thread is done with the chunk
#pragma unroll
      for (int r = 0; r < NC; ++r) put_chunk(w2s, S::CT, r * BM, rw[r]);
      __syncthreads();
      fma_tile<TN, KC>(y, gt + kc * LDT, LDT, w2s, S::CT);
    }
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty() * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = c0 + tx() + 16 * j;
      if (c < C) out[(long)m * C + c] = y[i][j];
    }
  }
}

template <int NC>
static cudaError_t launch_ff(const float* x, const float* w1, const float* b1,
                             const float* w2, float* out, int M, int K, int N,
                             int C, int n_ct, cudaStream_t stream) {
  auto kern = ff_f32_kernel<NC>;
  const size_t bytes = FFSmem<NC>::BYTES;
  const cudaError_t e = allow_smem(kern, bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((M + BM - 1) / BM, n_ct);
  kern<<<grid, THREADS, bytes, stream>>>(x, w1, b1, w2, out, M, K, N, C);
  return cudaGetLastError();
}

}  // namespace f32
}  // namespace mdk

extern "C" {

// x: (M, K); w1: (2N, K); b1: (2N,) or null; out: (M, N), all fp32, 16-byte
// aligned; K and N multiples of 8
int mdk_geglu_f32(const void* x, const void* w1, const void* b1, void* out,
                  int M, int K, int N, void* stream) {
  using namespace mdk::f32;
  if (M <= 0 || K <= 0 || K % 8 || N <= 0 || N % 8 ||
      (M + BM - 1) / BM > 65535 || !mdk::aligned16({x, w1, b1, out}))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + BM - 1) / BM, (M + BM - 1) / BM);
  geglu_f32_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<float*>(out), M, K, N);
  return (int)cudaGetLastError();
}

#define MDK_FF_F32_CASE(NC)                                                \
  case NC:                                                                 \
    return (int)launch_ff<NC>(                                             \
        static_cast<const float*>(x), static_cast<const float*>(w1),       \
        static_cast<const float*>(b1), static_cast<const float*>(w2),      \
        static_cast<float*>(out), M, K, N, C, n_ct,                        \
        static_cast<cudaStream_t>(stream));

// x: (M, K); w1: (2N, K); b1: (2N,) or null; w2: (C, N); out: (M, C), all
// fp32, 16-byte aligned; K, N and C multiples of 8.
int mdk_ff_f32(const void* x, const void* w1, const void* b1, const void* w2,
               void* out, int M, int K, int N, int C, void* stream) {
  using namespace mdk::f32;
  if (M <= 0 || K <= 0 || K % 8 || N <= 0 || N % 8 || C <= 0 || C % 8 ||
      !mdk::aligned16({x, w1, b1, w2, out}))
    return (int)cudaErrorInvalidValue;
  // output tiles of 64 columns, at most FF_MAX_NC a block, spread evenly
  // over the fewest blocks along y (as mdk_ff)
  const int tiles = (C + 63) / 64;
  const int n_ct = (tiles + FF_MAX_NC - 1) / FF_MAX_NC;
  const int nc = (tiles + n_ct - 1) / n_ct;
  if (n_ct > 65535) return (int)cudaErrorInvalidValue;
  switch (nc) {
    MDK_FF_F32_CASE(1)
    MDK_FF_F32_CASE(2)
    MDK_FF_F32_CASE(3)
    MDK_FF_F32_CASE(4)
    MDK_FF_F32_CASE(5)
  }
  return (int)cudaErrorInvalidValue;
}

#undef MDK_FF_F32_CASE

}  // extern "C"
