// The fp32 instances of K1, K2, K7, K8 and the K8 pair for Hopper (sm_90a).
//
// Replace the fp32 instances of the Pallas kernels of
// magicdrive_tpu/kernels/fused_attention.py: fused_kvstat_attention (K1; K7,
// fused_qkv_attention, computes its function), fused_kvstat_attention_pair
// (K2) and fused_qkv_out_attention with its pair (K8). An fp32 run of the
// JAX package sends its attentions there with the element size 4
// (core/attention.py, core/transformer.py); at fp32 every bf16 cast point
// of their contract is the identity: k, v = x_kv W per head; q = (x_q Wq)
// scale; o = softmax(q k^T) v with fp32 statistics, divided by the row sum;
// the pair sums its two neighbours' normalised outputs; K8 out-projects o by
// Wout without the bias. The wrappers launch these entries for fp32 tensors
// as they launch the bf16 ones (kvstat_attention.cu,
// kvstat_pair_attention.cu, fused_out_attention.cu) for bf16:
//  1. kv_project_f32_kernel: k and v of every head into (B, H, Lk, D), the
//     kv-stationary workspace;
//  2. heads_f32_kernel<DP, NSRC>: per (q tile of 64 rows, head, batch), q
//     projected into shared memory, then f32::attend over each of NSRC
//     sources (the pair's neighbour i of view v is view table[i][v] of the
//     same sample), the pair's normalised outputs summed in fp32;
//  3. out_project_f32_kernel: o Wout^T for K8 and its pair.
//
// Bound. At the 28x50 level (12 views, L=1400, C=320, 8 heads of 40) K1
// needs 40.4 GFLOP against 43 MB of fp32 inputs and output: 0.60 ms at the
// 67 TFLOP/s fp32 rate against 0.013 ms of bytes, so operations bind.
//
// Design: f32_tile.cuh's FFMA tiles (256 threads, 64-row tiles, 4 x TN
// register blocks). The logits, p and the statistics never reach device
// memory; p^T goes once through shared memory as the A operand of p v. The
// q tile stays in shared memory for every key tile of both sources.
#include "f32_tile.cuh"

namespace mdk {
namespace f32 {

// acc (64 x 64 of the block) += A[m0.., :K] B_z[n0.., :K]^T over KC-deep
// chunks, for NB matrices B_z that share the A chunk (rows of B_z valid
// below n_rows); A (M, K) and B_z row-major, K a multiple of 4. The next
// chunk is fetched into registers while the current one is multiplied.
template <int NB>
__device__ __forceinline__ void gemm_nt(float (&acc)[NB][TM][4],
                                        float* smem, const float* A, int M,
                                        const float* const (&B)[NB],
                                        int n_rows, int K, int m0, int n0) {
  float* as = smem;                // [KC][LDT]
  float* bs = smem + KC * LDT;     // NB x [KC][LDT]
  float4 ra = fetch_chunk(A, M, K, m0, 0), rb[NB];
#pragma unroll
  for (int z = 0; z < NB; ++z) rb[z] = fetch_chunk(B[z], n_rows, K, n0, 0);
  for (int k0 = 0; k0 < K; k0 += KC) {
    __syncthreads();  // every thread is done with the previous chunk
    put_chunk(as, LDT, 0, ra);
#pragma unroll
    for (int z = 0; z < NB; ++z) put_chunk(bs + z * KC * LDT, LDT, 0, rb[z]);
    __syncthreads();
    if (k0 + KC < K) {
      ra = fetch_chunk(A, M, K, m0, k0 + KC);
#pragma unroll
      for (int z = 0; z < NB; ++z)
        rb[z] = fetch_chunk(B[z], n_rows, K, n0, k0 + KC);
    }
#pragma unroll
    for (int z = 0; z < NB; ++z)
      fma_tile<4, KC>(acc[z], as, LDT, bs + z * KC * LDT, LDT);
  }
}

constexpr int GEMM_FLOATS = 3 * KC * LDT;  // A and at most two B chunks

// k_z[b, h, l, d] = sum_c x[b*Lk + l, c] W_z[h*D + d, c] for z = k, v
// (blockIdx.z): a GEMM with M = B*Lk, N = H*D, K = Ck on 64 x 64 tiles.
__global__ void __launch_bounds__(THREADS)
kv_project_f32_kernel(const float* __restrict__ x, const float* __restrict__ wk,
                      const float* __restrict__ wv, float* __restrict__ kout,
                      float* __restrict__ vout, int M, int Lk, int Ck, int H,
                      int D) {
  __shared__ __align__(16) float smem[GEMM_FLOATS];
  const int N = H * D, m0 = blockIdx.x * BM, n0 = blockIdx.y * BM;
  const float* const w[1] = {blockIdx.z == 0 ? wk : wv};
  float* out = blockIdx.z == 0 ? kout : vout;
  float acc[1][TM][4];
  zero(acc[0]);
  gemm_nt<1>(acc, smem, x, M, w, N, Ck, m0, n0);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty() * TM + i;
    if (m >= M) continue;
    const int bb = m / Lk, l = m - bb * Lk;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx() + 16 * j;
      if (n >= N) continue;
      const int h = n / D, d = n - h * D;
      out[(((long)bb * H + h) * Lk + l) * D + d] = acc[0][i][j];
    }
  }
}

// out (M, N) = o (M, K) Wout (N, K)^T: K8's out-projection, no bias.
__global__ void __launch_bounds__(THREADS)
out_project_f32_kernel(const float* __restrict__ o,
                       const float* __restrict__ wout,
                       float* __restrict__ out, int M, int K, int N) {
  __shared__ __align__(16) float smem[GEMM_FLOATS];
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BM;
  const float* const w[1] = {wout};
  float acc[1][TM][4];
  zero(acc[0]);
  gemm_nt<1>(acc, smem, o, M, w, N, K, m0, n0);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty() * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx() + 16 * j;
      if (n < N) out[(long)m * N + n] = acc[0][i][j];
    }
  }
}

// K1 (NSRC == 1) and K2 (NSRC == 2): grid (q tiles of 64 rows, H, B). The
// block projects q = (x_q tile . Wq_h^T) * scale over KC-deep chunks of C
// into q^T (the chunks staged over the k^T and v tiles, which the key loop
// then overwrites), attends over each source's k/v rows of the (B, H, Lk,
// D) workspace and writes (B, Lq, H*D) at the head's columns.
template <int DP, int NSRC>
__global__ void __launch_bounds__(THREADS)
heads_f32_kernel(const float* __restrict__ xq, const float* __restrict__ wq,
                 const float* __restrict__ kws,
                 const float* __restrict__ vws, float* __restrict__ out,
                 int Lq, int C, int Lk, int H, int D, float scale,
                 const int* __restrict__ table, int n_views) {
  extern __shared__ __align__(16) float smem[];
  using S = AttendSmem<DP>;
  constexpr int TN = DP / 16;
  const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const float* x = xq + (long)b * Lq * C;
  const float* w = wq + (long)h * D * C;  // the head's D rows

  // ---- q^T = ((x_q . Wq_h^T) * scale)^T, pad columns zero ----
  {
    float* xs = smem + S::KT;      // [KC][LDT]
    float* ws = xs + KC * LDT;     // [KC][DP]
    float q[TM][TN];
    zero(q);
    for (int k0 = 0; k0 < C; k0 += KC) {
      const float4 ra = fetch_chunk(x, Lq, C, q0, k0);
      float4 rb[DP / BM + 1];
#pragma unroll
      for (int r = 0; r * BM < DP; ++r)
        rb[r] = fetch_chunk(w, D, C, r * BM, k0);
      __syncthreads();
      put_chunk(xs, LDT, 0, ra);
#pragma unroll
      for (int r = 0; r * BM < DP; ++r)
        if (r * BM + (threadIdx.x >> 2) < DP) put_chunk(ws, DP, r * BM, rb[r]);
      __syncthreads();
      fma_tile<TN, KC>(q, xs, LDT, ws, DP);
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) q[i][j] *= scale;
    put_t(smem + S::QT, q);
  }

  // ---- each source, normalised; the pair's two summed in fp32 ----
  float res[TM][TN];
  zero(res);
#pragma unroll
  for (int src = 0; src < NSRC; ++src) {
    const int v = b % n_views;
    const int kb = NSRC == 1 ? b : b - v + __ldg(table + src * n_views + v);
    const long base = ((long)kb * H + h) * Lk * D;
    float m[TM], l[TM], o[TM][TN];
    attend<DP>(smem, kws + base, vws + base, Lk, Lk, D, m, l, o);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float inv = 1.0f / l[i];
#pragma unroll
      for (int j = 0; j < TN; ++j) res[i][j] += o[i][j] * inv;
    }
  }

  const long ld = (long)H * D;
  float* dst = out + (long)b * Lq * ld + (long)h * D;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = q0 + ty() * TM + i;
    if (r >= Lq) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int d = tx() + 16 * j;
      if (d < D) dst[r * ld + d] = res[i][j];
    }
  }
}

template <int DP, int NSRC>
static cudaError_t launch_heads_dp(dim3 grid, const float* xq,
                                   const float* wq, const float* k,
                                   const float* v, float* out, int Lq, int C,
                                   int Lk, int H, int D, float scale,
                                   const int* table, int n_views,
                                   cudaStream_t stream) {
  static_assert(KC * LDT + KC * DP <= DP * LDT + BM * DP,
                "the projection chunks fit over the k^T and v tiles");
  auto kern = heads_f32_kernel<DP, NSRC>;
  const size_t bytes = AttendSmem<DP>::BYTES;
  const cudaError_t e = allow_smem(kern, bytes);
  if (e != cudaSuccess) return e;
  kern<<<grid, THREADS, bytes, stream>>>(xq, wq, k, v, out, Lq, C, Lk, H, D,
                                         scale, table, n_views);
  return cudaGetLastError();
}

template <int NSRC>
static cudaError_t launch_heads(const float* xq, const float* wq,
                                const float* k, const float* v, float* out,
                                int B, int Lq, int C, int Lk, int H, int D,
                                float scale, const int* table, int n_views,
                                cudaStream_t stream) {
  // rows of C and of D floats are whole 16-byte vectors
  if (B <= 0 || B > 65535 || Lq <= 0 || Lk <= 0 || C <= 0 || C % 8 ||
      H <= 0 || H > 65535 || D <= 0 || D > 128 || D % 8 || n_views <= 0 ||
      B % n_views || (NSRC == 2 && table == nullptr) ||
      !aligned16({xq, wq, k, v, out}))
    return cudaErrorInvalidValue;
  const dim3 grid((Lq + BM - 1) / BM, H, B);
#define MDK_HEADS_CASE(DPV)                                                  \
  case DPV:                                                                  \
    return launch_heads_dp<DPV, NSRC>(grid, xq, wq, k, v, out, Lq, C, Lk, H, \
                                      D, scale, table, n_views, stream);
  switch ((D + 15) / 16 * 16) {
    MDK_F32_DEPTHS(MDK_HEADS_CASE)
    default:
      return cudaErrorInvalidValue;
  }
#undef MDK_HEADS_CASE
}

// A GEMM of f32's 64 x 64 tiles over (M, N): rows of K floats are whole
// 16-byte vectors.
static bool gemm_shapes_ok(int M, int N, int K) {
  return M > 0 && N > 0 && K > 0 && K % 8 == 0 &&
         (N + BM - 1) / BM <= 65535;
}

}  // namespace f32
}  // namespace mdk

extern "C" {

// x: (B, Lk, Ck) fp32; wk, wv: (H*D, Ck) nn.Linear layout; k, v: (B, H, Lk,
// D) fp32 workspaces. Ck and D multiples of 8, pointers 16-byte aligned.
int mdk_kv_project_f32(const void* x, const void* wk, const void* wv,
                       void* k, void* v, int B, int Lk, int Ck, int H, int D,
                       void* stream) {
  using namespace mdk::f32;
  if (B <= 0 || Lk <= 0 || H <= 0 || D <= 0 || D % 8 ||
      !gemm_shapes_ok(B * Lk, H * D, Ck) || !mdk::aligned16({x, wk, wv, k, v}))
    return (int)cudaErrorInvalidValue;
  const int M = B * Lk, N = H * D;
  const dim3 grid((M + BM - 1) / BM, (N + BM - 1) / BM, 2);
  kv_project_f32_kernel<<<grid, THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(wk),
      static_cast<const float*>(wv), static_cast<float*>(k),
      static_cast<float*>(v), M, Lk, Ck, H, D);
  return (int)cudaGetLastError();
}

// xq: (B, Lq, C); wq: (H*D, C); k, v: (B, H, Lk, D) from
// mdk_kv_project_f32; out: (B, Lq, H*D), all fp32
int mdk_kvstat_attention_f32(const void* xq, const void* wq, const void* k,
                             const void* v, void* out, int B, int Lq, int C,
                             int Lk, int H, int D, float scale,
                             void* stream) {
  return (int)mdk::f32::launch_heads<1>(
      static_cast<const float*>(xq), static_cast<const float*>(wq),
      static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), B, Lq, C, Lk, H, D, scale, nullptr, 1,
      static_cast<cudaStream_t>(stream));
}

// x: (B, L, C) the views' hidden states; k, v: (B, H, L, D) projected from
// x; out: (B, L, H*D), all fp32. B a multiple of n_views; table: int32
// [2][n_views] on the device, every entry in [0, n_views).
int mdk_kvstat_attention_pair_f32(const void* x, const void* wq,
                                  const void* k, const void* v, void* out,
                                  int B, int L, int C, int H, int D,
                                  float scale, const void* table,
                                  int n_views, void* stream) {
  return (int)mdk::f32::launch_heads<2>(
      static_cast<const float*>(x), static_cast<const float*>(wq),
      static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), B, L, C, L, H, D, scale,
      static_cast<const int*>(table), n_views,
      static_cast<cudaStream_t>(stream));
}

// o: (M, K); wout: (N, K) nn.Linear layout; out: (M, N), all fp32; K and N
// multiples of 8, pointers 16-byte aligned.
int mdk_out_project_f32(const void* o, const void* wout, void* out, int M,
                        int K, int N, void* stream) {
  using namespace mdk::f32;
  if (!gemm_shapes_ok(M, N, K) || N % 8 || !mdk::aligned16({o, wout, out}))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((M + BM - 1) / BM, (N + BM - 1) / BM);
  out_project_f32_kernel<<<grid, THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(o), static_cast<const float*>(wout),
      static_cast<float*>(out), M, K, N);
  return (int)cudaGetLastError();
}

}  // extern "C"
