// K3 (whole FeedForward) and K4 (GEGLU stage 1) for Hopper (sm_90a).
//
// K4 replaces magicdrive_tpu/kernels/geglu.py _kernel (launcher
// _geglu_fwd_impl, entry fused_geglu): out = (x.Wv + bv) * gelu_erf(x.Wg + bg)
// with fp32 accumulation, written in bf16; stage 2 of the FeedForward stays a
// matrix product outside the kernel, as in the JAX package.
// K3 replaces geglu.py _ff_kernel (launcher _ff_fwd_impl, entry fused_ff):
// out = bf16((x.Wv + bv) * gelu_erf(x.Wg + bg)) . W2 with an fp32
// accumulator; the caller adds the W2 bias.
//
// Weights arrive in nn.Linear layout: W1 = ff.net.0.proj.weight (2N, K),
// value rows [0, N) first and gate rows [N, 2N) second; W2 =
// ff.net.2.weight (C, N). GELU is the exact erf form (erff); the TPU
// kernel's rational erf polynomial only worked around a Mosaic gap.
//
// Bound: both are matrix products (4*M*K*N flops for the two halves, plus
// 2*M*N*C for K3's stage 2). K4 removes the (M, 2N) fp32 intermediate of
// the plain version and writes only the gated (M, N) bf16 product. K3 keeps
// the gated product out of device memory altogether: a 32-row block walks
// the inner dimension N in 64-wide chunks, gates each chunk in shared
// memory and multiplies it into an fp32 (32 x C) accumulator that also lives
// in shared memory, so no weight has to stay resident (the TPU plan kept all
// three weights in VMEM; a Hopper SM's 227 KB cannot).
#include "common.cuh"

namespace mdk {

constexpr int GG_BM = 64, GG_BN = 64, GG_KC = 32, GG_THREADS = 128;

// K4: one block = one 64 x 64 output tile; four warps of 32 x 32, each
// holding the value and the gate accumulators of its quarter.
__global__ void __launch_bounds__(GG_THREADS)
geglu_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
             const bf16* __restrict__ b1, bf16* __restrict__ out, int M,
             int K, int N) {
  constexpr int LDX = GG_KC + 8, LDC = GG_BN + 4;
  struct Tiles {
    bf16 xs[GG_BM * LDX];
    bf16 wvs[GG_BN * LDX];
    bf16 wgs[GG_BN * LDX];
  };
  struct Epilogue {
    float hv[GG_BM * LDC];
    float hg[GG_BM * LDC];
  };
  __shared__ __align__(128) unsigned char
      smem[sizeof(Tiles) > sizeof(Epilogue) ? sizeof(Tiles) : sizeof(Epilogue)];
  Tiles& t = *reinterpret_cast<Tiles*>(smem);
  Epilogue& e = *reinterpret_cast<Epilogue*>(smem);

  const int n0 = blockIdx.x * GG_BN;
  const int m0 = blockIdx.y * GG_BM;
  const int warp = threadIdx.x / 32;
  const int wr = (warp / 2) * 32, wc = (warp % 2) * 32;
  const bf16* wg = w1 + (long)N * K;  // gate half

  FragC av[2][2], ag[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::fill_fragment(av[i][j], 0.0f);
      wmma::fill_fragment(ag[i][j], 0.0f);
    }

  for (int k0 = 0; k0 < K; k0 += GG_KC) {
    load_tile(t.xs, LDX, x, K, GG_BM, GG_KC, m0, k0, M, K);
    load_tile(t.wvs, LDX, w1, K, GG_BN, GG_KC, n0, k0, N, K);
    load_tile(t.wgs, LDX, wg, K, GG_BN, GG_KC, n0, k0, N, K);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GG_KC; kk += 16) {
      FragA a[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], t.xs + (wr + i * 16) * LDX + kk, LDX);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        FragBt bv, bg;
        wmma::load_matrix_sync(bv, t.wvs + (wc + j * 16) * LDX + kk, LDX);
        wmma::load_matrix_sync(bg, t.wgs + (wc + j * 16) * LDX + kk, LDX);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          wmma::mma_sync(av[i][j], a[i], bv, av[i][j]);
          wmma::mma_sync(ag[i][j], a[i], bg, ag[i][j]);
        }
      }
    }
    __syncthreads();
  }
  // the tiles are dead: reuse their shared memory for the epilogue
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int off = (wr + i * 16) * LDC + wc + j * 16;
      wmma::store_matrix_sync(e.hv + off, av[i][j], LDC, wmma::mem_row_major);
      wmma::store_matrix_sync(e.hg + off, ag[i][j], LDC, wmma::mem_row_major);
    }
  __syncthreads();
  for (int i = threadIdx.x; i < GG_BM * GG_BN; i += GG_THREADS) {
    const int r = i / GG_BN, c = i % GG_BN;
    const int gm = m0 + r, gn = n0 + c;
    if (gm < M && gn < N) {
      float hv = e.hv[r * LDC + c], hg = e.hg[r * LDC + c];
      if (b1 != nullptr) {
        hv += __bfloat162float(b1[gn]);
        hg += __bfloat162float(b1[N + gn]);
      }
      out[(long)gm * N + gn] = __float2bfloat16(hv * gelu_erf(hg));
    }
  }
}

// K3: one block = 32 rows of x and the whole (32 x C) output.
constexpr int FF_BM = 32, FF_BN = 64, FF_KC = 32, FF_THREADS = 128;

struct FFLayout {
  int ldx, lda;
  size_t xs, acc, gs, u, w2s, wvs, wgs, hv, hg, bytes;
  __host__ __device__ FFLayout(int K, int C) {
    constexpr int LDW = FF_KC + 8, LDH = FF_BN + 4, LDG = FF_BN + 8;
    const int k32 = (K + FF_KC - 1) / FF_KC * FF_KC;
    ldx = k32 + 8;
    lda = C + 4;
    xs = 0;
    acc = align128(xs + sizeof(bf16) * FF_BM * ldx);
    gs = align128(acc + sizeof(float) * FF_BM * lda);
    u = align128(gs + sizeof(bf16) * FF_BM * LDG);
    // stage 1 (weight chunk tiles, fp32 halves) and stage 2 (the W2 chunk)
    // never live at once, so they share one region
    w2s = u;
    wvs = u;
    wgs = align128(wvs + sizeof(bf16) * FF_BN * LDW);
    hv = align128(wgs + sizeof(bf16) * FF_BN * LDW);
    hg = align128(hv + sizeof(float) * FF_BM * LDH);
    const size_t stage1 = align128(hg + sizeof(float) * FF_BM * LDH);
    const size_t stage2 = align128(w2s + sizeof(bf16) * (size_t)C * LDG);
    bytes = stage1 > stage2 ? stage1 : stage2;
  }
};

__global__ void __launch_bounds__(FF_THREADS)
ff_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
          const bf16* __restrict__ b1, const bf16* __restrict__ w2,
          bf16* __restrict__ out, int M, int K, int N, int C) {
  constexpr int LDW = FF_KC + 8, LDH = FF_BN + 4, LDG = FF_BN + 8;
  const FFLayout lay(K, C);
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem + lay.xs);
  float* acc = reinterpret_cast<float*>(smem + lay.acc);
  bf16* gs = reinterpret_cast<bf16*>(smem + lay.gs);
  bf16* w2s = reinterpret_cast<bf16*>(smem + lay.w2s);
  bf16* wvs = reinterpret_cast<bf16*>(smem + lay.wvs);
  bf16* wgs = reinterpret_cast<bf16*>(smem + lay.wgs);
  float* hvs = reinterpret_cast<float*>(smem + lay.hv);
  float* hgs = reinterpret_cast<float*>(smem + lay.hg);

  const int m0 = blockIdx.x * FF_BM;
  const int warp = threadIdx.x / 32;
  const int wr = (warp % 2) * 16;  // stage-1 rows of this warp
  const int wc = (warp / 2) * 32;  // stage-1 columns of this warp
  const int k32 = lay.ldx - 8;
  const bf16* wg = w1 + (long)N * K;

  // x block resident for the whole inner loop (zero columns past K)
  load_tile(xs, lay.ldx, x, K, FF_BM, k32, m0, 0, M, K);
  for (int i = threadIdx.x; i < FF_BM * lay.lda; i += FF_THREADS)
    acc[i] = 0.0f;
  __syncthreads();

  for (int n0 = 0; n0 < N; n0 += FF_BN) {
    // ---- stage 1: the value and gate halves of this N chunk, fp32 ----
    FragC av[2], ag[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::fill_fragment(av[j], 0.0f);
      wmma::fill_fragment(ag[j], 0.0f);
    }
    for (int k0 = 0; k0 < k32; k0 += FF_KC) {
      load_tile(wvs, LDW, w1, K, FF_BN, FF_KC, n0, k0, N, K);
      load_tile(wgs, LDW, wg, K, FF_BN, FF_KC, n0, k0, N, K);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < FF_KC; kk += 16) {
        FragA a;
        wmma::load_matrix_sync(a, xs + wr * lay.ldx + k0 + kk, lay.ldx);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          FragBt bv, bg;
          wmma::load_matrix_sync(bv, wvs + (wc + j * 16) * LDW + kk, LDW);
          wmma::load_matrix_sync(bg, wgs + (wc + j * 16) * LDW + kk, LDW);
          wmma::mma_sync(av[j], a, bv, av[j]);
          wmma::mma_sync(ag[j], a, bg, ag[j]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(hvs + wr * LDH + wc + j * 16, av[j], LDH,
                              wmma::mem_row_major);
      wmma::store_matrix_sync(hgs + wr * LDH + wc + j * 16, ag[j], LDH,
                              wmma::mem_row_major);
    }
    __syncthreads();
    // ---- gate: biases in fp32, exact GELU, cast to bf16 ----
    for (int i = threadIdx.x; i < FF_BM * FF_BN; i += FF_THREADS) {
      const int r = i / FF_BN, c = i % FF_BN, n = n0 + c;
      float g = 0.0f;
      if (n < N) {
        float hv = hvs[r * LDH + c], hg = hgs[r * LDH + c];
        if (b1 != nullptr) {
          hv += __bfloat162float(b1[n]);
          hg += __bfloat162float(b1[N + n]);
        }
        g = hv * gelu_erf(hg);
      }
      gs[r * LDG + c] = __float2bfloat16(g);
    }
    __syncthreads();  // the stage-1 region is free for the W2 chunk
    // ---- stage 2: acc (32 x C) += g (32 x 64) . W2[:, n0:n0+64]^T ----
    load_tile(w2s, LDG, w2, N, C, FF_BN, 0, n0, C, N);
    __syncthreads();
    const int n_tiles = 2 * (C / 16);
    for (int tile = warp; tile < n_tiles; tile += FF_THREADS / 32) {
      const int rg = (tile % 2) * 16, cf = (tile / 2) * 16;
      FragC o;
      wmma::load_matrix_sync(o, acc + rg * lay.lda + cf, lay.lda,
                             wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < FF_BN; kk += 16) {
        FragA a;
        FragBt w;
        wmma::load_matrix_sync(a, gs + rg * LDG + kk, LDG);
        wmma::load_matrix_sync(w, w2s + cf * LDG + kk, LDG);
        wmma::mma_sync(o, a, w, o);
      }
      wmma::store_matrix_sync(acc + rg * lay.lda + cf, o, lay.lda,
                              wmma::mem_row_major);
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < FF_BM * C; i += FF_THREADS) {
    const int r = i / C, c = i % C;
    if (m0 + r < M)
      out[(long)(m0 + r) * C + c] = __float2bfloat16(acc[r * lay.lda + c]);
  }
}

}  // namespace mdk

extern "C" {

// x: (M, K); w1: (2N, K); b1: (2N,) or null; out: (M, N), all bf16
int mdk_geglu(const void* x, const void* w1, const void* b1, void* out, int M,
              int K, int N, void* stream) {
  using mdk::bf16;
  if (M <= 0 || K <= 0 || K % 8 || N <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + mdk::GG_BN - 1) / mdk::GG_BN,
                  (M + mdk::GG_BM - 1) / mdk::GG_BM);
  mdk::geglu_kernel<<<grid, mdk::GG_THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
      static_cast<const bf16*>(b1), static_cast<bf16*>(out), M, K, N);
  return (int)cudaGetLastError();
}

// x: (M, K); w1: (2N, K); b1: (2N,) or null; w2: (C, N); out: (M, C),
// all bf16. C must be a multiple of 16; a width whose shared-memory plan
// exceeds the card's per-block limit fails at the opt-in.
int mdk_ff(const void* x, const void* w1, const void* b1, const void* w2,
           void* out, int M, int K, int N, int C, void* stream) {
  using mdk::bf16;
  if (M <= 0 || K <= 0 || K % 8 || N <= 0 || N % 8 || C <= 0 || C % 16)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = mdk::FFLayout(K, C).bytes;
  cudaError_t e = mdk::allow_smem(mdk::ff_kernel, bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((M + mdk::FF_BM - 1) / mdk::FF_BM);
  mdk::ff_kernel<<<grid, mdk::FF_THREADS, bytes,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
      static_cast<const bf16*>(b1), static_cast<const bf16*>(w2),
      static_cast<bf16*>(out), M, K, N, C);
  return (int)cudaGetLastError();
}

}  // extern "C"
