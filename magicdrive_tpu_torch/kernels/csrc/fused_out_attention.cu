// K7 and K8: the projection-fused attention with the heads looped inside one
// block, and K8's out-projection fused as its epilogue, for Hopper (sm_90a).
//
// Replaces the Pallas kernels magicdrive_tpu/kernels/fused_attention.py
//  * _fused_kernel (K7; launcher _fused_fwd_impl, entry fused_qkv_attention):
//    o_h = softmax((x_q Wq_h) scale (x_kv Wk_h)^T) (x_kv Wv_h) per head,
//    written as (B, Lq, H*D);
//  * _fused_kernel_out (K8; launcher _fused_fwd_impl with wout, entry
//    fused_qkv_out_attention): y = sum_h bf16(o_h) Wout_h^T, fp32
//    accumulation, one cast, no bias, written as (B, Lq, C_out);
//  * _fused_kernel_out2 (the K8 pair; launcher _pair_fwd_impl, entry
//    fused_qkv_out_attention_pair): per head the two ring neighbours'
//    normalised outputs summed in fp32 before the cast, then as K8.
// One template serves all three, as JAX's share _fused_fwd_impl.
//
// Design. k and v come from K1's projection kernel (mdk_kv_project) in a
// (B, H, Lk, D) workspace: the TPU kernel's per-q-block recompute of k/v is
// a VMEM tile plan, not the contract. Grid (q tiles of 64 rows, B); each
// block loops over the H heads and runs, per head, attend_tile of
// common.cuh (the q-tile projection and the streamed online softmax K1 and
// K2 run). Each o_h goes, cast to bf16, into a 64 x H*D o tile in shared
// memory at columns h*D. K7 writes that tile out. K8 multiplies it by
// Wout^T with WMMA into fp32, 64 output columns at a time, staging Wout
// tiles in the k/v/logit buffers the heads no longer need, and writes bf16
// (B, Lq, C_out): the (B, Lq, H*D) attention output never reaches device
// memory.
//
// Bound. At the 224x400 level 0 (L=1400, C=320, D=40, 8 heads) the logits
// and PV products (4*Lq*Lk*D flops per head) dominate, and the inputs are a
// few MB: the kernel is bound by operations. Its plan does not serve that
// bound well: a block walks its 8 heads in series, so the grid has only
// ceil(Lq/64)*B blocks (264 at level 0 with 12 views, 72 at level 1) at one
// or two blocks per SM for the shared memory of the o tile. That is the
// price of keeping o out of device memory; it is recorded, not tuned.
#include "common.cuh"

namespace mdk {

constexpr int EP_BN = 64;  // output columns per epilogue pass
constexpr int EP_KC = 64;  // H*D chunk per Wout tile
constexpr int EP_LDW = EP_KC + 8;
constexpr int EP_LDS = EP_BN + 4;

// Epilogue scratch inside the attention layout's k/v/logit/p buffers
// (KS..OS), free once the last head is done.
template <int DP, int NBR>
struct EpLayout {
  using Lay = AttnLayout<DP, NBR>;
  static constexpr size_t WT = Lay::KS;
  static constexpr size_t ST = align128(WT + sizeof(bf16) * EP_BN * EP_LDW);
  static_assert(ST + sizeof(float) * ATT_BQ * EP_LDS <= Lay::OS,
                "epilogue scratch overlaps the output accumulator");
};

__host__ __device__ constexpr int ceil64(int x) { return (x + 63) / 64 * 64; }

// the o tile (64 x ceil64(H*D) bf16) follows the attention layout
__host__ __device__ constexpr int otile_ld(int HD) { return ceil64(HD) + 8; }

template <int DP, int NBR>
__host__ __device__ constexpr size_t fused_out_bytes(int HD) {
  return AttnLayout<DP, NBR>::BYTES + sizeof(bf16) * ATT_BQ * otile_ld(HD);
}

template <int DP, int NBR, bool OUT>
__global__ void __launch_bounds__(ATT_THREADS)
fused_out_kernel(const bf16* __restrict__ xq, const bf16* __restrict__ wq,
                 const bf16* __restrict__ kws, const bf16* __restrict__ vws,
                 const bf16* __restrict__ wout, bf16* __restrict__ out,
                 int Lq, int C, int Lk, int H, int D, int C_out, float scale,
                 int shift0, int shift1, int n_views) {
  using Lay = AttnLayout<DP, NBR>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int q0 = blockIdx.x * ATT_BQ, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * 16;
  const int HD = H * D, HDP = ceil64(HD), LDT = otile_ld(HD);
  bf16* ot = reinterpret_cast<bf16*>(smem + Lay::BYTES);

  // the columns past H*D enter the epilogue's products: zeros, not garbage
  const bf16 zero = __float2bfloat16(0.0f);
  for (int i = threadIdx.x; i < ATT_BQ * (HDP - HD); i += ATT_THREADS)
    ot[(i / (HDP - HD)) * LDT + HD + i % (HDP - HD)] = zero;

  for (int h = 0; h < H; ++h) {
    __syncthreads();
    const float* fin = attend_tile<DP, NBR>(smem, xq, wq, kws, vws, Lq, C,
                                            Lk, H, D, scale, shift0, shift1,
                                            n_views, q0, h, b);
    for (int i = lane; i < 16 * D; i += 32) {
      const int r = r0 + i / D, c = i % D;
      ot[r * LDT + h * D + c] = __float2bfloat16(fin[r * Lay::LDO + c]);
    }
  }
  __syncthreads();

  if (!OUT) {  // K7: the o tile to (B, Lq, H*D), 16-byte vectors
    const int vpr = HD / 8;
    for (int i = threadIdx.x; i < ATT_BQ * vpr; i += ATT_THREADS) {
      const int r = i / vpr, c = (i % vpr) * 8;
      if (q0 + r < Lq)
        *reinterpret_cast<uint4*>(out + ((long)b * Lq + q0 + r) * HD + c) =
            *reinterpret_cast<const uint4*>(ot + r * LDT + c);
    }
    return;
  }

  // K8: y = o_tile . Wout^T, Wout (C_out, H*D) row-major
  using Ep = EpLayout<DP, NBR>;
  bf16* wt = reinterpret_cast<bf16*>(smem + Ep::WT);
  float* st = reinterpret_cast<float*>(smem + Ep::ST);
  for (int n0 = 0; n0 < C_out; n0 += EP_BN) {
    FragC acc[EP_BN / 16];
#pragma unroll
    for (int j = 0; j < EP_BN / 16; ++j) wmma::fill_fragment(acc[j], 0.0f);
    for (int k0 = 0; k0 < HDP; k0 += EP_KC) {
      __syncthreads();  // every warp is done with the previous Wout tile
      load_tile(wt, EP_LDW, wout, HD, EP_BN, EP_KC, n0, k0, C_out, HD);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < EP_KC; kk += 16) {
        FragA a;
        wmma::load_matrix_sync(a, ot + r0 * LDT + k0 + kk, LDT);
#pragma unroll
        for (int j = 0; j < EP_BN / 16; ++j) {
          FragBt w;
          wmma::load_matrix_sync(w, wt + j * 16 * EP_LDW + kk, EP_LDW);
          wmma::mma_sync(acc[j], a, w, acc[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < EP_BN / 16; ++j)
      wmma::store_matrix_sync(st + r0 * EP_LDS + j * 16, acc[j], EP_LDS,
                              wmma::mem_row_major);
    __syncwarp();
    for (int i = lane; i < 16 * EP_BN; i += 32) {
      const int r = r0 + i / EP_BN, c = i % EP_BN;
      if (q0 + r < Lq && n0 + c < C_out)
        out[((long)b * Lq + q0 + r) * C_out + n0 + c] =
            __float2bfloat16(st[r * EP_LDS + c]);
    }
    __syncwarp();
  }
}

template <int NBR, bool OUT>
static cudaError_t launch_fused_out(const bf16* xq, const bf16* wq,
                                    const bf16* kws, const bf16* vws,
                                    const bf16* wout, bf16* out, int B,
                                    int Lq, int C, int Lk, int H, int D,
                                    int C_out, float scale, int shift0,
                                    int shift1, int n_views,
                                    cudaStream_t stream) {
  if (B <= 0 || Lq <= 0 || Lk <= 0 || C <= 0 || C % 8 || H <= 0 || D <= 0 ||
      D > 128 || D % 8 || (OUT && C_out <= 0))
    return cudaErrorInvalidValue;
  const dim3 grid((Lq + ATT_BQ - 1) / ATT_BQ, B);
  const int dp = (D + 15) / 16 * 16;
#define MDK_FUSED_CASE(DPV)                                                  \
  case DPV: {                                                                \
    auto kern = fused_out_kernel<DPV, NBR, OUT>;                             \
    const size_t bytes = fused_out_bytes<DPV, NBR>(H * D);                   \
    cudaError_t e = allow_smem(kern, bytes);                                 \
    if (e != cudaSuccess) return e;                                          \
    kern<<<grid, ATT_THREADS, bytes, stream>>>(xq, wq, kws, vws, wout, out,  \
                                               Lq, C, Lk, H, D, C_out,       \
                                               scale, shift0, shift1,        \
                                               n_views);                     \
    return cudaGetLastError();                                               \
  }
  switch (dp) {
    MDK_FUSED_CASE(16)
    MDK_FUSED_CASE(32)
    MDK_FUSED_CASE(48)
    MDK_FUSED_CASE(64)
    MDK_FUSED_CASE(80)
    MDK_FUSED_CASE(96)
    MDK_FUSED_CASE(112)
    MDK_FUSED_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef MDK_FUSED_CASE
}

}  // namespace mdk

extern "C" {

// K7. xq: (B, Lq, C); wq: (H*D, C); k, v: (B, H, Lk, D) from
// mdk_kv_project; out: (B, Lq, H*D) bf16
int mdk_fused_qkv_attention(const void* xq, const void* wq, const void* k,
                            const void* v, void* out, int B, int Lq, int C,
                            int Lk, int H, int D, float scale, void* stream) {
  using mdk::bf16;
  return (int)mdk::launch_fused_out<1, false>(
      static_cast<const bf16*>(xq), static_cast<const bf16*>(wq),
      static_cast<const bf16*>(k), static_cast<const bf16*>(v), nullptr,
      static_cast<bf16*>(out), B, Lq, C, Lk, H, D, 0, scale, 0, 0, 1,
      static_cast<cudaStream_t>(stream));
}

// K8. As K7, with wout: (C_out, H*D); out: (B, Lq, C_out) bf16
int mdk_fused_qkv_out_attention(const void* xq, const void* wq, const void* k,
                                const void* v, const void* wout, void* out,
                                int B, int Lq, int C, int Lk, int H, int D,
                                int C_out, float scale, void* stream) {
  using mdk::bf16;
  return (int)mdk::launch_fused_out<1, true>(
      static_cast<const bf16*>(xq), static_cast<const bf16*>(wq),
      static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(wout), static_cast<bf16*>(out), B, Lq, C, Lk,
      H, D, C_out, scale, 0, 0, 1, static_cast<cudaStream_t>(stream));
}

// The K8 pair. x: (B, L, C) the views' hidden states; k, v: (B, H, L, D)
// projected from x; neighbour i of view b read at batch
// (b // n) * n + (b % n + shift_i) % n; out: (B, L, C_out) bf16
int mdk_fused_qkv_out_attention_pair(const void* x, const void* wq,
                                     const void* k, const void* v,
                                     const void* wout, void* out, int B,
                                     int L, int C, int H, int D, int C_out,
                                     float scale, int shift1, int shift2,
                                     int n_views, void* stream) {
  using mdk::bf16;
  if (n_views <= 0 || B % n_views != 0 || shift1 < 0 || shift2 < 0)
    return (int)cudaErrorInvalidValue;
  return (int)mdk::launch_fused_out<2, true>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wq),
      static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(wout), static_cast<bf16*>(out), B, L, C, L, H,
      D, C_out, scale, shift1, shift2, n_views,
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
