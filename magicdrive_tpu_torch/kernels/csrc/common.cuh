// Shared pieces of the hand-written Hopper kernels and the error convention
// of their plain C entry points: each returns the cudaError_t of its launch,
// or cudaErrorInvalidValue for a shape or a pointer it does not take, and the
// Python wrapper raises on anything but 0.
//  * WMMA fragments (m16n16k16, bf16 in, fp32 accumulate) and a zero-filling
//    synchronous tile loader, for attend_tile;
//  * the exact GELU of K3/K4 (geglu.cu, on the wgmma pieces of
//    wgmma_tile.cuh);
//  * attend_tile, the projection-fused attention core of K7, K8 and the K8
//    pair (fused_out_attention.cu): WMMA on 64-row tiles, logits, p and the
//    o accumulator in shared memory. K1 and K2 left it for the register-tile
//    core of proj_attend.cuh, which the K8 pair and K8 can take over;
//  * the declaration of the k/v projection (kvstat_attention.cu) that K1,
//    K2, K7, K8 and the K8 pair share.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cmath>
#include <cstddef>
#include <cstdint>
#include <initializer_list>

namespace mdk {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
// B operand read from a row-major (N, K) matrix: element (k, n) at n*ld + k
using FragBt = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
// B operand read from a row-major (K, N) matrix: element (k, n) at k*ld + n
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__host__ __device__ constexpr size_t align128(size_t x) {
  return (x + 127) & ~size_t(127);
}

// Copy the rows x cols window at (row0, col0) of a row-major bf16 matrix
// with leading dimension lds into shared memory (leading dimension ldd),
// writing zeros wherever the global row is >= row_end or the column is >=
// col_end. 16-byte vector copies where the whole vector is in range and
// aligned, element copies otherwise. cols and ldd are multiples of 8.
static __device__ __forceinline__ void load_tile(
    bf16* dst, int ldd, const bf16* src, long lds, int rows, int cols,
    int row0, int col0, int row_end, int col_end) {
  const int vpr = cols / 8;  // vectors per row
  const bf16 zero = __float2bfloat16(0.0f);
  for (int i = threadIdx.x; i < rows * vpr; i += blockDim.x) {
    const int r = i / vpr;
    const int c = (i % vpr) * 8;
    const int gr = row0 + r;
    const int gc = col0 + c;
    bf16* d = dst + r * ldd + c;
    const bf16* s = src + (long)gr * lds + gc;
    if (gr < row_end && gc + 8 <= col_end &&
        (reinterpret_cast<uintptr_t>(s) & 15) == 0) {
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(s);
    } else {
      for (int j = 0; j < 8; ++j)
        d[j] = (gr < row_end && gc + j < col_end) ? s[j] : zero;
    }
  }
}

static __device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

static __device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// exact (erf) GELU, as diffusers' GEGLU and the JAX package compute it
static __device__ __forceinline__ float gelu_erf(float h) {
  return 0.5f * h * (1.0f + erff(h * 0.70710678118654752f));
}

// Whether every non-null pointer is 16-byte aligned (cp.async, uint4).
static inline bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (p != nullptr && (reinterpret_cast<uintptr_t>(p) & 15) != 0)
      return false;
  return true;
}

// Kernels needing more than 48 KB of dynamic shared memory must opt in.
template <typename Kernel>
static cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// ---------------------------------------------------------------------------
// Projection-fused attention core of K7, K8 and the K8 pair.
//
// attend_tile: one (batch, head, 64-row q tile) on four warps of 16 q rows;
// K7/K8 (fused_out_attention.cu) loop it over the heads of a block.
//  1. q = (x_q tile . Wq_h^T) in fp32 over 32-wide chunks of C, times the
//     softmax scale, cast to bf16 (the Pallas kernel's cast points).
//  2. For each of NBR key/value sources: stream 64-row k/v tiles of the
//     (B, H, Lk, D) bf16 workspace, logits in fp32, online softmax with
//     fp32 running max/sum held in registers (every lane keeps its warp's
//     16 rows), p cast to bf16 before PV, fp32 accumulator in shared
//     memory, divided by the sum in fp32 at the end.
//  3. NBR == 2 sums the two normalised outputs in fp32 before the one
//     cast (two separate softmaxes, not a concat attention).
// The head depth D is padded to DP (a multiple of 16) in shared memory
// only: padded weight rows and k/v columns load as zeros.
// ---------------------------------------------------------------------------

constexpr int ATT_BQ = 64;    // q rows per block
constexpr int ATT_BK = 64;    // k/v rows per streamed tile
constexpr int ATT_KC = 32;    // C chunk of the q projection
constexpr int ATT_THREADS = 128;

template <int DP, int NBR>
struct AttnLayout {
  static constexpr int LDX = ATT_KC + 8;
  static constexpr int LDQ = DP + 8;
  static constexpr int LDS = ATT_BK + 4;
  static constexpr int LDP = ATT_BK + 8;
  static constexpr int LDO = DP + 4;
  static constexpr size_t XS = 0;
  static constexpr size_t WS = align128(XS + sizeof(bf16) * ATT_BQ * LDX);
  static constexpr size_t QS = align128(WS + sizeof(bf16) * DP * LDX);
  static constexpr size_t KS = align128(QS + sizeof(bf16) * ATT_BQ * LDQ);
  static constexpr size_t VS = align128(KS + sizeof(bf16) * ATT_BK * LDQ);
  static constexpr size_t SS = align128(VS + sizeof(bf16) * ATT_BK * LDQ);
  static constexpr size_t PS = align128(SS + sizeof(float) * ATT_BQ * LDS);
  static constexpr size_t OS = align128(PS + sizeof(bf16) * ATT_BQ * LDP);
  static constexpr size_t OT = align128(OS + sizeof(float) * ATT_BQ * LDO);
  static constexpr size_t BYTES =
      NBR == 2 ? align128(OT + sizeof(float) * ATT_BQ * LDO) : OT;
};

// NBR == 2: source i reads kv batch (b // n) * n + (b % n + shift_i) % n,
// the ring map over n views. NBR == 1: source 0 is batch b itself.
// Returns the normalised fp32 output tile in shared memory (leading
// dimension AttnLayout::LDO); each warp owns, and may read after it
// returns, its own 16 rows. Called by all ATT_THREADS threads of the block.
template <int DP, int NBR>
__device__ const float* attend_tile(
    unsigned char* smem, const bf16* __restrict__ xq,
    const bf16* __restrict__ wq, const bf16* __restrict__ kws,
    const bf16* __restrict__ vws, int Lq, int C, int Lk, int H, int D,
    float scale, int shift0, int shift1, int n_views, int q0, int h, int b) {
  using Lay = AttnLayout<DP, NBR>;
  bf16* xs = reinterpret_cast<bf16*>(smem + Lay::XS);
  bf16* ws = reinterpret_cast<bf16*>(smem + Lay::WS);
  bf16* qs = reinterpret_cast<bf16*>(smem + Lay::QS);
  bf16* ks = reinterpret_cast<bf16*>(smem + Lay::KS);
  bf16* vs = reinterpret_cast<bf16*>(smem + Lay::VS);
  float* ss = reinterpret_cast<float*>(smem + Lay::SS);
  bf16* ps = reinterpret_cast<bf16*>(smem + Lay::PS);
  float* os = reinterpret_cast<float*>(smem + Lay::OS);
  float* ot = reinterpret_cast<float*>(smem + Lay::OT);  // NBR == 2 only

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * 16;  // this warp's rows within the tile
  constexpr int NF = DP / 16;

  // ---- 1. q tile projection ----
  const bf16* xq_b = xq + (long)b * Lq * C;
  FragC qacc[NF];
#pragma unroll
  for (int j = 0; j < NF; ++j) wmma::fill_fragment(qacc[j], 0.0f);
  for (int k0 = 0; k0 < C; k0 += ATT_KC) {
    load_tile(xs, Lay::LDX, xq_b, C, ATT_BQ, ATT_KC, q0, k0, Lq, C);
    load_tile(ws, Lay::LDX, wq, C, DP, ATT_KC, h * D, k0, h * D + D, C);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < ATT_KC; kk += 16) {
      FragA a;
      wmma::load_matrix_sync(a, xs + r0 * Lay::LDX + kk, Lay::LDX);
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        FragBt w;
        wmma::load_matrix_sync(w, ws + j * 16 * Lay::LDX + kk, Lay::LDX);
        wmma::mma_sync(qacc[j], a, w, qacc[j]);
      }
    }
    __syncthreads();
  }
  // fp32 q through this warp's (not yet used) accumulator rows, scaled, cast
#pragma unroll
  for (int j = 0; j < NF; ++j)
    wmma::store_matrix_sync(os + r0 * Lay::LDO + j * 16, qacc[j], Lay::LDO,
                            wmma::mem_row_major);
  __syncwarp();
  for (int i = lane; i < 16 * DP; i += 32) {
    const int r = r0 + i / DP, c = i % DP;
    qs[r * Lay::LDQ + c] = __float2bfloat16(os[r * Lay::LDO + c] * scale);
  }
  __syncwarp();

  // ---- 2. stream k/v per source ----
  for (int src = 0; src < NBR; ++src) {
    int kb = b;
    if (NBR == 2) {
      const int s = src == 0 ? shift0 : shift1;
      kb = (b / n_views) * n_views + (b % n_views + s) % n_views;
    }
    const bf16* k_src = kws + ((long)kb * H + h) * Lk * D;
    const bf16* v_src = vws + ((long)kb * H + h) * Lk * D;

    float m_r[16], l_r[16];
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      m_r[r] = -INFINITY;
      l_r[r] = 0.0f;
    }
    for (int i = lane; i < 16 * DP; i += 32)
      os[(r0 + i / DP) * Lay::LDO + i % DP] = 0.0f;
    __syncwarp();

    for (int kv0 = 0; kv0 < Lk; kv0 += ATT_BK) {
      __syncthreads();  // every warp is done with the previous k/v tile
      load_tile(ks, Lay::LDQ, k_src, D, ATT_BK, DP, kv0, 0, Lk, D);
      load_tile(vs, Lay::LDQ, v_src, D, ATT_BK, DP, kv0, 0, Lk, D);
      __syncthreads();

      // logits for this warp's 16 rows x 64 keys, fp32
#pragma unroll
      for (int j = 0; j < ATT_BK / 16; ++j) {
        FragC s;
        wmma::fill_fragment(s, 0.0f);
#pragma unroll
        for (int kk = 0; kk < DP; kk += 16) {
          FragA a;
          FragBt kt;
          wmma::load_matrix_sync(a, qs + r0 * Lay::LDQ + kk, Lay::LDQ);
          wmma::load_matrix_sync(kt, ks + j * 16 * Lay::LDQ + kk, Lay::LDQ);
          wmma::mma_sync(s, a, kt, s);
        }
        wmma::store_matrix_sync(ss + r0 * Lay::LDS + j * 16, s, Lay::LDS,
                                wmma::mem_row_major);
      }
      __syncwarp();

      // online softmax, one row at a time across the warp (2 keys a lane)
      const bool ok0 = kv0 + lane < Lk;
      const bool ok1 = kv0 + lane + 32 < Lk;
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

      // o += p . v (fp32 accumulator kept in shared memory)
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        FragC o;
        wmma::load_matrix_sync(o, os + r0 * Lay::LDO + j * 16, Lay::LDO,
                               wmma::mem_row_major);
#pragma unroll
        for (int kk = 0; kk < ATT_BK; kk += 16) {
          FragA a;
          FragB v;
          wmma::load_matrix_sync(a, ps + r0 * Lay::LDP + kk, Lay::LDP);
          wmma::load_matrix_sync(v, vs + kk * Lay::LDQ + j * 16, Lay::LDQ);
          wmma::mma_sync(o, a, v, o);
        }
        wmma::store_matrix_sync(os + r0 * Lay::LDO + j * 16, o, Lay::LDO,
                                wmma::mem_row_major);
      }
      __syncwarp();
    }

    // ---- 3. normalise in fp32 (and sum the two sources) ----
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int row = r0 + r;
      const float inv_l = 1.0f / l_r[r];
      for (int c = lane; c < DP; c += 32) {
        const float o = os[row * Lay::LDO + c] * inv_l;
        if (NBR == 2)
          ot[row * Lay::LDO + c] = src == 0 ? o : ot[row * Lay::LDO + c] + o;
        else
          os[row * Lay::LDO + c] = o;
      }
    }
    __syncwarp();
  }
  return NBR == 2 ? ot : os;
}

// k/v projection into the (B, H, Lk, D) workspace, defined in
// kvstat_attention.cu and shared by K1, K2, K7, K8 and the K8 pair.
cudaError_t launch_kv_project(const bf16* x, const bf16* wk, const bf16* wv,
                              bf16* k, bf16* v, int B, int Lk, int Ck, int H,
                              int D, cudaStream_t stream);

}  // namespace mdk
