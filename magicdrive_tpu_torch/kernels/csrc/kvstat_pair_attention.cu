// K2: paired-neighbour kv-stationary attention (cross-view "add" mode) for
// Hopper (sm_90a).
//
// Replaces the Pallas kernels magicdrive_tpu/kernels/fused_attention.py
// _fused_kvstat_pair_kernel / _fused_kvstat_pair_group_kernel (launcher
// _kvstat_pair_fwd_impl, entry fused_kvstat_attention_pair):
// o = softmax(q k_1^T) v_1 + softmax(q k_2^T) v_2 with q projected once and
// neighbour i of view v read from view table[i][v] of the same sample. The
// table is any pair of neighbour lists, int32 [2][n_views] in device memory:
// the nuScenes ring is the table (v + s_i) % n, a rig that numbers its
// cameras another way a permutation of it, and two views may share a
// neighbour. The Pallas entry takes a ring as in-grid shifts and any other
// table as gathered x_kv1/x_kv2 copies (shifts=None); here no gathered copy
// exists for any table: both neighbours are views of the same tensor, so the
// wrapper runs K1's projection kernel (mdk_kv_project) once over all views
// and this kernel indexes that one workspace through the table (one read of
// two ints a block). The two outputs come from separate softmaxes and are
// summed in fp32 before the one cast; the caller out-projects the sum with
// the bias counted twice.
//
// Bound. At the 28x50 level (12 views, L=1400, C=320, 8 heads of 40) the
// function needs 70.5 GFLOP: the projections once (10.3 GFLOP), the logits
// and P.V once per neighbour (30.1 GFLOP each), against 22 MB of inputs and
// output: 0.071 ms of operations at the bf16 tensor peak.
//
// Design: kvstat_kernel<DP, 2> of proj_attend.cuh, K1's register-tile core
// with two sources, which answers the six faults of the old WMMA core as
// K1's source note sets out. One block projects its q tile once, keeps it
// in registers for both neighbours, and streams the two neighbours' k/v
// tiles as one ring, so the first tiles of the second neighbour are in
// flight while the first finishes. The first neighbour's normalised o is
// parked once in shared memory (256*DP bytes, each thread its own fragment
// elements) rather than in registers, so K2 keeps K1's register count and
// occupancy: 55,296 B of shared memory a block at DP=48.
#include "proj_attend.cuh"

extern "C" {

// x: (B, L, C) the views' hidden states (q source); k, v: (B, H, L, D)
// projected from x; out: (B, L, H*D) bf16. B must be a multiple of n_views;
// table: int32 [2][n_views] on the device, every entry in [0, n_views).
int mdk_kvstat_attention_pair(const void* x, const void* wq, const void* k,
                              const void* v, void* out, int B, int L, int C,
                              int H, int D, float scale, const void* table,
                              int n_views, void* stream) {
  using mdk::bf16;
  return (int)mdk::launch_kvstat<2>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wq),
      static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), B, L, C, L, H, D, scale,
      static_cast<const int*>(table), n_views,
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
