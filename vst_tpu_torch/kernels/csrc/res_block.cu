// K1: 3x3 conv with reflect padding, bias and per-image instance-norm
// statistics in its epilogue, with an optional normalize+relu prologue.
//
// Replaces the Pallas TPU kernel vst_tpu/kernels/res_block.py
// (_conv_stats_kernel, driven by conv3x3_in_stats).  Two launches and an
// elementwise tail in torch make one ReCoNet residual block
// (vst_tpu_torch/kernels/res_block.py::residual_block_fused).
//
// Design against the TPU kernel:
// - Reflect padding is resolved by index inside the kernel; the JAX form
//   materialises the padded tensor plus three row-shifted slabs.  A row
//   shard of an H-sharded frame takes res_block_halo.cu's halo-rows mode
//   instead, whose input carries its neighbours' rows.
// - The TPU carried the sum / sum-of-squares accumulator across its
//   sequential grid.  Hopper blocks run in no order, so each block writes
//   its partial sums to a (N, blocks, 2, Co) scratch and finalize_stats
//   sums them in a fixed order: deterministic, no atomics.  The block
//   count comes from vst_k1_partial_blocks, which the wrapper calls to
//   size the scratch.
// - Rounding points follow JAX: the prologue output is rounded to the
//   storage type before the conv; the statistics come from the float32
//   accumulator before y is rounded.
// - var = sum(y^2)/hw - mean^2, as the JAX kernel computes it (for parity).
//   This form can cancel when |mean| is large against the spread.
// - bf16 runs on conv3x3_wgmma (conv3x3_wgmma.cuh): one tile holds all
//   192 output channels of 128 pixels, so the input is read and the
//   prologue applied once per pixel per 64-channel chunk; a 192->192 3x3
//   weight tensor (648 KB) streams through a TMA ring of 64 x 192 stages.
// - float32 runs on conv3x3_tf32 (conv3x3_tf32.cuh), the same tiling as
//   3xTF32 wgmma: the halo is split into tf32 parts in shared memory by the
//   threads that staged it (after the prologue), the weights by a pre-pass
//   per launch into (part, tap, Co, C) scratch the wrapper allocates
//   (vst_k1_weight_floats), and every (32-channel chunk, tap) stage is a
//   fresh partial added in float32.
// - The prologue's mean, scale = gamma * rsqrt(var + eps) and beta come
//   from one small launch (prologue_params) on the previous conv's stats.
//
// Bound on the H100 at the main path's shape ((8,128,128,192) -> 192):
// 87.0 GFLOP against about 101 MB in bf16 (0.088 ms at 989 TFLOP/s) and
// 202 MB in float32 (0.53 ms at 3xTF32's 495 / 3 TFLOP/s): both are bound
// by operations.  The bf16 body reaches about half of that rate: its
// consumers keep wgmma busy, and what is left is the tensor cores' rate on
// this tile shape plus the epilogue (PERF.md).
#include "conv3x3_tf32.cuh"      // and conv3x3_wgmma.cuh
#include "res_block_common.cuh"   // finalize_stats, prologue_params, k1_run

// The number of partial-sum blocks per image that vst_k1_conv3x3_in_stats
// writes for an (h, wd) image, in both dtypes (one per 8 x 16 tile): the
// scratch is (n, this, 2, co) float32.
extern "C" int vst_k1_partial_blocks(int h, int wd) {
  return vst::wg::tiles(h, wd);
}

// Floats of the float32 launch's weight scratch for (C, Co).
extern "C" long long vst_k1_weight_floats(int c, int co) {
  return vst::tf::weight_floats(c, co);
}

// Launch configuration for (C, Co) in bf16 or float32: out = {output-channel
// tile, dynamic shared memory bytes, resident blocks per SM}.  Returns a
// CUDA error code (0 on success).
extern "C" int vst_k1_launch_config(int c, int co, int prologue, int bf16,
                                    int* out) {
  using namespace vst;
  if (bf16)
    return static_cast<int>(prologue ? wg::config<true, true, true>(c, co, out)
                                     : wg::config<true, false, true>(c, co, out));
  return static_cast<int>(prologue ? tf::config<true, true, true>(co, out)
                                   : tf::config<true, false, true>(co, out));
}

// Returns cudaGetLastError() after the launches (0 on success).
// stats_in == nullptr means no prologue; else stats_in (n, 2, c) float32,
// gamma and beta (c,) float32 or, with gb_bf16, bf16, and pro a float32
// scratch of 2 * n * c + c.  bf16 != 0 selects __nv_bfloat16 storage (C
// and Co multiples of 8), else float32 (any C and Co), which also takes
// wsplit, a float32 scratch of vst_k1_weight_floats(c, co).  partial: (n,
// vst_k1_partial_blocks(h, wd), 2, co) float32.
extern "C" int vst_k1_conv3x3_in_stats(
    const void* x, const void* w, const void* b, const void* stats_in,
    const void* gamma, const void* beta, int gb_bf16, void* pro, void* wsplit,
    void* y, void* partial, void* stats, int n, int h, int wd, int c, int co,
    int bf16, void* stream) {
  return vst::k1_run<true>(x, w, b, stats_in, gamma, beta, gb_bf16, pro,
                           wsplit, y, partial, stats, n, h, wd, c, co, bf16,
                           stream);
}
