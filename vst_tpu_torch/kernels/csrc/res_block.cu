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
//   its partial sums to a (N, blocks, 2, Co) part of a workspace and
//   finalize_stats sums them in a fixed order: deterministic, no
//   atomics.  The block count and the workspace's size come from
//   vst_k1_partial_blocks and vst_k1_work_floats.
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
//   per launch into a (part, tap, Co, C) part of the workspace, and
//   every (32-channel chunk, tap) stage is a fresh partial added in
//   float32.
// - The prologue's mean, scale = gamma * rsqrt(var + eps) and beta come
//   from one small launch (prologue_params) on the previous conv's stats,
//   or, in the narrow bf16 K1 (Co <= 64), from the threads that stage the
//   halo.
//
// Bound on the H100 at the main path's shape ((8,128,128,192) -> 192):
// 87.0 GFLOP against about 101 MB in bf16 (0.088 ms at 989 TFLOP/s) and
// 202 MB in float32 (0.53 ms at 3xTF32's 495 / 3 TFLOP/s): both are bound
// by operations.  The bf16 body reaches about half of that rate: its
// consumers keep wgmma busy, and what is left is the tensor cores' rate on
// this tile shape plus the epilogue (PERF.md).  At RTNSTV's (8,90,160,48)
// -> 48 the bound is bytes, 22.1 MB (0.0066 ms at 3.35 TB/s) against 4.78
// GFLOP; at SD1/SD2's (8,128,128,64) -> 64, 33.6 MB (0.0100 ms).  There a
// launch's fixed costs and the host's call weigh as much as the conv, so
// the narrow body takes 16 x 16-pixel tiles and derives the prologue's
// parameters itself: two launches a call (conv3x3_wgmma.cuh).
#include "conv3x3_tf32.cuh"      // and conv3x3_wgmma.cuh
#include "res_block_common.cuh"   // finalize_stats, prologue_params, k1_run

// The number of partial-sum blocks per image that vst_k1_conv3x3_in_stats
// writes for an (h, wd) image from C to Co channels: one per 8 x 16 tile,
// or per 16 x 16 tile in the narrow bf16 K1.
extern "C" int vst_k1_partial_blocks(int h, int wd, int c, int co, int bf16) {
  return vst::k1_blocks(h, wd, c, co, bf16 != 0);
}

// Floats of the float32 workspace a call needs (vst::k1_work): the
// partial sums and what the launch needs beside them.
extern "C" long long vst_k1_work_floats(int n, int h, int wd, int c, int co,
                                        int bf16, int prologue) {
  return vst::k1_work(n, h, wd, c, co, bf16 != 0, prologue != 0).total;
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
// stats_in == nullptr means no prologue; else stats_in (n, 2, c) float32
// and gamma and beta (c,) float32 or, with gb_bf16, bf16.  bf16 != 0
// selects __nv_bfloat16 storage (C and Co multiples of 8), else float32
// (any C and Co).  stats: (n, 2, co) float32, the (mean, var); work:
// vst_k1_work_floats(...) float32 whose contents need not survive; device:
// the tensors' card, whose current stream is stream.
extern "C" int vst_k1_conv3x3_in_stats(
    const void* x, const void* w, const void* b, const void* stats_in,
    const void* gamma, const void* beta, int gb_bf16, void* y, void* stats,
    void* work, int n, int h, int wd, int c, int co, int bf16, int device,
    void* stream) {
  return vst::k1_run<true>(x, w, b, stats_in, gamma, beta, gb_bf16, y, stats,
                           work, n, h, wd, c, co, bf16, device, stream);
}
