// What K1 (res_block.cu) and K2 (head_conv.cu) share: a 3x3 stride-1
// convolution over NHWC activations and HWIO weights as an implicit GEMM
// with float32 accumulation, computed by one of two bodies on the tensor
// cores with wgmma:
//
// conv3x3_tf32   float32 (the parity dtype) as 3xTF32, in conv3x3_tf32.cuh.
// conv3x3_wgmma  bfloat16 (serving), in conv3x3_wgmma.cuh.
//
// Flags shared by both:
// REFLECT: the input is the unpadded (H, W) tensor and the reflect-pad-1
//          halo is resolved by index (row -1 reads row 1, row H reads H-2);
//          no padded copy exists.  Otherwise the input is (Ho+2, Wo+2) and
//          the conv is VALID.
// PROLOGUE: each input value v becomes relu((v - mean) * scale + beta),
//          rounded to the storage type, before it enters the product
//          (the normalize+relu of the previous instance norm).
// STATS:   adds the bias, then writes this block's per-channel sums of y
//          and y*y, taken from the float32 accumulator before y is
//          rounded to the storage type, into partial[n][tile][2][Co].
//          A second launch (finalize_stats) reduces them in a fixed order:
//          the result does not change from run to run.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace vst {

struct ConvArgs {
  const void* x;            // (N, h_in, w_in, C) float32 or bfloat16
  const void* w;            // (3, 3, C, Co), same type
  const void* bias;         // (Co,), same type, STATS only
  const float* pro_mean;    // (N, C), PROLOGUE only
  const float* pro_scale;   // (N, C) = gamma * rsqrt(var + eps)
  const float* pro_beta;    // (C,)
  void* y;                  // (N, h_out, w_out, Co), same type
  float* partial;           // (N, tiles, 2, Co), STATS only
  int h_in, w_in, h_out, w_out, c, co;
};

__device__ __forceinline__ int reflect1(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

}  // namespace vst
