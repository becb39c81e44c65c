// K2: 3x3 VALID conv, NHWC x HWIO -> NHWC, no bias, float32 accumulation.
//
// Replaces the Pallas TPU kernel vst_tpu/kernels/head_conv.py (_kernel,
// driven by conv3x3_valid_pallas).  In the port it computes the packed
// conv that ReCoNet's 9x9 stem and 9x9 ConvTanh head reduce to after f=4
// polyphase packing (vst_tpu_torch/ops/conv.py::conv2d_polyphase_reflect).
//
// Design against the TPU kernel:
// - The TPU form reads three row-shifted input slabs that XLA slices out
//   beforehand; here each block reads its halo rows straight from the
//   packed input.
// - The two main-path shapes differ: the stem is C=48 -> Co=768, the head
//   C=768 -> Co=48.  One tile (128 pixels x 64 channels on the tensor
//   cores, C in stages of 32) serves both; ragged channel edges are masked
//   to zero, so the head's 48 channels use 3/4 of the tile.
// - The packed head carries 1.78x the arithmetic of the 9x9 conv as
//   structural zeros.  That is the JAX package's choice, kept here.
//
// Bound on the H100 at 512^2 batch 8 bf16: 87.0 GFLOP per launch, stem and
// head alike, against about 214 MB for the stem (mostly its output) and
// 221 MB for the head (mostly its 208 MB packed input), so operations
// bound it (0.088 ms at 989 TFLOP/s against 0.066 ms for the bytes).  bf16
// runs on the tensor cores with mma.sync (conv3x3_mma), float32 on the CUDA
// cores (conv3x3_f32).
#include "conv3x3_tile.cuh"

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int vst_k2_conv3x3_valid(const void* x, const void* w, void* y,
                                    int n, int hp, int wp, int c, int co,
                                    int bf16, void* stream) {
  using namespace vst;
  const int ho = hp - 2, wo = wp - 2;
  ConvArgs a{x, w, nullptr, nullptr, nullptr, nullptr,
             y, nullptr, hp, wp, ho, wo, c, co};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {   // tensor cores; C and Co multiples of 8
    const dim3 grid((ho * wo + MM - 1) / MM, (co + MN - 1) / MN, n);
    conv3x3_mma<false, false, false><<<grid, NT, 0, s>>>(a);
  } else {      // float32 on the CUDA cores
    const dim3 grid((ho * wo + TM - 1) / TM, (co + TN - 1) / TN, n);
    conv3x3_f32<false, false, false><<<grid, NT, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
