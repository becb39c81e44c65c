// K2: 3x3 VALID conv, NHWC x HWIO -> NHWC, no bias, float32 accumulation.
//
// Replaces the Pallas TPU kernel vst_tpu/kernels/head_conv.py (_kernel,
// driven by conv3x3_valid_pallas).  In the port it computes the packed
// conv that ReCoNet's 9x9 stem and 9x9 ConvTanh head reduce to after f=4
// polyphase packing (vst_tpu_torch/ops/conv.py::conv2d_polyphase_reflect).
//
// Design against the TPU kernel:
// - The TPU form reads three row-shifted input slabs that XLA slices out
//   beforehand; here each block stages its tile's halo straight from the
//   packed input, once per 64-channel chunk, for all nine taps.
// - bf16 runs on conv3x3_wgmma (conv3x3_wgmma.cuh).  The two main-path
//   shapes differ: the stem is C=48 -> Co=768 (one 48-deep chunk, three
//   output-channel tiles of 256, so each input tile is read three times,
//   by blocks that run together), the head C=768 -> Co=48
//   (a 48-wide tile, no zero columns, of 16 x 16 pixels, so each stage
//   does twice the work of a 128-pixel tile).
// - float32 runs on conv3x3_tf32 (conv3x3_tf32.cuh), the same tiling as
//   3xTF32 wgmma (tiles of at most 192 output channels: the stem's 768 in
//   four, the head's 48 in one), the halo split into tf32 parts in shared
//   memory, the weights by a pre-pass per launch into scratch the wrapper
//   allocates (vst_k2_weight_floats).
// - The packed head carries 1.78x the arithmetic of the 9x9 conv as
//   structural zeros.  That is the JAX package's choice, kept here.
//
// Bound on the H100 at 512^2 batch 8 bf16: 87.0 GFLOP per launch, stem and
// head alike, against about 214 MB for the stem (mostly its output) and
// 221 MB for the head (mostly its 208 MB packed input), so operations
// bound it (0.088 ms at 989 TFLOP/s against 0.066 ms for the bytes); in
// float32 twice the bytes against 0.53 ms at 3xTF32's 495 / 3 TFLOP/s.
#include "conv3x3_tf32.cuh"   // and conv3x3_wgmma.cuh

// Floats of the float32 launch's weight scratch for (C, Co).
extern "C" long long vst_k2_weight_floats(int c, int co) {
  return vst::tf::weight_floats(c, co);
}

// Launch configuration for (C, Co) in bf16 or float32: out = {output-channel
// tile, dynamic shared memory bytes, resident blocks per SM}.  Returns a
// CUDA error code (0 on success).
extern "C" int vst_k2_launch_config(int c, int co, int bf16, int* out) {
  using namespace vst;
  return static_cast<int>(bf16 ? wg::config<false, false, false>(c, co, out)
                               : tf::config<false, false, false>(co, out));
}

// Returns cudaGetLastError() after the launches (0 on success).  bf16 != 0
// selects __nv_bfloat16 (C and Co multiples of 8), else float32 (any C and
// Co), which also takes wsplit, a float32 scratch of
// vst_k2_weight_floats(c, co).
extern "C" int vst_k2_conv3x3_valid(const void* x, const void* w,
                                    void* wsplit, void* y, int n, int hp,
                                    int wp, int c, int co, int bf16,
                                    void* stream) {
  using namespace vst;
  ConvArgs a{x, w, nullptr, nullptr, nullptr, nullptr,
             y, nullptr, hp, wp, hp - 2, wp - 2, c, co};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      bf16 ? wg::launch<false, false, false>(a, n, s)
           : tf::launch<false, false, false>(a, static_cast<float*>(wsplit),
                                             n, s));
}
