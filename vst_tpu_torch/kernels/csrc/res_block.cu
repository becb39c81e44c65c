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
//   materialises the padded tensor plus three row-shifted slabs.
// - The TPU carried the sum / sum-of-squares accumulator across its
//   sequential grid.  Hopper blocks run in no order, so each block writes
//   its partial sums to a (N, blocks, 2, Co) scratch and finalize_stats
//   sums them in a fixed order: deterministic, no atomics.
// - Rounding points follow JAX: the prologue output is rounded to the
//   storage type before the conv; the statistics come from the float32
//   accumulator before y is rounded.
// - var = sum(y^2)/hw - mean^2, as the JAX kernel computes it (for parity).
//   This form can cancel when |mean| is large against the spread.
// - A 192->192 3x3 weight tensor is 648 KB in bf16: it never sits in
//   shared memory whole; the tile walks Co in blocks of 64 and C in stages
//   of 32 (29.7 KB of static shared memory on the tensor-core path,
//   double-buffered; 16.5 KB on the float32 path).
//
// Bound on the H100 at the main path's shape ((8,128,128,192) -> 192,
// bf16): 87.0 GFLOP against about 101 MB, so the work is bound by
// operations (0.088 ms at 989 TFLOP/s).  bf16 runs on the tensor cores
// with mma.sync (conv3x3_mma); without TMA, wgmma or a deeper pipeline it
// stays well above that bound.  float32 runs on the CUDA cores.
#include "conv3x3_tile.cuh"

namespace vst {

__global__ void finalize_stats(const float* __restrict__ partial,
                               float* __restrict__ stats, int nblk, int co,
                               float hw) {
  const int n = blockIdx.y;
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= co) return;
  float s = 0.f, s2 = 0.f;
  for (int b = 0; b < nblk; ++b) {
    const float* pb = partial + ((size_t)n * nblk + b) * 2 * co;
    s += pb[o];
    s2 += pb[co + o];
  }
  const float mean = s / hw;
  stats[(size_t)n * 2 * co + o] = mean;
  stats[(size_t)n * 2 * co + co + o] = __fsub_rn(s2 / hw, __fmul_rn(mean, mean));
}

// Launches the conv and returns its grid's block count along the pixels
// (the number of partial sums per image): bf16 on the tensor cores,
// float32 on the CUDA cores.
template <bool PRO>
int launch(const ConvArgs& a, int n, bool bf16, cudaStream_t s) {
  const int hw = a.h_out * a.w_out;
  if (bf16) {
    const dim3 grid((hw + MM - 1) / MM, (a.co + MN - 1) / MN, n);
    conv3x3_mma<true, PRO, true><<<grid, NT, 0, s>>>(a);
    return grid.x;
  }
  const dim3 grid((hw + TM - 1) / TM, (a.co + TN - 1) / TN, n);
  conv3x3_f32<true, PRO, true><<<grid, NT, 0, s>>>(a);
  return grid.x;
}

}  // namespace vst

// Returns cudaGetLastError() after the two launches (0 on success).
// pro_mean == nullptr means no prologue.  bf16 != 0 selects __nv_bfloat16
// storage (C and Co multiples of 8), else float32.  partial: (n, ceil(h*wd/64), 2, co) float32, room
// for either path's partial sums.
extern "C" int vst_k1_conv3x3_in_stats(
    const void* x, const void* w, const void* b, const void* pro_mean,
    const void* pro_scale, const void* pro_beta, void* y, void* partial,
    void* stats, int n, int h, int wd, int c, int co, int bf16,
    void* stream) {
  using namespace vst;
  ConvArgs a{x, w, b,
             static_cast<const float*>(pro_mean),
             static_cast<const float*>(pro_scale),
             static_cast<const float*>(pro_beta),
             y, static_cast<float*>(partial), h, wd, h, wd, c, co};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nblk = pro_mean != nullptr ? launch<true>(a, n, bf16 != 0, s)
                                       : launch<false>(a, n, bf16 != 0, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  finalize_stats<<<dim3((co + 127) / 128, n), 128, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(stats), nblk,
      co, static_cast<float>(h * wd));
  return static_cast<int>(cudaGetLastError());
}
