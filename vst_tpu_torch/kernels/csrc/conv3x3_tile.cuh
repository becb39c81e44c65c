// Shared body of K1 (res_block.cu) and K2 (head_conv.cu): a 3x3 stride-1
// convolution over NHWC activations and HWIO weights as an implicit GEMM
// with float32 accumulation.  Two kernels compute it:
//
// conv3x3_f32  float32 on the CUDA cores (the parity dtype: exact float32,
//              no TF32).  One block of 256 threads owns TM = 64 output
//              pixels (flattened over one image's H*W) by TN = 64 output
//              channels; it walks the nine taps and, in each, the input
//              channels in stages of TK = 32, staged in shared memory, and
//              every thread accumulates a 4 x 4 register tile (pixels
//              ty + 16 i, channels tx + 16 j, so neighbouring threads store
//              neighbouring channels of one NHWC pixel).
// conv3x3_wgmma  bfloat16 (serving) on the tensor cores with wgmma, in
//               conv3x3_wgmma.cuh.
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
//          rounded to the storage type, into partial[n][blockIdx.x][2][Co].
//          A second launch (finalize_stats) reduces them in a fixed order:
//          the result does not change from run to run.
//
// What bounds conv3x3_f32 on the H100: the FMA rate of the CUDA cores
// (67 TFLOP/s float32 at most) and the shared-memory reads of its inner
// loop (8 loads for 16 FMAs).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace vst {

constexpr int TM = 64;    // output pixels per block
constexpr int TN = 64;    // output channels per block
constexpr int TK = 32;    // input channels per shared-memory stage
constexpr int NT = 256;   // threads per block (16 x 16, 4 x 4 outputs each)

struct ConvArgs {
  const void* x;            // (N, h_in, w_in, C) float32 or bfloat16
  const void* w;            // (3, 3, C, Co), same type
  const void* bias;         // (Co,), same type, STATS only
  const float* pro_mean;    // (N, C), PROLOGUE only
  const float* pro_scale;   // (N, C) = gamma * rsqrt(var + eps)
  const float* pro_beta;    // (C,)
  void* y;                  // (N, h_out, w_out, Co), same type
  float* partial;           // (N, gridDim.x, 2, Co), STATS only
  int h_in, w_in, h_out, w_out, c, co;
};

__device__ __forceinline__ int reflect1(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

template <bool REFLECT, bool PROLOGUE, bool STATS>
__global__ void __launch_bounds__(NT) conv3x3_f32(ConvArgs a) {
  __shared__ float As[TK][TM + 1];   // +1: the transposed store is conflict-free
  __shared__ float Bs[TK][TN];

  const float* x = static_cast<const float*>(a.x);
  const float* w = static_cast<const float*>(a.w);
  const int n = blockIdx.z;
  const int p0 = blockIdx.x * TM;
  const int co0 = blockIdx.y * TN;
  const int hw = a.h_out * a.w_out;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const float* xn = x + (size_t)n * a.h_in * a.w_in * a.c;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3, dx = tap % 3;
    for (int c0 = 0; c0 < a.c; c0 += TK) {
      // Input slab: 32 neighbouring threads read 32 neighbouring channels
      // of one pixel.
#pragma unroll
      for (int r = 0; r < (TM * TK) / NT; ++r) {
        const int e = tid + NT * r;
        const int pix = e / TK, kk = e % TK;
        const int p = p0 + pix, cc = c0 + kk;
        float v = 0.f;
        if (p < hw && cc < a.c) {
          const int oy = p / a.w_out, ox = p - oy * a.w_out;
          int iy = oy + dy, ix = ox + dx;
          if (REFLECT) {
            iy = reflect1(iy - 1, a.h_in);
            ix = reflect1(ix - 1, a.w_in);
          }
          v = xn[((size_t)iy * a.w_in + ix) * a.c + cc];
          if (PROLOGUE) {
            // no FMA contraction: the same roundings as the plain version
            const float z = __fadd_rn(
                __fmul_rn(__fsub_rn(v, a.pro_mean[n * a.c + cc]),
                          a.pro_scale[n * a.c + cc]),
                a.pro_beta[cc]);
            v = fmaxf(z, 0.f);
          }
        }
        As[kk][pix] = v;
      }
      // Weight slab: neighbouring threads read neighbouring output channels.
#pragma unroll
      for (int r = 0; r < (TK * TN) / NT; ++r) {
        const int e = tid + NT * r;
        const int kk = e / TN, j = e % TN;
        const int cc = c0 + kk, o = co0 + j;
        Bs[kk][j] = (cc < a.c && o < a.co)
                        ? w[((size_t)tap * a.c + cc) * a.co + o]
                        : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < TK; ++kk) {
        float av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = As[kk][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  float* y = static_cast<float*>(a.y);
  float bias[4], s[4], s2[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int o = co0 + tx + 16 * j;
    bias[j] = (STATS && o < a.co)
                  ? static_cast<const float*>(a.bias)[o] : 0.f;
    s[j] = 0.f;
    s2[j] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = p0 + ty + 16 * i;
    if (p >= hw) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = co0 + tx + 16 * j;
      if (o >= a.co) continue;
      const float v = acc[i][j] + bias[j];
      s[j] += v;
      s2[j] += v * v;
      y[((size_t)n * hw + p) * a.co + o] = v;
    }
  }
  if (STATS) {
    // Sum the 16 row-threads of each channel through shared memory (the
    // staging buffers are free after the last __syncthreads above).
    float* red = &As[0][0];    // 16 x TN sums of y
    float* red2 = &Bs[0][0];   // 16 x TN sums of y*y
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      red[ty * TN + tx + 16 * j] = s[j];
      red2[ty * TN + tx + 16 * j] = s2[j];
    }
    __syncthreads();
    if (tid < TN && co0 + tid < a.co) {
      float t = 0.f, t2 = 0.f;
      for (int r = 0; r < 16; ++r) {
        t += red[r * TN + tid];
        t2 += red2[r * TN + tid];
      }
      float* pb = a.partial + ((size_t)n * gridDim.x + blockIdx.x) * 2 * a.co;
      pb[co0 + tid] = t;
      pb[a.co + co0 + tid] = t2;
    }
  }
}

}  // namespace vst
