// Shared by K3 (adaattn_fwd.cu) and K4/K5 (adaattn_bwd.cu): cp.async
// copies into shared memory (K3), bf16 packing, and the softmax constants.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_sync.cuh"   // smem_u32, ldmatrix / mma.sync helpers

namespace attn {

using bf16 = __nv_bfloat16;

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float NEG = -1e30f;   // masked score, as the TPU kernels' NEG_INF

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  // src-size 0 fills the 16 bytes with zeros and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(vst::smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&h);
}

// (x, y) -> (x*x, y*y) of a bf16 pair, squared in float32 and rounded to bf16
__device__ __forceinline__ unsigned square_bf16x2(unsigned u) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
  return pack_bf16(f.x * f.x, f.y * f.y);
}

}  // namespace attn
