// Shared by K3 (adaattn_fwd.cu) and K4/K5 (adaattn_bwd.cu): bf16 packing,
// the softmax constants, and the pieces of their wgmma bodies: 64 x 64
// bf16 chunks (and the f32 K5's 64 x 32 float32 ones) loaded by TMA
// through 3-D tensor maps with the 128-byte swizzle, their descriptors
// read K-major or N-major, P (or dS) written by the threads in the same
// swizzled K-major layout, the producer's claim of a ring slot and the
// consumers' named barriers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "wgmma.cuh"   // mbarriers, TMA, wgmma, encode_tiled

namespace attn {

namespace wg = vst::wg;

using bf16 = __nv_bfloat16;

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float NEG = -1e30f;   // masked score, as the TPU kernels' NEG_INF

constexpr int T = 64;           // rows of a tile, keys of a key tile, chunk width
constexpr int CB = T * T * 2;   // one 64 x 64 bf16 chunk: 8 KB

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&h);
}

// (x, y) -> (x*x, y*y) of a bf16 pair, squared in float32 and rounded to bf16
__device__ __forceinline__ unsigned square_bf16x2(unsigned u) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
  return pack_bf16(f.x * f.x, f.y * f.y);
}

// Descriptors of a 64 x 64 chunk (rows 128 bytes apart, 8-row groups 1024
// apart, 128-byte swizzle) at k16 step ks: read K-major (the step moves 32
// bytes along the row) or N-major (the chunk's rows are K: 16 rows a step;
// a B wider than 64 columns continues in the next chunk, CB bytes on).
__device__ __forceinline__ uint64_t kmajor(unsigned base, int ks) {
  return wg::desc(base + ks * 32, 16, 1024, 1);
}
__device__ __forceinline__ uint64_t nmajor(unsigned base, int ks) {
  return wg::desc(base + ks * 16 * 128, CB, 1024, 1);
}

// acc (64 x 64) += X Y^T over one chunk: X and Y both 64 rows, K-major.
__device__ __forceinline__ void mma_xyt(float (&acc)[32], unsigned x,
                                        unsigned y) {
#pragma unroll
  for (int ks = 0; ks < T / 16; ++ks)
    wg::wgmma_bf16<64, wg::B_KMAJOR>(acc, kmajor(x, ks), kmajor(y, ks));
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// Writes the pair (x0, x1) of this thread's accumulator positions (row
// 16 wl + g8 + 8 h, columns 8 jj + 2 tq + {0, 1}) into the 64 x 64 bf16
// chunk P in the swizzled K-major layout.
__device__ __forceinline__ void store_p(unsigned char* P, int wl, int g8,
                                        int tq, int jj, int h, float x0,
                                        float x1) {
  const int r = 16 * wl + g8 + 8 * h;
  *reinterpret_cast<unsigned*>(P + r * 128 + (((jj ^ g8) << 4) | (tq * 4))) =
      pack_bf16(x0, x1);
}

// The producer's side of one ring: waits for slot g % D to be empty, then
// asks for `bytes` on its full barrier.  Returns the slot.
template <int D>
__device__ __forceinline__ int claim(unsigned full, unsigned empty, int g,
                                     unsigned bytes) {
  const int slot = g % D;
  wg::mbar_wait(empty + 8 * slot, ((g / D) & 1) ^ 1);
  wg::mbar_expect_tx(full + 8 * slot, bytes);
  return slot;
}

// A 3-D tensor map over a bf16 (planes, rows, cols) tensor with a plane
// stride in elements (0: one plane, broadcast), read in 64 x 64 boxes with
// the 128-byte swizzle; whatever lies outside arrives as zeros.
inline cudaError_t chunk_map(CUtensorMap* map, const void* base, int cols,
                             int rows, int planes, long long plane_stride) {
  wg::EncodeTiled enc = wg::encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  const bool one = plane_stride == 0;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(one ? 1 : planes)};
  const cuuint64_t strides[2] = {
      static_cast<cuuint64_t>(cols) * 2,
      static_cast<cuuint64_t>(one ? static_cast<long long>(rows) * cols
                                  : plane_stride) * 2};
  const cuuint32_t box[3] = {T, T, 1};
  const cuuint32_t estride[3] = {1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                         const_cast<void*>(base), dims, strides, box, estride,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A 3-D tensor map over a contiguous float32 (planes, rows, cols) tensor,
// cols a multiple of 4 (16-byte rows), read in boxes of 64 rows x 32
// floats (128 bytes) with the 128-byte swizzle: the tf32 operand chunks.
inline cudaError_t chunk_map_f32(CUtensorMap* map, const void* base, int cols,
                                 int rows, int planes) {
  wg::EncodeTiled enc = wg::encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(planes)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cols) * 4,
                                 static_cast<cuuint64_t>(rows) * cols * 4};
  const cuuint32_t box[3] = {32, T, 1};
  const cuuint32_t estride[3] = {1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                         const_cast<void*>(base), dims, strides, box, estride,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace attn
