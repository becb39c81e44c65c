// Shared by K3 (adaattn_fwd.cu) and K4/K5 (adaattn_bwd.cu): bf16 packing,
// the softmax constants, and the pieces of their wgmma bodies: 64 x 64
// bf16 chunks loaded by TMA through 3-D tensor maps with the 128-byte
// swizzle, their descriptors read K-major or N-major, P (or dS) written by
// the threads in the same swizzled K-major layout, the producer's claim of
// a ring slot and the consumers' named barriers; and the 3xTF32 pieces of
// the float32 K3 and K5: the pre-pass split_tf32, 64 x 32 float32 boxes,
// a phase of staged products summed in fresh partials, P as tf32 parts.
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

// Arrives at named barrier id without waiting (its waiters use bar_sync);
// this thread's earlier shared-memory writes are visible to them after.
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
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

// ------------------------------------------------- float32 as 3xTF32
//
// The float32 K3 and K5 run on the tensor cores as 3xTF32: an operand x
// enters as two tf32 parts, big = tf32(x) and small = tf32(x - big), both
// rounded to nearest by cvt.rna (so nothing depends on whether the tensor
// core truncates or rounds a raw float32's low 13 bits), and a product a b
// is a_small b_big + a_big b_small + a_big b_big, small x small dropped
// (about 2^-21 of a product).  tf32's wgmma reads both operands K-major
// from shared memory only, so a pre-pass (split_tf32) writes both parts of
// every operand the rings read, in the orientation the products need, into
// scratch the wrapper allocates.  The tensor core's float32 accumulation
// does not round to nearest, and the error of a long wgmma chain into one
// accumulator grows with its length (PERF.md): every stage of a reduction
// is summed into a fresh partial that the consumer adds in float32.

constexpr int FW = 32;                  // floats per box row (128 bytes)
constexpr int FB = T * FW * 4;          // one 64 x 32 float32 box: 8 KB
constexpr int FSTAGE = 4 * FB;          // [A big | A small | B big | B small]

// Plane of part `small` (0 big, 1 small) of image bi in an operand of P
// planes (P = 1 for an input broadcast over the batch, else b).
__device__ __forceinline__ int plane(int small, int p, int bi) {
  return small * p + (p > 1 ? bi : 0);
}

// Loads one stage: the big and small 64 x 32 boxes of A at (col, a_row)
// and of B at (col, b_row).
__device__ __forceinline__ void load_stage(unsigned dst, unsigned bar,
                                           const CUtensorMap* ma, int pa,
                                           int a_row, const CUtensorMap* mb,
                                           int pb, int b_row, int col,
                                           int bi) {
  wg::tma_load_3d(dst, ma, col, a_row, plane(0, pa, bi), bar);
  wg::tma_load_3d(dst + FB, ma, col, a_row, plane(1, pa, bi), bar);
  wg::tma_load_3d(dst + 2 * FB, mb, col, b_row, plane(0, pb, bi), bar);
  wg::tma_load_3d(dst + 3 * FB, mb, col, b_row, plane(1, pb, bi), bar);
}

// part = A B^T over one stage at b, 3xTF32: the eight small-part products
// first (the first overwrites part), then the four big ones, so that only
// these four are added at the partial sum's full magnitude.
__device__ __forceinline__ void stage_tf32(float (&part)[32], unsigned b) {
#pragma unroll
  for (int ks = 0; ks < FW / 8; ++ks) {
    wg::wgmma_tf32(part, kmajor(b + FB, ks), kmajor(b + 2 * FB, ks), ks > 0);
    wg::wgmma_tf32(part, kmajor(b, ks), kmajor(b + 3 * FB, ks));
  }
#pragma unroll
  for (int ks = 0; ks < FW / 8; ++ks)
    wg::wgmma_tf32(part, kmajor(b, ks), kmajor(b + 2 * FB, ks));
}

// acc = sum over `count` stages of A B^T from a ring of D slots of FSTAGE
// bytes (stage counter g carried across tiles).  Each stage's 12 products
// go into a fresh partial sum that is added to acc in float32 once they
// are done; a slot is released (one arrive per warp) as soon as its
// multiply is.  A second partial sum in flight would not fit the
// registers beside the output accumulators.
template <int D>
__device__ __forceinline__ void phase1_tf32(float (&acc)[32],
                                            unsigned char* ring, unsigned full,
                                            unsigned empty, int& g, int count,
                                            int lane) {
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  for (int t = 0; t < count; ++t, ++g) {
    const int slot = g % D;
    float part[32];
    wg::mbar_wait(full + 8 * slot, (g / D) & 1);
    wg::fence_acc(part);
    wg::wgmma_fence();
    stage_tf32(part, wg::smem_u32(ring + slot * FSTAGE));
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    wg::fence_acc(part);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] += part[i];
    if (lane == 0) wg::mbar_arrive(empty + 8 * slot);
  }
}

// Byte offset in P of the pair of this thread's accumulator positions
// (row 16 wl + g8 + 8 h, columns 8 jj + 2 tq + {0, 1}): P holds per
// 32-column half jj / 4 a big and then a small box of 64 x 32 floats in
// the swizzled K-major layout of TMA's boxes.
__device__ __forceinline__ int p_offset(int wl, int g8, int tq, int jj,
                                        int h) {
  const int r = 16 * wl + g8 + 8 * h;
  return (jj >> 2) * 2 * FB + r * 128 +
         ((((2 * (jj & 3) + (tq >> 1)) ^ g8) << 4) | ((tq & 1) * 8));
}

// Writes (x0, x1) at offset `off` of P as tf32 parts, big and small.
__device__ __forceinline__ void store_p_tf32(unsigned char* P, int off,
                                             float x0, float x1) {
  uint2 big, small;
  wg::tf32_split(x0, &big.x, &small.x);
  wg::tf32_split(x1, &big.y, &small.y);
  *reinterpret_cast<uint2*>(P + off) = big;
  *reinterpret_cast<uint2*>(P + off + FB) = small;
}

// The pre-pass: one operand, (planes, rows, cols) float32 with rows
// contiguous and planes `stride` apart, into dst (2, planes, drows, dcols)
// as big and small tf32 parts, zero past the source.  Mode 0 copies, 1
// squares first (W = V o V, in float32), 2 transposes (drows = cols, dcols
// >= rows), 3 squares and transposes (W^T).  Block 32 x 8 threads per 32 x
// 32 tile of dst; grid (dcols / 32, drows / 32, planes), rounded up.
struct SplitJob {
  const float* src;
  long long stride;
  int rows, cols;
  float* dst;
  int drows, dcols, planes, mode;
};

__global__ void __launch_bounds__(256) split_tf32(SplitJob j) {
  __shared__ float tile[32][33];
  const int c0 = blockIdx.x * 32, r0 = blockIdx.y * 32, pl = blockIdx.z;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const float* src = j.src + pl * j.stride;
  const size_t part = (size_t)j.planes * j.drows * j.dcols;
  float* dst = j.dst + (size_t)pl * j.drows * j.dcols;
  const bool transpose = j.mode >= 2;
  if (transpose) {   // tile[src row - c0][src col - r0]
    for (int r = ty; r < 32; r += 8) {
      const int sr = c0 + r, sc = r0 + tx;
      tile[r][tx] = sr < j.rows && sc < j.cols
                        ? src[(size_t)sr * j.cols + sc] : 0.f;
    }
    __syncthreads();
  }
  for (int r = ty; r < 32; r += 8) {
    const int row = r0 + r, col = c0 + tx;
    if (row >= j.drows || col >= j.dcols) continue;
    float x = transpose ? tile[tx][r]
                        : col < j.cols ? src[(size_t)row * j.cols + col] : 0.f;
    if (j.mode & 1) x *= x;
    unsigned big, small;
    wg::tf32_split(x, &big, &small);
    dst[(size_t)row * j.dcols + col] = __uint_as_float(big);
    dst[part + (size_t)row * j.dcols + col] = __uint_as_float(small);
  }
}

// N split operands one after another from base (nullptr: sizes only):
// their pre-pass jobs, the scratch's total size in floats, and the launch
// of the pre-pass with each operand's tensor map over its parts.
template <int N>
struct SplitLayout {
  SplitJob job[N];
  long long total = 0;
  SplitLayout(const SplitJob (&spec)[N], float* base) {
    for (int i = 0; i < N; ++i) {
      job[i] = spec[i];
      job[i].dst = base ? base + total : nullptr;
      total += 2LL * job[i].planes * job[i].drows * job[i].dcols;
    }
  }
  cudaError_t run(CUtensorMap* const (&maps)[N], cudaStream_t s) const {
    for (const SplitJob& j : job) {
      const dim3 grid((j.dcols + 31) / 32, (j.drows + 31) / 32, j.planes);
      split_tf32<<<grid, dim3(32, 8), 0, s>>>(j);
    }
    cudaError_t e = cudaGetLastError();
    for (int i = 0; i < N && e == cudaSuccess; ++i)
      e = chunk_map_f32(maps[i], job[i].dst, job[i].dcols, job[i].drows,
                        2 * job[i].planes);
    return e;
  }
};

}  // namespace attn
