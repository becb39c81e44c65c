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
// conv3x3_mma  bfloat16 (serving) on the tensor cores, below.
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


// ---------------------------------------------------------------------------
// conv3x3_mma: bfloat16 on the tensor cores, with mma.sync.m16n8k16
// (bf16 in, float32 accumulate) and the same flags and rounding points.
//
// Block: 256 threads = 8 warps as 4 (pixels) x 2 (channels); tile of
// MM = 128 pixels x MN = 64 output channels; each warp owns 32 x 32.  The
// K loop walks the nine taps and, in each, C in stages of MK = 32, with a
// double-buffered shared-memory ring: the global loads of stage s+1 are in
// flight while stage s is multiplied, so one __syncthreads per stage.
// Operands reach the fragments through ldmatrix (A row-major, B with
// .trans); both tiles are padded by 8 bf16 a row, which makes every
// ldmatrix phase conflict-free.  Needs C % 8 == 0 and Co % 8 == 0 (16-byte
// vector loads; the wrappers check it).  Without TMA, wgmma or a deeper
// pipeline it stays well above the tensor cores' bound.
// ---------------------------------------------------------------------------

constexpr int MM = 128;
constexpr int MN = 64;
constexpr int MK = 32;
constexpr int A_LD = MK + 8;   // bf16 per A row in shared memory (80 bytes)
constexpr int B_LD = MN + 8;   // bf16 per B row (144 bytes)

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <bool REFLECT, bool PROLOGUE, bool STATS>
__global__ void __launch_bounds__(NT) conv3x3_mma(ConvArgs a) {
  __shared__ __align__(16) __nv_bfloat16 As[2][MM][A_LD];
  __shared__ __align__(16) __nv_bfloat16 Bs[2][MK][B_LD];

  using bf16 = __nv_bfloat16;
  const bf16* x = static_cast<const bf16*>(a.x);
  const bf16* w = static_cast<const bf16*>(a.w);
  const int n = blockIdx.z;
  const int p0 = blockIdx.x * MM;
  const int co0 = blockIdx.y * MN;
  const int hw = a.h_out * a.w_out;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const bf16* xn = x + (size_t)n * a.h_in * a.w_in * a.c;
  const int nc = (a.c + MK - 1) / MK;
  const int stages = 9 * nc;

  // Each thread moves two 8-channel vectors of A and one of B per stage.
  uint4 ra[2], rb;
  auto load = [&](int s) {
    const int tap = s / nc, c0 = (s - tap * nc) * MK;
    const int dy = tap / 3, dx = tap % 3;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int e = tid + NT * r;
      const int p = p0 + (e >> 2), c = c0 + (e & 3) * 8;
      ra[r] = make_uint4(0, 0, 0, 0);
      if (p < hw && c < a.c) {
        const int oy = p / a.w_out, ox = p - oy * a.w_out;
        int iy = oy + dy, ix = ox + dx;
        if (REFLECT) {
          iy = reflect1(iy - 1, a.h_in);
          ix = reflect1(ix - 1, a.w_in);
        }
        ra[r] = *reinterpret_cast<const uint4*>(
            xn + ((size_t)iy * a.w_in + ix) * a.c + c);
      }
    }
    const int c = c0 + (tid >> 3), o = co0 + (tid & 7) * 8;
    rb = (c < a.c && o < a.co)
             ? *reinterpret_cast<const uint4*>(w + ((size_t)tap * a.c + c) * a.co + o)
             : make_uint4(0, 0, 0, 0);
  };
  auto store = [&](int s, int buf) {
    const int c0 = (s % nc) * MK;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int e = tid + NT * r;
      const int pix = e >> 2, c = c0 + (e & 3) * 8;
      if (PROLOGUE && p0 + pix < hw && c < a.c) {
        unsigned* u = reinterpret_cast<unsigned*>(&ra[r]);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u[q]));
          const int ch = c + 2 * q;
          const float z0 = __fadd_rn(
              __fmul_rn(__fsub_rn(f.x, a.pro_mean[n * a.c + ch]),
                        a.pro_scale[n * a.c + ch]), a.pro_beta[ch]);
          const float z1 = __fadd_rn(
              __fmul_rn(__fsub_rn(f.y, a.pro_mean[n * a.c + ch + 1]),
                        a.pro_scale[n * a.c + ch + 1]), a.pro_beta[ch + 1]);
          __nv_bfloat162 h = __floats2bfloat162_rn(fmaxf(z0, 0.f), fmaxf(z1, 0.f));
          u[q] = *reinterpret_cast<unsigned*>(&h);
        }
      }
      *reinterpret_cast<uint4*>(&As[buf][pix][(e & 3) * 8]) = ra[r];
    }
    *reinterpret_cast<uint4*>(&Bs[buf][tid >> 3][(tid & 7) * 8]) = rb;
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  load(0);
  store(0, 0);
  __syncthreads();
  for (int s = 0; s < stages; ++s) {
    const int buf = s & 1;
    if (s + 1 < stages) load(s + 1);
#pragma unroll
    for (int ks = 0; ks < MK; ks += 16) {
      unsigned af[2][4], bfr[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldmatrix_x4(af[i], &As[buf][wm * 32 + i * 16 + (lane & 15)]
                              [ks + (lane >> 4) * 8]);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
        ldmatrix_x4_trans(bfr[jj], &Bs[buf][ks + (lane & 7) + ((lane >> 3) & 1) * 8]
                                      [wn * 32 + jj * 16 + (lane >> 4) * 8]);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_bf16(acc[i][j], af[i], bfr[j >> 1][(j & 1) * 2],
                   bfr[j >> 1][(j & 1) * 2 + 1]);
    }
    if (s + 1 < stages) store(s + 1, buf ^ 1);
    __syncthreads();
  }

  // Epilogue.  acc[i][j][q]: pixel row wm*32 + i*16 + lane/4 (+8 for
  // q >= 2), channel wn*32 + j*8 + (lane%4)*2 + (q & 1).
  bf16* y = static_cast<bf16*>(a.y);
  float s1[4][2], s2[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int o = co0 + wn * 32 + j * 8 + (lane & 3) * 2;
    float b0 = 0.f, b1 = 0.f;
    if (STATS && o < a.co) {
      const bf16* bias = static_cast<const bf16*>(a.bias);
      b0 = __bfloat162float(bias[o]);
      b1 = __bfloat162float(bias[o + 1]);
    }
    s1[j][0] = s1[j][1] = s2[j][0] = s2[j][1] = 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = p0 + wm * 32 + i * 16 + (lane >> 2) + h * 8;
        if (p >= hw || o >= a.co) continue;
        const float v0 = acc[i][j][2 * h] + b0;
        const float v1 = acc[i][j][2 * h + 1] + b1;
        s1[j][0] += v0;
        s1[j][1] += v1;
        s2[j][0] += v0 * v0;
        s2[j][1] += v1 * v1;
        *reinterpret_cast<__nv_bfloat162*>(&y[((size_t)n * hw + p) * a.co + o]) =
            __floats2bfloat162_rn(v0, v1);
      }
  }
  if (STATS) {
    // Sum over the 8 row-lanes of the warp (lane bits 2..4), then over the
    // four warps along the pixels through shared memory, in a fixed order.
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int m = 4; m < 32; m <<= 1) {
          s1[j][t] += __shfl_xor_sync(0xffffffffu, s1[j][t], m);
          s2[j][t] += __shfl_xor_sync(0xffffffffu, s2[j][t], m);
        }
    float* red = reinterpret_cast<float*>(&As[0][0][0]);   // [4][2][MN]
    if (lane < 4) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int col = wn * 32 + j * 8 + lane * 2 + t;
          red[(wm * 2 + 0) * MN + col] = s1[j][t];
          red[(wm * 2 + 1) * MN + col] = s2[j][t];
        }
    }
    __syncthreads();
    if (tid < MN && co0 + tid < a.co) {
      float t1 = 0.f, t2 = 0.f;
      for (int r = 0; r < 4; ++r) {
        t1 += red[(r * 2 + 0) * MN + tid];
        t2 += red[(r * 2 + 1) * MN + tid];
      }
      float* pb = a.partial + ((size_t)n * gridDim.x + blockIdx.x) * 2 * a.co;
      pb[co0 + tid] = t1;
      pb[a.co + co0 + tid] = t2;
    }
  }
}

}  // namespace vst
