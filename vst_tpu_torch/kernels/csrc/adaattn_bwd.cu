// K4 and K5: the backward of the AdaAttN softmax attention moments (K3).
//
// With S = Q K^T, A = exp(S - L), W = V o V and the row term
// D = sum_c(dM1 o M1 + dM2 o M2) (float32, computed by the caller):
//   dA = dM1 V^T + dM2 W^T,   dS = A o (dA - D)
//   K4:  dQ = dS K
//   K5:  dK = dS^T Q,   dV = A^T dM1 + 2 V o (A^T dM2)
// q (b, n, d), k (b, m, d), v (b, m, c) in bfloat16 or float32, with batch
// strides as arguments (a K or V broadcast with stride 0 is read in place);
// dM1, dM2 (b, n, c) contiguous in the inputs' type; L, D (b, n) float32,
// L in the natural log.  dQ (b, n, d), dK (b, m, d), dV (b, m, c) come out
// contiguous in the inputs' type.
//
// Replaces the Pallas TPU kernels vst_tpu/kernels/adaattn_attention.py
// _bwd_dq_kernel (K4) and _bwd_dkv_kernel (K5), driven by _backward.  As
// there, K4 owns query rows and walks over the keys, K5 owns keys and walks
// over the queries, each recomputing S and dA tile by tile: nothing of the
// (n x m) map reaches device memory, no atomics, the result does not depend
// on the order blocks run in.  Ragged n, m, d and c are masked in the
// kernel (zero-filled loads, A = 0 outside [0, n) x [0, m)): there are no
// padded copies.
//
// The TPU keeps a whole (block x d) float32 accumulator in VMEM.  At
// relu5_1 (d = 1472) a 64-row dQ accumulator is 376 KB: it fits neither a
// block's registers nor its 227 KB of shared memory.  So the output
// columns are split across blocks and every slice recomputes S (and dA
// where it needs it) in full:
// - K4: one block = (image, 64 query rows, 128 columns of dQ); ceil(d/128)
//   slices, each recomputing S and dA.
// - K5: one block = (image, 64 keys, a role).  Roles 0 .. ceil(d/128)-1 own
//   128 columns of dK and recompute S and dA; the next ceil(c/64) roles
//   own 64 columns of dV (both accumulators, A^T dM1 and A^T dM2) and
//   recompute S only: dV needs A, not dS.
//
// What bounds them on the H100: the tensor cores (bf16).  The least work
// is 4nmd + 4nmc FLOPs per image for K4 and 4nmd + 8nmc for K5; the
// recompute of the column split multiplies it (PERF.md states the factor
// at each AdaAttN level).  This first cut stages every operand through
// shared memory with cp.async and waits for each stage before its
// products (no pipelining): simple and right first.
//
// bf16 (training at the serving type): mma.sync.m16n8k16, float32
// accumulation, 4 warps x 16 rows.  Rounding points, as the plain version:
// W = V o V squared in float32 from the bf16 V fragments and rounded to
// bf16; A and dS rounded to bf16 before their products; dA, the
// accumulators and dV's epilogue in float32.  Scores are scaled by log2 e
// for exp2f; L arrives in the natural log and is scaled the same way.
//
// float32 (parity): true float32 on the CUDA cores (JAX's HIGHEST), 256
// threads, 64 x 64 score tiles as 4 x 4 register tiles, 64 x 128 output
// tiles as 4 x 8, expf.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attn_common.cuh"   // cp.async, bf16 packing, LOG2E / NEG

namespace k45 {

using namespace attn;

struct BwdArgs {
  const void* q;      // (b, n, d), batch stride q_bs
  const void* k;      // (b, m, d), batch stride k_bs (may be 0)
  const void* v;      // (b, m, c), batch stride v_bs (may be 0)
  const void* dm1;    // (b, n, c) contiguous
  const void* dm2;    // (b, n, c) contiguous
  const float* lse;   // (b, n), natural log
  const float* dd;    // (b, n), the row term D
  void* dq;           // K4: (b, n, d)
  void* dk;           // K5: (b, m, d)
  void* dv;           // K5: (b, m, c)
  int n, m, d, c;
  long long q_bs, k_bs, v_bs;   // in elements
};

constexpr float BIG = 1e30f;   // L of a row outside [0, n): A = 0 there

// ----------------------------------------------------------------- bf16

constexpr int BR = 64;     // rows per block (K4 queries, K5 keys), 16 a warp
constexpr int BT = 64;     // the other side's tile (K4 keys, K5 queries)
constexpr int BK = 64;     // d or c per staged chunk
constexpr int BO = 128;    // output columns per block (dQ, dK; dV: 2 x 64)
constexpr int NTH = 128;   // 4 warps
constexpr int LD = BK + 8;     // bf16 per chunk row (ldmatrix conflict-free)
constexpr int OLD = BO + 8;    // bf16 per output-slice row
constexpr int DV_COLS = BO / 2;

constexpr int CHUNK = BR * LD;     // one staged 64 x 64 chunk, in bf16
constexpr int SMEM_BF16 = (5 * CHUNK + BT * OLD) * 2 + 2 * BT * 4;

// ROWS x COLS bf16 tile at (row0, col0) of a row-major (nrow, ncol) matrix
// into shared memory (row pitch ld); what lies outside is zero.  ncol is a
// multiple of 8, so each 16-byte vector is wholly inside or outside.
template <int ROWS, int COLS>
__device__ __forceinline__ void load_tile(bf16* dst, int ld, const bf16* src,
                                          int row0, int nrow, int col0,
                                          int ncol, int tid) {
  constexpr int VPR = COLS / 8;
#pragma unroll
  for (int r = 0; r < ROWS * VPR / NTH; ++r) {
    const int e = tid + NTH * r;
    const int row = e / VPR, col = (e - row * VPR) * 8;
    const bool ok = row0 + row < nrow && col0 + col < ncol;
    cp_async16(dst + row * ld + col,
               ok ? src + (size_t)(row0 + row) * ncol + col0 + col : src, ok);
  }
}

// acc[2nn], acc[2nn+1] += A (this warp's 16 rows of As, chunk columns
// ks..ks+15) . B^T, B = 64 rows of Bs: the S = Q K^T pattern of K3.
// With SQUARE_B the B fragments are squared first (dM2 W^T in K4).
template <bool SQUARE_B>
__device__ __forceinline__ void mma_abt(float (&acc)[BT / 8][4],
                                        const unsigned (&af)[4],
                                        const bf16* Bs, int ks, int lane) {
#pragma unroll
  for (int nn = 0; nn < BT / 16; ++nn) {
    unsigned bb[4];
    vst::ldmatrix_x4(bb, Bs + (nn * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD
                             + ks + ((lane >> 3) & 1) * 8);
    if (SQUARE_B) {
#pragma unroll
      for (int r = 0; r < 4; ++r) bb[r] = square_bf16x2(bb[r]);
    }
    vst::mma_bf16(acc[2 * nn], af, bb[0], bb[1]);
    vst::mma_bf16(acc[2 * nn + 1], af, bb[2], bb[3]);
  }
}

__device__ __forceinline__ void load_a(unsigned (&af)[4], const bf16* As,
                                       int warp, int ks, int lane) {
  vst::ldmatrix_x4(af, As + (warp * 16 + (lane & 15)) * LD + ks
                           + (lane >> 4) * 8);
}

// acc[0 .. BO/8) += P (16 x BT, bf16 A fragments) . Os (BT x BO, row-major
// in shared memory): the P.V pattern of K3.
__device__ __forceinline__ void mma_pv(float (&acc)[BO / 8][4],
                                       const unsigned (&pa)[BT / 16][4],
                                       const bf16* Os, int lane) {
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk) {
#pragma unroll
    for (int cc = 0; cc < BO / 16; ++cc) {
      unsigned bo[4];
      vst::ldmatrix_x4_trans(bo, Os + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * OLD
                                     + cc * 16 + (lane >> 4) * 8);
      vst::mma_bf16(acc[2 * cc], pa[kk], bo[0], bo[1]);
      vst::mma_bf16(acc[2 * cc + 1], pa[kk], bo[2], bo[3]);
    }
  }
}

__device__ __forceinline__ void zero(float (&x)[BT / 8][4]) {
#pragma unroll
  for (int i = 0; i < BT / 8; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) x[i][r] = 0.f;
}

// K4, bf16.  Block (query tile, dQ column slice, image).
__global__ void __launch_bounds__(NTH) attn_dq_bf16(BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qc = reinterpret_cast<bf16*>(smem);   // [BR][LD]  q, d chunk
  bf16* Kc = Qc + CHUNK;                      // [BT][LD]  k, d chunk
  bf16* D1c = Kc + CHUNK;                     // [BR][LD]  dM1, c chunk
  bf16* D2c = D1c + CHUNK;                    // [BR][LD]  dM2, c chunk
  bf16* Vc = D2c + CHUNK;                     // [BT][LD]  v, c chunk
  bf16* Ko = Vc + CHUNK;                      // [BT][OLD] k, dQ's columns

  const int bi = blockIdx.z, q0 = blockIdx.x * BR, o0 = blockIdx.y * BO;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const bf16* q = static_cast<const bf16*>(a.q) + bi * a.q_bs;
  const bf16* k = static_cast<const bf16*>(a.k) + bi * a.k_bs;
  const bf16* v = static_cast<const bf16*>(a.v) + bi * a.v_bs;
  const bf16* dm1 = static_cast<const bf16*>(a.dm1) + (size_t)bi * a.n * a.c;
  const bf16* dm2 = static_cast<const bf16*>(a.dm2) + (size_t)bi * a.n * a.c;

  float lrow[2], drow[2];   // rows g and g + 8 of this warp
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + warp * 16 + g + h * 8;
    const bool ok = row < a.n;
    lrow[h] = ok ? a.lse[(size_t)bi * a.n + row] * LOG2E : BIG;
    drow[h] = ok ? a.dd[(size_t)bi * a.n + row] : 0.f;
  }
  float acc[BO / 8][4];
#pragma unroll
  for (int i = 0; i < BO / 8; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[i][r] = 0.f;

  const int nkt = (a.m + BT - 1) / BT;
  for (int j = 0; j < nkt; ++j) {
    const int k0 = j * BT;
    float s[BT / 8][4], da[BT / 8][4];
    zero(s);
    zero(da);
    for (int t = 0; t < a.d; t += BK) {          // S = Q K^T over d
      load_tile<BR, BK>(Qc, LD, q, q0, a.n, t, a.d, tid);
      load_tile<BT, BK>(Kc, LD, k, k0, a.m, t, a.d, tid);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
#pragma unroll
      for (int ks = 0; ks < BK; ks += 16) {
        unsigned af[4];
        load_a(af, Qc, warp, ks, lane);
        mma_abt<false>(s, af, Kc, ks, lane);
      }
      __syncthreads();
    }
    for (int u = 0; u < a.c; u += BK) {          // dA = dM1 V^T + dM2 W^T
      load_tile<BR, BK>(D1c, LD, dm1, q0, a.n, u, a.c, tid);
      load_tile<BR, BK>(D2c, LD, dm2, q0, a.n, u, a.c, tid);
      load_tile<BT, BK>(Vc, LD, v, k0, a.m, u, a.c, tid);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
#pragma unroll
      for (int ks = 0; ks < BK; ks += 16) {
        unsigned a1[4], a2[4];
        load_a(a1, D1c, warp, ks, lane);
        load_a(a2, D2c, warp, ks, lane);
        mma_abt<false>(da, a1, Vc, ks, lane);
        mma_abt<true>(da, a2, Vc, ks, lane);
      }
      __syncthreads();
    }
    // this key tile's rows of K, at dQ's columns, while dS is formed
    load_tile<BT, BO>(Ko, OLD, k, k0, a.m, o0, a.d, tid);
    cp_async_commit();

    // dS = A o (dA - D), rounded to bf16 as the A operand of dS . K.
    // s[nt][0..1] are row g, s[nt][2..3] row g + 8, keys
    // k0 + nt*8 + 2*tq + {0, 1}.
    unsigned pa[BT / 16][4];
#pragma unroll
    for (int nt = 0; nt < BT / 8; ++nt) {
      const int key = k0 + nt * 8 + 2 * tq;
      float ds[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int h = r >> 1;
        const float x = key + (r & 1) < a.m ? s[nt][r] * LOG2E : NEG;
        ds[r] = exp2f(x - lrow[h]) * (da[nt][r] - drow[h]);
      }
      pa[nt >> 1][(nt & 1) * 2] = pack_bf16(ds[0], ds[1]);
      pa[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }
    cp_async_wait<0>();
    __syncthreads();
    mma_pv(acc, pa, Ko, lane);
    __syncthreads();
  }

  bf16* dq = static_cast<bf16*>(a.dq) + (size_t)bi * a.n * a.d;
#pragma unroll
  for (int ct = 0; ct < BO / 8; ++ct) {
    const int col = o0 + ct * 8 + 2 * tq;
    if (col >= a.d) continue;   // d % 8 == 0, so col + 1 < d as well
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + warp * 16 + g + h * 8;
      if (row < a.n)
        *reinterpret_cast<__nv_bfloat162*>(dq + (size_t)row * a.d + col) =
            __floats2bfloat162_rn(acc[ct][2 * h], acc[ct][2 * h + 1]);
    }
  }
}

// K5, bf16.  Block (key tile, role, image); roles < n_dk_roles own dK's
// columns [128 role, +128), the rest dV's columns [64 (role - n_dk_roles),
// +64).
__global__ void __launch_bounds__(NTH) attn_dkv_bf16(BwdArgs a, int n_dk_roles) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Kc = reinterpret_cast<bf16*>(smem);   // [BR][LD]  k, d chunk
  bf16* Qc = Kc + CHUNK;                      // [BT][LD]  q, d chunk
  bf16* Vc = Qc + CHUNK;                      // [BR][LD]  v, c chunk
  bf16* D1c = Vc + CHUNK;                     // [BT][LD]  dM1, c chunk
  bf16* D2c = D1c + CHUNK;                    // [BT][LD]  dM2, c chunk
  bf16* Os = D2c + CHUNK;                     // [BT][OLD] q (dK) or dM1 | dM2 (dV)
  float* Ls = reinterpret_cast<float*>(Os + BT * OLD);   // [BT] L * log2 e
  float* Ds = Ls + BT;                                   // [BT] D

  const int bi = blockIdx.z, k0 = blockIdx.x * BR;
  const bool dk_role = blockIdx.y < n_dk_roles;
  const int o0 = dk_role ? blockIdx.y * BO : (blockIdx.y - n_dk_roles) * DV_COLS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const bf16* q = static_cast<const bf16*>(a.q) + bi * a.q_bs;
  const bf16* k = static_cast<const bf16*>(a.k) + bi * a.k_bs;
  const bf16* v = static_cast<const bf16*>(a.v) + bi * a.v_bs;
  const bf16* dm1 = static_cast<const bf16*>(a.dm1) + (size_t)bi * a.n * a.c;
  const bf16* dm2 = static_cast<const bf16*>(a.dm2) + (size_t)bi * a.n * a.c;

  // dK role: 16 keys x 128 columns; dV role: acc[0..7] = A^T dM1 and
  // acc[8..15] = A^T dM2, 64 columns each
  float acc[BO / 8][4];
#pragma unroll
  for (int i = 0; i < BO / 8; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[i][r] = 0.f;

  const int nqt = (a.n + BT - 1) / BT;
  for (int i = 0; i < nqt; ++i) {
    const int i0 = i * BT;
    if (tid < BT) {
      const int qq = i0 + tid;
      const bool ok = qq < a.n;
      Ls[tid] = ok ? a.lse[(size_t)bi * a.n + qq] * LOG2E : BIG;
      Ds[tid] = ok ? a.dd[(size_t)bi * a.n + qq] : 0.f;
    }
    float s[BT / 8][4];   // S^T: rows = this warp's keys, columns = queries
    zero(s);
    for (int t = 0; t < a.d; t += BK) {
      load_tile<BR, BK>(Kc, LD, k, k0, a.m, t, a.d, tid);
      load_tile<BT, BK>(Qc, LD, q, i0, a.n, t, a.d, tid);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
#pragma unroll
      for (int ks = 0; ks < BK; ks += 16) {
        unsigned af[4];
        load_a(af, Kc, warp, ks, lane);
        mma_abt<false>(s, af, Qc, ks, lane);
      }
      __syncthreads();
    }
    if (dk_role) {
      load_tile<BT, BO>(Os, OLD, q, i0, a.n, o0, a.d, tid);
    } else {
      load_tile<BT, DV_COLS>(Os, OLD, dm1, i0, a.n, o0, a.c, tid);
      load_tile<BT, DV_COLS>(Os + DV_COLS, OLD, dm2, i0, a.n, o0, a.c, tid);
    }
    cp_async_commit();

    float at[BT / 8][4];   // A^T = exp(S^T - L), query columns
#pragma unroll
    for (int nt = 0; nt < BT / 8; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        at[nt][r] = exp2f(s[nt][r] * LOG2E - Ls[nt * 8 + 2 * tq + (r & 1)]);

    unsigned pa[BT / 16][4];   // dS^T (dK role) or A^T (dV role), bf16
    if (dk_role) {
      float da[BT / 8][4];     // dA^T = V dM1^T + W dM2^T
      zero(da);
      for (int u = 0; u < a.c; u += BK) {
        load_tile<BR, BK>(Vc, LD, v, k0, a.m, u, a.c, tid);
        load_tile<BT, BK>(D1c, LD, dm1, i0, a.n, u, a.c, tid);
        load_tile<BT, BK>(D2c, LD, dm2, i0, a.n, u, a.c, tid);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
#pragma unroll
        for (int ks = 0; ks < BK; ks += 16) {
          unsigned av[4], aw[4];
          load_a(av, Vc, warp, ks, lane);
#pragma unroll
          for (int r = 0; r < 4; ++r) aw[r] = square_bf16x2(av[r]);
          mma_abt<false>(da, av, D1c, ks, lane);
          mma_abt<false>(da, aw, D2c, ks, lane);
        }
        __syncthreads();
      }
#pragma unroll
      for (int nt = 0; nt < BT / 8; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          at[nt][r] *= da[nt][r] - Ds[nt * 8 + 2 * tq + (r & 1)];
    }
#pragma unroll
    for (int nt = 0; nt < BT / 8; ++nt) {
      pa[nt >> 1][(nt & 1) * 2] = pack_bf16(at[nt][0], at[nt][1]);
      pa[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(at[nt][2], at[nt][3]);
    }
    cp_async_wait<0>();
    __syncthreads();
    mma_pv(acc, pa, Os, lane);
    __syncthreads();   // before the next tile overwrites Ls, Ds and Os
  }

  if (dk_role) {
    bf16* dk = static_cast<bf16*>(a.dk) + (size_t)bi * a.m * a.d;
#pragma unroll
    for (int ct = 0; ct < BO / 8; ++ct) {
      const int col = o0 + ct * 8 + 2 * tq;
      if (col >= a.d) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int key = k0 + warp * 16 + g + h * 8;
        if (key < a.m)
          *reinterpret_cast<__nv_bfloat162*>(dk + (size_t)key * a.d + col) =
              __floats2bfloat162_rn(acc[ct][2 * h], acc[ct][2 * h + 1]);
      }
    }
  } else {
    bf16* dv = static_cast<bf16*>(a.dv) + (size_t)bi * a.m * a.c;
#pragma unroll
    for (int ct = 0; ct < DV_COLS / 8; ++ct) {
      const int col = o0 + ct * 8 + 2 * tq;
      if (col >= a.c) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int key = k0 + warp * 16 + g + h * 8;
        if (key >= a.m) continue;
        const float2 vv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(v + (size_t)key * a.c + col));
        const float x0 = acc[ct][2 * h] + 2.f * vv.x * acc[ct + DV_COLS / 8][2 * h];
        const float x1 = acc[ct][2 * h + 1]
                         + 2.f * vv.y * acc[ct + DV_COLS / 8][2 * h + 1];
        *reinterpret_cast<__nv_bfloat162*>(dv + (size_t)key * a.c + col) =
            __floats2bfloat162_rn(x0, x1);
      }
    }
  }
}

// ---------------------------------------------------------------- float32

constexpr int FR = 64;    // rows per block (K4 queries, K5 keys)
constexpr int FT = 64;    // the other side's tile
constexpr int FD = 16;    // d or c per staged chunk
constexpr int FO = 128;   // output columns per block (dV: 2 x 64)
constexpr int FS = 8;     // tile rows per staged output-product chunk
constexpr int FTH = 256;  // 16 x 16 threads
constexpr int FDV = FO / 2;

// K4, float32.  Thread (ty, tx): query rows ty + 16 i, keys tx + 16 jj,
// dQ columns tx + 16 jj (jj < 8).
__global__ void __launch_bounds__(FTH) attn_dq_f32(BwdArgs a) {
  __shared__ float As[FD][FR + 1];   // q or dM1 chunk, [col][row]
  __shared__ float A2[FD][FR + 1];   // dM2 chunk
  __shared__ float Bs[FD][FT + 1];   // k or v chunk, [col][key]
  __shared__ float Ps[FT][FR + 1];   // dS^T, [key][row]
  __shared__ float Ks[FS][FO];       // k at dQ's columns, [key][col]

  const int bi = blockIdx.z, q0 = blockIdx.x * FR, o0 = blockIdx.y * FO;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const float* q = static_cast<const float*>(a.q) + bi * a.q_bs;
  const float* k = static_cast<const float*>(a.k) + bi * a.k_bs;
  const float* v = static_cast<const float*>(a.v) + bi * a.v_bs;
  const float* dm1 = static_cast<const float*>(a.dm1) + (size_t)bi * a.n * a.c;
  const float* dm2 = static_cast<const float*>(a.dm2) + (size_t)bi * a.n * a.c;

  float lrow[4], drow[4], acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    lrow[i] = row < a.n ? a.lse[(size_t)bi * a.n + row] : BIG;
    drow[i] = row < a.n ? a.dd[(size_t)bi * a.n + row] : 0.f;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) acc[i][jj] = 0.f;
  }

  const int nkt = (a.m + FT - 1) / FT;
  for (int j = 0; j < nkt; ++j) {
    const int k0 = j * FT;
    float s[4][4], da[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = da[i][jj] = 0.f;
    for (int t = 0; t < a.d; t += FD) {
#pragma unroll
      for (int r = 0; r < (FR * FD) / FTH; ++r) {
        const int e = tid + FTH * r;
        const int row = e / FD, kk = e % FD;
        const bool ok = t + kk < a.d;
        As[kk][row] = ok && q0 + row < a.n ? q[(size_t)(q0 + row) * a.d + t + kk] : 0.f;
        Bs[kk][row] = ok && k0 + row < a.m ? k[(size_t)(k0 + row) * a.d + t + kk] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < FD; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            s[i][jj] = fmaf(As[kk][ty + 16 * i], Bs[kk][tx + 16 * jj], s[i][jj]);
      __syncthreads();
    }
    for (int u = 0; u < a.c; u += FD) {
#pragma unroll
      for (int r = 0; r < (FR * FD) / FTH; ++r) {
        const int e = tid + FTH * r;
        const int row = e / FD, kk = e % FD;
        const bool ok = u + kk < a.c;
        const bool qok = ok && q0 + row < a.n;
        As[kk][row] = qok ? dm1[(size_t)(q0 + row) * a.c + u + kk] : 0.f;
        A2[kk][row] = qok ? dm2[(size_t)(q0 + row) * a.c + u + kk] : 0.f;
        Bs[kk][row] = ok && k0 + row < a.m ? v[(size_t)(k0 + row) * a.c + u + kk] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < FD; ++kk)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float vv = Bs[kk][tx + 16 * jj], w = vv * vv;
#pragma unroll
          for (int i = 0; i < 4; ++i)
            da[i][jj] = fmaf(A2[kk][ty + 16 * i], w,
                             fmaf(As[kk][ty + 16 * i], vv, da[i][jj]));
        }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int key = k0 + tx + 16 * jj;
        const float p = key < a.m ? expf(s[i][jj] - lrow[i]) : 0.f;
        Ps[tx + 16 * jj][ty + 16 * i] = p * (da[i][jj] - drow[i]);
      }
    __syncthreads();
    for (int kb = 0; kb < FT; kb += FS) {
#pragma unroll
      for (int r = 0; r < (FS * FO) / FTH; ++r) {
        const int e = tid + FTH * r;
        const int kk = e / FO, col = e % FO;
        const int key = k0 + kb + kk;
        Ks[kk][col] = key < a.m && o0 + col < a.d
                          ? k[(size_t)key * a.d + o0 + col] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < FS; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = Ps[kb + kk][ty + 16 * i];
#pragma unroll
          for (int jj = 0; jj < 8; ++jj)
            acc[i][jj] = fmaf(p, Ks[kk][tx + 16 * jj], acc[i][jj]);
        }
      __syncthreads();
    }
  }

  float* dq = static_cast<float*>(a.dq) + (size_t)bi * a.n * a.d;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= a.n) continue;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int col = o0 + tx + 16 * jj;
      if (col < a.d) dq[(size_t)row * a.d + col] = acc[i][jj];
    }
  }
}

// K5, float32.  Thread (ty, tx): keys ty + 16 i, queries tx + 16 jj, output
// columns tx + 16 jj (jj < 8; dV role: jj < 4 A^T dM1, jj >= 4 A^T dM2).
__global__ void __launch_bounds__(FTH) attn_dkv_f32(BwdArgs a, int n_dk_roles) {
  __shared__ float Ks[FD][FR + 1];   // k or v chunk, [col][key]
  __shared__ float Q1[FD][FT + 1];   // q or dM1 chunk, [col][query]
  __shared__ float Q2[FD][FT + 1];   // dM2 chunk
  __shared__ float Ps[FT][FR + 1];   // dS or A, [query][key]
  __shared__ float Os[FS][FO];       // q (dK) or dM1 | dM2 (dV), [query][col]
  __shared__ float Ls[FT], Ds[FT];

  const int bi = blockIdx.z, k0 = blockIdx.x * FR;
  const bool dk_role = blockIdx.y < n_dk_roles;
  const int o0 = dk_role ? blockIdx.y * FO : (blockIdx.y - n_dk_roles) * FDV;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const float* q = static_cast<const float*>(a.q) + bi * a.q_bs;
  const float* k = static_cast<const float*>(a.k) + bi * a.k_bs;
  const float* v = static_cast<const float*>(a.v) + bi * a.v_bs;
  const float* dm1 = static_cast<const float*>(a.dm1) + (size_t)bi * a.n * a.c;
  const float* dm2 = static_cast<const float*>(a.dm2) + (size_t)bi * a.n * a.c;

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) acc[i][jj] = 0.f;

  const int nqt = (a.n + FT - 1) / FT;
  for (int it = 0; it < nqt; ++it) {
    const int i0 = it * FT;
    if (tid < FT) {
      const bool ok = i0 + tid < a.n;
      Ls[tid] = ok ? a.lse[(size_t)bi * a.n + i0 + tid] : BIG;
      Ds[tid] = ok ? a.dd[(size_t)bi * a.n + i0 + tid] : 0.f;
    }
    float s[4][4], da[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = da[i][jj] = 0.f;
    for (int t = 0; t < a.d; t += FD) {
#pragma unroll
      for (int r = 0; r < (FR * FD) / FTH; ++r) {
        const int e = tid + FTH * r;
        const int row = e / FD, kk = e % FD;
        const bool ok = t + kk < a.d;
        Ks[kk][row] = ok && k0 + row < a.m ? k[(size_t)(k0 + row) * a.d + t + kk] : 0.f;
        Q1[kk][row] = ok && i0 + row < a.n ? q[(size_t)(i0 + row) * a.d + t + kk] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < FD; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            s[i][jj] = fmaf(Ks[kk][ty + 16 * i], Q1[kk][tx + 16 * jj], s[i][jj]);
      __syncthreads();
    }
    if (dk_role) {
      for (int u = 0; u < a.c; u += FD) {
#pragma unroll
        for (int r = 0; r < (FR * FD) / FTH; ++r) {
          const int e = tid + FTH * r;
          const int row = e / FD, kk = e % FD;
          const bool ok = u + kk < a.c;
          const bool qok = ok && i0 + row < a.n;
          Ks[kk][row] = ok && k0 + row < a.m ? v[(size_t)(k0 + row) * a.c + u + kk] : 0.f;
          Q1[kk][row] = qok ? dm1[(size_t)(i0 + row) * a.c + u + kk] : 0.f;
          Q2[kk][row] = qok ? dm2[(size_t)(i0 + row) * a.c + u + kk] : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < FD; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float vv = Ks[kk][ty + 16 * i], w = vv * vv;
#pragma unroll
            for (int jj = 0; jj < 4; ++jj)
              da[i][jj] = fmaf(w, Q2[kk][tx + 16 * jj],
                               fmaf(vv, Q1[kk][tx + 16 * jj], da[i][jj]));
          }
        __syncthreads();
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int qc = tx + 16 * jj;
        const float p = expf(s[i][jj] - Ls[qc]);
        Ps[qc][ty + 16 * i] = dk_role ? p * (da[i][jj] - Ds[qc]) : p;
      }
    __syncthreads();
    for (int qb = 0; qb < FT; qb += FS) {
#pragma unroll
      for (int r = 0; r < (FS * FO) / FTH; ++r) {
        const int e = tid + FTH * r;
        const int kk = e / FO, col = e % FO;
        const int qq = i0 + qb + kk;
        float x = 0.f;
        if (qq < a.n) {
          if (dk_role) {
            if (o0 + col < a.d) x = q[(size_t)qq * a.d + o0 + col];
          } else {
            const int cc = o0 + (col % FDV);
            if (cc < a.c) x = (col < FDV ? dm1 : dm2)[(size_t)qq * a.c + cc];
          }
        }
        Os[kk][col] = x;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < FS; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = Ps[qb + kk][ty + 16 * i];
#pragma unroll
          for (int jj = 0; jj < 8; ++jj)
            acc[i][jj] = fmaf(p, Os[kk][tx + 16 * jj], acc[i][jj]);
        }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= a.m) continue;
    if (dk_role) {
      float* dk = static_cast<float*>(a.dk) + (size_t)bi * a.m * a.d;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int col = o0 + tx + 16 * jj;
        if (col < a.d) dk[(size_t)key * a.d + col] = acc[i][jj];
      }
    } else {
      float* dv = static_cast<float*>(a.dv) + (size_t)bi * a.m * a.c;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int col = o0 + tx + 16 * jj;
        if (col < a.c)
          dv[(size_t)key * a.c + col] =
              acc[i][jj] + 2.f * v[(size_t)key * a.c + col] * acc[i][jj + 4];
      }
    }
  }
}

}  // namespace k45

// Each returns 0 on success, else the CUDA error of the attribute call or
// the launch.  bf16 needs d and c multiples of 8 and 16-byte aligned rows;
// the wrapper checks.
extern "C" int vst_k4_attention_dq(
    const void* q, const void* k, const void* v, const void* dm1,
    const void* dm2, const float* lse, const float* dd, void* dq, int b,
    int n, int m, int d, int c, long long q_bs, long long k_bs,
    long long v_bs, int bf16, void* stream) {
  using namespace k45;
  BwdArgs a{q, k, v, dm1, dm2, lse, dd, dq, nullptr, nullptr,
            n, m, d, c, q_bs, k_bs, v_bs};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    const cudaError_t e = cudaFuncSetAttribute(
        attn_dq_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BF16);
    if (e != cudaSuccess) return static_cast<int>(e);
    const dim3 grid((n + BR - 1) / BR, (d + BO - 1) / BO, b);
    attn_dq_bf16<<<grid, NTH, SMEM_BF16, s>>>(a);
  } else {
    const dim3 grid((n + FR - 1) / FR, (d + FO - 1) / FO, b);
    attn_dq_f32<<<grid, FTH, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int vst_k5_attention_dkv(
    const void* q, const void* k, const void* v, const void* dm1,
    const void* dm2, const float* lse, const float* dd, void* dk, void* dv,
    int b, int n, int m, int d, int c, long long q_bs, long long k_bs,
    long long v_bs, int bf16, void* stream) {
  using namespace k45;
  BwdArgs a{q, k, v, dm1, dm2, lse, dd, nullptr, dk, dv,
            n, m, d, c, q_bs, k_bs, v_bs};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    const cudaError_t e = cudaFuncSetAttribute(
        attn_dkv_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BF16);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int roles = (d + BO - 1) / BO;
    const dim3 grid((m + BR - 1) / BR, roles + (c + DV_COLS - 1) / DV_COLS, b);
    attn_dkv_bf16<<<grid, NTH, SMEM_BF16, s>>>(a, roles);
  } else {
    const int roles = (d + FO - 1) / FO;
    const dim3 grid((m + FR - 1) / FR, roles + (c + FDV - 1) / FDV, b);
    attn_dkv_f32<<<grid, FTH, 0, s>>>(a, roles);
  }
  return static_cast<int>(cudaGetLastError());
}
