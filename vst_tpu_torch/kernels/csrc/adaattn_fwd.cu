// K3: AdaAttN softmax attention moments, forward.
//
//   M1 = softmax(Q K^T) V,   M2 = softmax(Q K^T) (V o V),   L = logsumexp(Q K^T)
//
// q (b, n, d), k (b, m, d), v (b, m, c) in bfloat16 or float32 -> M1, M2
// (b, n, c) in the input type and L (b, n) float32, natural log.  Rows of a
// batch entry are contiguous; the batch strides are arguments, so a K or V
// broadcast over the batch (stride 0, the cached-style path) is read in
// place, with no copy.
//
// Replaces the Pallas TPU kernel vst_tpu/kernels/adaattn_attention.py
// (_fwd_kernel, driven by _forward and softmax_attention_moments_pallas).
// The TPU carries the running max, the running sum and both accumulators
// in VMEM scratch across a sequential k grid.  Here one block owns
// (batch entry, query tile, value-channel slice) and walks over every key
// tile itself, with all four in registers.  Nothing of the (n x m) score
// map reaches device memory.  Keys >= m and query rows >= n are masked in
// the kernel: there are no padded copies.
//
// What bounds it on the H100: the tensor cores.  At the AdaAttN 512^2 serving
// shape, relu3_1 (n = m = 16384, d = 448, c = 256) is 2nm(d + 2c) = 0.52
// TFLOP per image, 0.52 ms at 989 TFLOP/s, against about 55 MB of inputs and
// outputs (0.02 ms at 3.35 TB/s) and 2.7e8 exponentials on the MUFU.
//
// bf16 (serving), attn_fwd_bf16: mma.sync.m16n8k16 with float32 accumulation.
// - Block: 4 warps, 64 query rows (16 per warp, so a row's softmax stays in
//   one warp's quad of lanes), BC = 128 value channels.  Per thread: the
//   16 x 64 score tile (32 floats) and the two 16 x 128 accumulators
//   (128 floats).  Two accumulators of width 512 do not fit a block's
//   registers, so c is split across blocks and each slice recomputes
//   Q K^T: c / 128 slices, 2 at relu3_1 and 4 at relu4_1/relu5_1, which
//   costs 1.47x, 2.45x and 2.77x the least arithmetic at the three levels.
// - The whole Q tile (64 x d) stays in shared memory for the block's life;
//   K is staged in 64-key x 64-d chunks through a double-buffered cp.async
//   ring, so Q K^T is accumulated over d in steps and any d <= 1472 fits
//   (64 x 1472 bf16 Q = 188 KB + 18 KB of K stages + 17 KB of V = 220 KB).
// - Scores are scaled by log2(e) in float32 and exponentiated with exp2f;
//   L comes out as max * ln 2 + log(sum), in the natural domain.
// - P is rounded to bf16 before the two P.V products (the TPU kernel's
//   DEFAULT-precision dot does the same); the row sum uses the unrounded P.
// - V o V is formed in float32 from the bf16 V fragments in registers and
//   rounded to bf16 there: no V^2 tile, in shared or device memory.
//
// float32 (parity), attn_fwd_f32: true float32 on the CUDA cores (JAX's
// HIGHEST), 64 query rows x 64 keys x 64 value channels per block of 256
// threads, scores, P and both accumulators as 4 x 4 register tiles, expf.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "conv3x3_tile.cuh"   // ldmatrix / mma.sync helpers

namespace k3 {

using bf16 = __nv_bfloat16;

struct AttnArgs {
  const void* q;      // (b, n, d) rows contiguous, batch stride q_bs
  const void* k;      // (b, m, d) rows contiguous, batch stride k_bs (may be 0)
  const void* v;      // (b, m, c) rows contiguous, batch stride v_bs (may be 0)
  void* m1;           // (b, n, c) contiguous, input type
  void* m2;           // (b, n, c)
  float* lse;         // (b, n)
  int n, m, d, c;
  long long q_bs, k_bs, v_bs;   // in elements
};

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float NEG = -1e30f;   // masked score, as the TPU kernel's NEG_INF

// ----------------------------------------------------------------- bf16

constexpr int BM = 64;    // query rows per block
constexpr int BN = 64;    // keys per tile
constexpr int BC = 128;   // value channels per block
constexpr int BD = 64;    // d per K stage
constexpr int NTH = 128;  // 4 warps
constexpr int KLD = BD + 8;   // bf16 per K-stage row (ldmatrix conflict-free)
constexpr int VLD = BC + 8;   // bf16 per V row
constexpr int SMEM_MAX = 232448;

__host__ __device__ constexpr int qld(int dpad) { return dpad + 8; }

__host__ __device__ constexpr int smem_bytes(int dpad) {
  return (BM * qld(dpad) + 2 * BN * KLD + BN * VLD) * 2;
}

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

__device__ __forceinline__ unsigned square_bf16x2(unsigned u) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
  return pack_bf16(f.x * f.x, f.y * f.y);
}

__global__ void __launch_bounds__(NTH) attn_fwd_bf16(AttnArgs a, int dpad) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ql = qld(dpad);
  bf16* Qs = reinterpret_cast<bf16*>(smem);   // [BM][ql]
  bf16* Ks = Qs + BM * ql;                    // [2][BN][KLD]
  bf16* Vs = Ks + 2 * BN * KLD;               // [BN][VLD]

  const int bi = blockIdx.z, q0 = blockIdx.x * BM, c0 = blockIdx.y * BC;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const bf16* q = static_cast<const bf16*>(a.q) + bi * a.q_bs;
  const bf16* k = static_cast<const bf16*>(a.k) + bi * a.k_bs;
  const bf16* v = static_cast<const bf16*>(a.v) + bi * a.v_bs;
  const int nd = dpad / BD;
  const int nkt = (a.m + BN - 1) / BN;
  const int total = nkt * nd;

  // Q tile, once: rows >= n and columns >= d are zero.
  {
    const int vrow = dpad / 8;
    for (int e = tid; e < BM * vrow; e += NTH) {
      const int r = e / vrow, col = (e - r * vrow) * 8;
      const bool ok = q0 + r < a.n && col < a.d;
      cp_async16(Qs + r * ql + col, ok ? q + (size_t)(q0 + r) * a.d + col : q,
                 ok);
    }
    cp_async_commit();
  }
  // K stage s = (key tile j, d chunk t) into ring buffer s & 1.
  auto load_k = [&](int s) {
    const int j = s / nd, t = s - j * nd;
    bf16* dst = Ks + (s & 1) * BN * KLD;
#pragma unroll
    for (int r = 0; r < (BN * BD / 8) / NTH; ++r) {
      const int e = tid + NTH * r;
      const int row = e >> 3, col = (e & 7) * 8;
      const int key = j * BN + row, dd = t * BD + col;
      const bool ok = key < a.m && dd < a.d;
      cp_async16(dst + row * KLD + col, ok ? k + (size_t)key * a.d + dd : k,
                 ok);
    }
  };
  // V tile of key tile j: BN keys x BC channels of this block's slice.
  auto load_v = [&](int j) {
#pragma unroll
    for (int r = 0; r < (BN * BC / 8) / NTH; ++r) {
      const int e = tid + NTH * r;
      const int row = e >> 4, col = (e & 15) * 8;
      const int key = j * BN + row, cc = c0 + col;
      const bool ok = key < a.m && cc < a.c;
      cp_async16(Vs + row * VLD + col, ok ? v + (size_t)key * a.c + cc : v,
                 ok);
    }
  };

  // Commit groups, in order: Q, K(0), V(0), then one K stage per step and
  // one V tile after each key tile's P.V (possibly empty groups, so that
  // the counts below hold everywhere).
  load_k(0);
  cp_async_commit();
  load_v(0);
  cp_async_commit();

  float acc1[BC / 8][4], acc2[BC / 8][4];
#pragma unroll
  for (int i = 0; i < BC / 8; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc1[i][r] = acc2[i][r] = 0.f;
  float mrow[2] = {NEG, NEG};   // running max of rows g and g + 8, base 2
  float lrow[2] = {0.f, 0.f};   // this thread's share of the running sums
  const bf16* qw = Qs + (warp * 16) * ql;

  for (int j = 0; j < nkt; ++j) {
    float s[BN / 8][4];
#pragma unroll
    for (int i = 0; i < BN / 8; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r) s[i][r] = 0.f;

    for (int t = 0; t < nd; ++t) {
      const int st = j * nd + t;
      if (st + 1 < total) load_k(st + 1);
      cp_async_commit();
      // newer than K(st): V(j) and K(st + 1) at t == 0, K(st + 1) after
      if (t == 0) cp_async_wait<2>(); else cp_async_wait<1>();
      __syncthreads();
      const bf16* kb = Ks + (st & 1) * BN * KLD;
#pragma unroll
      for (int ks = 0; ks < BD; ks += 16) {
        unsigned af[4];
        vst::ldmatrix_x4(af, qw + (lane & 15) * ql + t * BD + ks + (lane >> 4) * 8);
#pragma unroll
        for (int nn = 0; nn < BN / 16; ++nn) {
          unsigned bk[4];
          vst::ldmatrix_x4(bk, kb + (nn * 16 + (lane & 7) + ((lane >> 4) << 3)) * KLD
                                   + ks + ((lane >> 3) & 1) * 8);
          vst::mma_bf16(s[2 * nn], af, bk[0], bk[1]);
          vst::mma_bf16(s[2 * nn + 1], af, bk[2], bk[3]);
        }
      }
      __syncthreads();
    }

    // Online softmax over this key tile, base 2.  s[nt][0..1] are row g,
    // s[nt][2..3] row g + 8, keys j*BN + nt*8 + 2*tq + {0, 1}.
    float tmax[2] = {NEG, NEG};
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      const int key = j * BN + nt * 8 + 2 * tq;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        s[nt][r] = key + (r & 1) < a.m ? s[nt][r] * LOG2E : NEG;
        tmax[r >> 1] = fmaxf(tmax[r >> 1], s[nt][r]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(0xffffffffu, tmax[h], 1));
      tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(0xffffffffu, tmax[h], 2));
      const float mnew = fmaxf(mrow[h], tmax[h]);
      alpha[h] = exp2f(mrow[h] - mnew);
      mrow[h] = mnew;
    }
    // P as bf16 A fragments of the P.V products: 16 keys per k-step.
    unsigned pa[BN / 16][4];
    float ls[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      const float p0 = exp2f(s[nt][0] - mrow[0]);
      const float p1 = exp2f(s[nt][1] - mrow[0]);
      const float p2 = exp2f(s[nt][2] - mrow[1]);
      const float p3 = exp2f(s[nt][3] - mrow[1]);
      ls[0] += p0 + p1;
      ls[1] += p2 + p3;
      pa[nt >> 1][(nt & 1) * 2] = pack_bf16(p0, p1);
      pa[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) lrow[h] = lrow[h] * alpha[h] + ls[h];
#pragma unroll
    for (int ct = 0; ct < BC / 8; ++ct)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        acc1[ct][r] *= alpha[r >> 1];
        acc2[ct][r] *= alpha[r >> 1];
      }

    // newer than V(j): the K stages of this tile after the first, and the
    // prefetch of the next tile's first one
    cp_async_wait<1>();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
      for (int cc = 0; cc < BC / 16; ++cc) {
        unsigned bv[4], bw[4];
        vst::ldmatrix_x4_trans(bv, Vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * VLD
                                       + cc * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int r = 0; r < 4; ++r) bw[r] = square_bf16x2(bv[r]);
        vst::mma_bf16(acc1[2 * cc], pa[kk], bv[0], bv[1]);
        vst::mma_bf16(acc1[2 * cc + 1], pa[kk], bv[2], bv[3]);
        vst::mma_bf16(acc2[2 * cc], pa[kk], bw[0], bw[1]);
        vst::mma_bf16(acc2[2 * cc + 1], pa[kk], bw[2], bw[3]);
      }
    }
    __syncthreads();
    if (j + 1 < nkt) load_v(j + 1);
    cp_async_commit();
  }
  cp_async_wait<0>();

  float lsum[2], inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = lrow[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    lsum[h] = l;
    inv[h] = 1.f / l;
  }
  bf16* o1 = static_cast<bf16*>(a.m1) + (size_t)bi * a.n * a.c;
  bf16* o2 = static_cast<bf16*>(a.m2) + (size_t)bi * a.n * a.c;
#pragma unroll
  for (int ct = 0; ct < BC / 8; ++ct) {
    const int col = c0 + ct * 8 + 2 * tq;
    if (col >= a.c) continue;   // c % 8 == 0, so col + 1 < c as well
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + warp * 16 + g + h * 8;
      if (row >= a.n) continue;
      const size_t o = (size_t)row * a.c + col;
      *reinterpret_cast<__nv_bfloat162*>(o1 + o) = __floats2bfloat162_rn(
          acc1[ct][2 * h] * inv[h], acc1[ct][2 * h + 1] * inv[h]);
      *reinterpret_cast<__nv_bfloat162*>(o2 + o) = __floats2bfloat162_rn(
          acc2[ct][2 * h] * inv[h], acc2[ct][2 * h + 1] * inv[h]);
    }
  }
  if (blockIdx.y == 0 && tq == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + warp * 16 + g + h * 8;
      if (row < a.n)
        a.lse[(size_t)bi * a.n + row] = mrow[h] * LN2 + logf(lsum[h]);
    }
  }
}

// ---------------------------------------------------------------- float32

constexpr int FM = 64;    // query rows per block
constexpr int FN = 64;    // keys per tile
constexpr int FC = 64;    // value channels per block
constexpr int FD = 16;    // d per shared-memory stage
constexpr int FTH = 256;  // 16 x 16 threads, 4 x 4 outputs each

__global__ void __launch_bounds__(FTH) attn_fwd_f32(AttnArgs a) {
  __shared__ float Qs[FD][FM + 1];
  __shared__ float Ks[FD][FN + 1];
  __shared__ float Ps[FN][FM + 1];   // P transposed: [key][row]
  __shared__ float Vs[FN][FC];

  const int bi = blockIdx.z, q0 = blockIdx.x * FM, c0 = blockIdx.y * FC;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const float* q = static_cast<const float*>(a.q) + bi * a.q_bs;
  const float* k = static_cast<const float*>(a.k) + bi * a.k_bs;
  const float* v = static_cast<const float*>(a.v) + bi * a.v_bs;
  const int nkt = (a.m + FN - 1) / FN;

  // rows ty + 16 i; keys / channels tx + 16 jj (a row lives in 16 lanes)
  float acc1[4][4], acc2[4][4], mrow[4], lrow[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    mrow[i] = NEG;
    lrow[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) acc1[i][jj] = acc2[i][jj] = 0.f;
  }

  for (int j = 0; j < nkt; ++j) {
#pragma unroll
    for (int r = 0; r < (FN * FC) / FTH; ++r) {
      const int e = tid + FTH * r;
      const int row = e / FC, col = e % FC;
      const int key = j * FN + row, cc = c0 + col;
      Vs[row][col] = (key < a.m && cc < a.c) ? v[(size_t)key * a.c + cc] : 0.f;
    }
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
    for (int d0 = 0; d0 < a.d; d0 += FD) {
#pragma unroll
      for (int r = 0; r < (FM * FD) / FTH; ++r) {
        const int e = tid + FTH * r;
        const int row = e / FD, kk = e % FD;
        const bool dok = d0 + kk < a.d;
        Qs[kk][row] = (dok && q0 + row < a.n)
                          ? q[(size_t)(q0 + row) * a.d + d0 + kk] : 0.f;
        Ks[kk][row] = (dok && j * FN + row < a.m)
                          ? k[(size_t)(j * FN + row) * a.d + d0 + kk] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < FD; ++kk) {
        float av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = Qs[kk][ty + 16 * i];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) bv[jj] = Ks[kk][tx + 16 * jj];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) s[i][jj] = fmaf(av[i], bv[jj], s[i][jj]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float tmax = NEG;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        if (j * FN + tx + 16 * jj >= a.m) s[i][jj] = NEG;
        tmax = fmaxf(tmax, s[i][jj]);
      }
#pragma unroll
      for (int o = 1; o < 16; o <<= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
      const float mnew = fmaxf(mrow[i], tmax);
      const float alpha = expf(mrow[i] - mnew);
      mrow[i] = mnew;
      float ls = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p = expf(s[i][jj] - mnew);
        ls += p;
        Ps[tx + 16 * jj][ty + 16 * i] = p;
      }
      lrow[i] = lrow[i] * alpha + ls;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        acc1[i][jj] *= alpha;
        acc2[i][jj] *= alpha;
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int key = 0; key < FN; ++key) {
      float pv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[key][ty + 16 * i];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) vv[jj] = Vs[key][tx + 16 * jj];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float w = vv[jj] * vv[jj];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc1[i][jj] = fmaf(pv[i], vv[jj], acc1[i][jj]);
          acc2[i][jj] = fmaf(pv[i], w, acc2[i][jj]);
        }
      }
    }
    __syncthreads();
  }

  float* o1 = static_cast<float*>(a.m1) + (size_t)bi * a.n * a.c;
  float* o2 = static_cast<float*>(a.m2) + (size_t)bi * a.n * a.c;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float l = lrow[i];
#pragma unroll
    for (int o = 1; o < 16; o <<= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
    const float inv = 1.f / l;
    const int row = q0 + ty + 16 * i;
    if (row >= a.n) continue;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int col = c0 + tx + 16 * jj;
      if (col < a.c) {
        o1[(size_t)row * a.c + col] = acc1[i][jj] * inv;
        o2[(size_t)row * a.c + col] = acc2[i][jj] * inv;
      }
    }
    if (blockIdx.y == 0 && tx == 0) a.lse[(size_t)bi * a.n + row] = mrow[i] + logf(l);
  }
}

}  // namespace k3

// Returns 0 on success, else the CUDA error of the attribute call or the
// launch.  bf16 needs d and c multiples of 8, 16-byte aligned rows, and
// d <= 1472 (the Q tile stays in shared memory); the wrapper checks.
extern "C" int vst_k3_attention_moments(
    const void* q, const void* k, const void* v, void* m1, void* m2,
    float* lse, int b, int n, int m, int d, int c, long long q_bs,
    long long k_bs, long long v_bs, int bf16, void* stream) {
  using namespace k3;
  AttnArgs a{q, k, v, m1, m2, lse, n, m, d, c, q_bs, k_bs, v_bs};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    const int dpad = (d + BD - 1) / BD * BD;
    const int smem = smem_bytes(dpad);
    if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t e = cudaFuncSetAttribute(
        attn_fwd_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    const dim3 grid((n + BM - 1) / BM, (c + BC - 1) / BC, b);
    attn_fwd_bf16<<<grid, NTH, smem, s>>>(a, dpad);
  } else {
    const dim3 grid((n + FM - 1) / FM, (c + FC - 1) / FC, b);
    attn_fwd_f32<<<grid, FTH, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
