// K3: AdaAttN softmax attention moments, forward.
//
//   M1 = softmax(Q K^T) V,   M2 = softmax(Q K^T) (V o V),   L = logsumexp(Q K^T)
//
// q (b, n, d), k (b, m, d), v (b, m, c) in bfloat16 or float32 -> M1, M2
// (b, n, c) in the input type and L (b, n) float32, natural log.  Rows of a
// batch entry are contiguous; the batch strides are arguments, so a Q, K or
// V broadcast over the batch (stride 0, the cached-style path) is read in
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
// What bounds it on the H100: the least work is tensor-core bound.  At the
// AdaAttN 512^2 serving shape, relu3_1 (n = m = 16384, d = 448, c = 256) is
// 2nm(d + 2c) = 0.52 TFLOP per image, 0.52 ms at 989 TFLOP/s, against about
// 55 MB of inputs and outputs (0.02 ms at 3.35 TB/s) and 2.7e8 exponentials.
// What holds this design (experiments/k3_variants.py, PERF.md): not the
// tensor cores and not the L2 bytes.  A block streams Q beside K, so each
// key tile reads 144 KB from L2 at relu3_1, but loading Q once per block
// saves about 1%; with all three products removed the kernel still takes
// two thirds of its time, and the products add on top of the rest rather
// than hiding under it, since consumer 0 runs S, the softmax and P V one
// after another.
//
// bf16 (serving), attn_fwd_bf16, on Hopper's wgmma:
// - Block = (image, 64 query rows, a value slice of <= 256 columns), walking
//   the key tiles of 64: S = Q K^T is computed once per (tile, slice), one
//   slice at relu3_1 (c = 256) and two at c = 512, so the executed work is
//   (s d + 2c) / (d + 2c) of the least with s = ceil(c / 256) slices: 1.00 /
//   1.48 / 1.59x at relu3_1 / relu4_1 / relu5_1.
// - Three warpgroups.  Consumer 0 computes S over d (wgmma m64n64k16 on 64 x
//   64 chunks of Q and K, both K-major), runs the online softmax on it in
//   its registers (base 2, running max, row sum of the unrounded P), writes
//   P rounded to bf16 once to shared memory, swizzled K-major as wgmma
//   reads A, with the 64 rows' rescale factors, and accumulates M1 = P V.
//   Consumer 1 squares each V tile into W = V o V (float32, rounded to
//   bf16) in a buffer of its own and accumulates M2 = P W.  P V and P W are
//   one m64n256k16 per k16 step with B N-major: the tile's four V chunks lie
//   one after another, the descriptor's leading offset stepping from one to
//   the next.  Each accumulator is 64 x 256 float32, 128 registers a thread.
// - Departure from splitting S over the two consumers: consumer 0 owns S
//   whole, so the softmax needs no float32 exchange, and consumer 1's P W of
//   tile j overlaps consumer 0's S of tile j + 1 (S split over d through a
//   16 KB exchange measured slower at the serving levels, PERF.md).  P and
//   the rescale factors are double-buffered, so one named barrier per tile
//   (both consumers, 256 threads) hands P over and frees the buffer of tile
//   j - 1.  A warp whose rows' rescale factors are all 1 (the running max
//   did not move) skips rescaling its accumulators: the same bits, sooner.
// - The producer warpgroup (setmaxnreg 40) runs two rings, one thread each,
//   behind full/empty mbarriers: (Q chunk, K chunk) stages of 16 KB, 6 deep,
//   over every (key tile, chunk of d); and V tiles of 32 KB, 2 deep.
//   Consumers (setmaxnreg 232; 168 registers a thread at launch, no
//   spills) release a stage once its multiply is done.  Q is streamed, not
//   resident: one code path for every d.
// - Operands come by TMA through 3-D tensor maps over (columns, rows,
//   image) in 64 x 64 boxes with the 128-byte swizzle: rows past n or m of
//   an image and columns past d or c arrive as zeros; a stride-0 operand is
//   one plane.  Zero-filled keys would score 0, so keys >= m get S = -inf
//   before the max.  Rows >= n and columns >= c are not stored; V chunks
//   wholly past c are not loaded (their columns are never stored).
// - Shared memory: 96 + 64 + 32 + 16 KB of rings, W and P, 768 B of row
//   factors, 16 mbarriers and 1 KB of alignment, 214,912 bytes: one block
//   of 384 threads per SM.
//
// Rounding points, as the plain version: scores scaled by log2 e for
// exp2f; L = max ln 2 + log(sum); P rounded to bf16 before both products,
// the row sum of the unrounded P; W = V o V in float32 rounded to bf16;
// accumulators in float32.  Deterministic: no atomics, every sum in a fixed
// order.
//
// float32 (parity: JAX's HIGHEST, 1e-4 of each output's scale), 3xTF32 on
// wgmma (attn_common.cuh), attn_fwd_tf32:
// - The bf16 body's tiling and roles: block = (image, 64 query rows, a
//   value slice of <= 256 columns), S computed once per (key tile, slice):
//   executed 1.00 / 1.48 / 1.59x the least at relu3_1 / relu4_1 /
//   relu5_1, each product as three tf32 ones.
// - A pre-pass (split_tf32) writes big/small tf32 parts of Q and K as they
//   lie and of V^T and W^T = (V o V)^T (W squared in float32), keys
//   contiguous, since tf32's wgmma takes K-major B only; rows padded to 16
//   bytes with zeros, so every shape runs.  Consumer 0 splits P itself.
// - The tensor core's float32 accumulation does not round to nearest, so
//   S is summed per 32-column stage of d, and P V and P W per (key tile,
//   64-column chunk), in fresh partials that the consumers add in float32
//   (M = M alpha + partial).  A 64 x 256 accumulator and one 64 x 64
//   partial fit a consumer's registers; a partial for the whole slice
//   would not.
// - Rings: (Q, K) stages of 32 KB, 3 deep; a ring of 16 KB (chunk, key
//   half) slots of V^T for consumer 0 and one of W^T for consumer 1, 3
//   deep each (one ring per consumer); P as tf32 parts, 32 KB, one buffer
//   behind two named barriers.  231,056 bytes: one block of 384 threads
//   per SM.
// - What bounds it: the least work is tensor-core bound (2nm(d + 2c) per
//   image over 495 / 3 TFLOP/s for 3xTF32: 1.56 ms at relu3_1, 256^2 b8).
//   What holds this design (experiments/k3_f32_variants.py, PERF.md): not
//   the L2 bytes (Q and K are streamed as big/small parts, about 700 KB
//   per (block, key tile) at relu3_1, yet loading Q once per block saves
//   nothing measurable), nor the partial sums' drains (about 2%), but
//   consumer 0's phases in series: S, the softmax and P V one after the
//   other while consumer 1 waits for P.
// - Rounding points: natural exponentials (expf) and log, as JAX's f32
//   kernel; P split from the unrounded float32 values, the row sums of
//   those values.  Deterministic: no atomics, every sum in a fixed order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attn_common.cuh"   // bf16 packing, LOG2E / LN2 / NEG, chunks, TMA maps

namespace k3 {

using namespace attn;

struct AttnArgs {
  const void* q;      // (b, n, d) rows contiguous, batch stride q_bs (may be 0)
  const void* k;      // (b, m, d) rows contiguous, batch stride k_bs (may be 0)
  const void* v;      // (b, m, c) rows contiguous, batch stride v_bs (may be 0)
  void* m1;           // (b, n, c) contiguous, input type
  void* m2;           // (b, n, c)
  float* lse;         // (b, n)
  int n, m, d, c;
  long long q_bs, k_bs, v_bs;   // in elements
};

// ----------------------------------------------------------------- bf16

constexpr int SLICE = 256;             // value columns per block
constexpr int NV = SLICE / T;          // V chunks per key tile
constexpr int RQ = 6;                  // (Q chunk, K chunk) stages
constexpr int RV = 2;                  // V tile stages
constexpr int SLOT_QK = 2 * CB;
constexpr int SLOT_V = NV * CB;
constexpr int NTH = 384;               // two consumer warpgroups, one producer
constexpr int OFF_V = RQ * SLOT_QK;
constexpr int OFF_W = OFF_V + RV * SLOT_V;      // W = V o V, consumer 1's
constexpr int OFF_P = OFF_W + SLOT_V;           // P, bf16, two buffers
constexpr int OFF_ROW = OFF_P + 2 * CB;         // rescale factors [2][T], 1/l [T]
constexpr int OFF_BAR = OFF_ROW + 3 * T * 4;
constexpr int NBAR = 2 * (RQ + RV);
constexpr int SMEM_BF16 = 1024 + OFF_BAR + NBAR * 8;

// The operands' tensor maps (bf16, 64 x 64 boxes, 128-byte swizzle).
struct Maps {
  CUtensorMap q, k, v;
};

// acc (64 x 256) += P O over the tile: P (64 x 64, K-major) and the four
// chunks of O (64 keys x 256 columns) from o on, read N-major.
__device__ __forceinline__ void mma_p_slice(float (&acc)[NV * 32], unsigned p,
                                            unsigned o) {
#pragma unroll
  for (int ks = 0; ks < T / 16; ++ks)
    wg::wgmma_bf16<SLICE, wg::B_NMAJOR>(acc, kmajor(p, ks), nmajor(o, ks));
}

// Writes acc / l (acc[4 jj + 2 h + t]: row q0 + 16 wl + g8 + 8 h, column
// c0 + 8 jj + 2 tq + t) as bf16 into out (b, n, c), inside [0, n) x [0, c).
__device__ __forceinline__ void store_slice(void* out, const float (&acc)[NV * 32],
                                            const float (&inv)[2],
                                            const AttnArgs& a, int bi, int q0,
                                            int c0, int wl, int g8, int tq) {
  bf16* o = static_cast<bf16*>(out) + (size_t)bi * a.n * a.c;
#pragma unroll
  for (int jj = 0; jj < NV * 8; ++jj) {
    const int col = c0 + 8 * jj + 2 * tq;
    if (col >= a.c) continue;   // c % 8 == 0, so col + 1 < c as well
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + 16 * wl + g8 + 8 * h;
      if (row < a.n)
        *reinterpret_cast<__nv_bfloat162*>(o + (size_t)row * a.c + col) =
            __floats2bfloat162_rn(acc[4 * jj + 2 * h] * inv[h],
                                  acc[4 * jj + 2 * h + 1] * inv[h]);
    }
  }
}

// Block (query tile, value slice, image).
__global__ void __launch_bounds__(NTH, 1)
    attn_fwd_bf16(AttnArgs a, const __grid_constant__ Maps mp) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm =
      smem_raw + ((1024 - (wg::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ring_qk = sm;
  unsigned char* ring_v = sm + OFF_V;
  float* alpha_s = reinterpret_cast<float*>(sm + OFF_ROW);   // [2][T]
  float* linv_s = alpha_s + 2 * T;                             // [T]
  const unsigned fq = wg::smem_u32(sm + OFF_BAR), eq = fq + 8 * RQ;
  const unsigned fv = eq + 8 * RQ, ev = fv + 8 * RV;
  const unsigned pb = wg::smem_u32(sm + OFF_P), wb = wg::smem_u32(sm + OFF_W);

  const int bi = blockIdx.z, q0 = blockIdx.x * T, c0 = blockIdx.y * SLICE;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nkt = (a.m + T - 1) / T, nd = (a.d + T - 1) / T;
  const int nv = min(NV, (a.c - c0 + T - 1) / T);   // V chunks inside c
  const int qb = a.q_bs ? bi : 0, kb = a.k_bs ? bi : 0, vb = a.v_bs ? bi : 0;

  // Full barriers: one arrive (the producer's expect_tx).  Empty: one
  // arrive per consumer warp that reads the slot (Q/K: consumer 0's 4;
  // V: both consumers' 8).
  if (tid == 0) {
    for (int i = 0; i < RQ; ++i) {
      wg::mbar_init(fq + 8 * i, 1);
      wg::mbar_init(eq + 8 * i, 4);
    }
    for (int i = 0; i < RV; ++i) {
      wg::mbar_init(fv + 8 * i, 1);
      wg::mbar_init(ev + 8 * i, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (lane != 0) return;
    if (warp == 8) {          // Q and K over d, for every key tile
      for (int j = 0, g = 0; j < nkt; ++j)
        for (int t = 0; t < nd; ++t, ++g) {
          const int s = claim<RQ>(fq, eq, g, 2 * CB);
          const unsigned dst = wg::smem_u32(ring_qk + s * SLOT_QK);
          wg::tma_load_3d(dst, &mp.q, T * t, q0, qb, fq + 8 * s);
          wg::tma_load_3d(dst + CB, &mp.k, T * t, T * j, kb, fq + 8 * s);
        }
    } else if (warp == 9) {   // the key tile's V at the slice
      for (int j = 0; j < nkt; ++j) {
        const int s = claim<RV>(fv, ev, j, nv * CB);
        const unsigned dst = wg::smem_u32(ring_v + s * SLOT_V);
        for (int h = 0; h < nv; ++h)
          wg::tma_load_3d(dst + h * CB, &mp.v, c0 + T * h, T * j, vb,
                          fv + 8 * s);
      }
    }
    return;
  }
  // -------------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wgi = warp >> 2, wl = warp & 3, tw = tid & 127;
  const int g8 = lane >> 2, tq = lane & 3;
  float acc[NV * 32];   // consumer 0: M1, consumer 1: M2 (unnormalized)
#pragma unroll
  for (int i = 0; i < NV * 32; ++i) acc[i] = 0.f;
  float inv[2];

  if (wgi == 0) {
    float mrow[2] = {NEG, NEG};   // running max of this thread's two rows, base 2
    float lrow[2] = {0.f, 0.f};   // this thread's share of their running sums
    int g = 0;
    for (int j = 0; j < nkt; ++j) {
      // S over d: one wgmma group per stage, the one before kept in flight
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
      for (int t = 0; t < nd; ++t, ++g) {
        const int slot = g % RQ;
        wg::mbar_wait(fq + 8 * slot, (g / RQ) & 1);
        const unsigned b = wg::smem_u32(ring_qk + slot * SLOT_QK);
        wg::fence_acc(s);
        wg::wgmma_fence();
        mma_xyt(s, b, b + CB);
        wg::wgmma_commit();
        wg::wgmma_wait<1>();   // the stage before is done
        wg::fence_acc(s);
        if (t > 0 && lane == 0) wg::mbar_arrive(eq + 8 * ((g - 1) % RQ));
      }
      wg::wgmma_wait<0>();
      wg::fence_acc(s);
      if (lane == 0) wg::mbar_arrive(eq + 8 * ((g - 1) % RQ));

      // Online softmax, base 2.  s[4 jj + 2 h + t]: row 16 wl + g8 + 8 h,
      // key T j + 8 jj + 2 tq + t.
      float tmax[2] = {NEG, NEG};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int key = T * j + 8 * (i >> 2) + 2 * tq + (i & 1);
        s[i] = key < a.m ? s[i] * LOG2E : NEG;
        tmax[(i >> 1) & 1] = fmaxf(tmax[(i >> 1) & 1], s[i]);
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
      unsigned char* P = sm + OFF_P + (j & 1) * CB;
      float ls[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int h = (i >> 1) & 1;
        const float p0 = exp2f(s[i] - mrow[h]);
        const float p1 = exp2f(s[i + 1] - mrow[h]);
        ls[h] += p0 + p1;
        store_p(P, wl, g8, tq, i >> 2, h, p0, p1);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        lrow[h] = lrow[h] * alpha[h] + ls[h];
        if (tq == 0) alpha_s[(j & 1) * T + 16 * wl + g8 + 8 * h] = alpha[h];
      }
      wg::fence_async_shared();
      bar_sync(1, 256);   // P(j) and its factors are out; P(j - 1) is free

      // M1 = M1 alpha + P V (a warp whose factors are all 1 skips the rescale)
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int i = 0; i < NV * 32; ++i) acc[i] *= alpha[(i >> 1) & 1];
      }
      const int sv = j % RV;
      wg::mbar_wait(fv + 8 * sv, (j / RV) & 1);
      wg::fence_acc(acc);
      wg::wgmma_fence();
      mma_p_slice(acc, pb + (j & 1) * CB, wg::smem_u32(ring_v + sv * SLOT_V));
      wg::wgmma_commit();
      wg::wgmma_wait<0>();
      wg::fence_acc(acc);
      if (lane == 0) wg::mbar_arrive(ev + 8 * sv);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float l = lrow[h];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      inv[h] = 1.f / l;
      const int r = 16 * wl + g8 + 8 * h;
      if (tq == 0) {
        linv_s[r] = inv[h];
        if (blockIdx.y == 0 && q0 + r < a.n)
          a.lse[(size_t)bi * a.n + q0 + r] = mrow[h] * LN2 + logf(l);
      }
    }
    bar_sync(1, 256);
    store_slice(a.m1, acc, inv, a, bi, q0, c0, wl, g8, tq);
  } else {
    for (int j = 0; j < nkt; ++j) {
      // W = V o V into consumer 1's buffer (same swizzle), then V is free
      const int sv = j % RV;
      wg::mbar_wait(fv + 8 * sv, (j / RV) & 1);
      const uint4* y = reinterpret_cast<const uint4*>(ring_v + sv * SLOT_V);
      uint4* w = reinterpret_cast<uint4*>(sm + OFF_W);
      for (int r = 0; r < nv * (CB / 16 / 128); ++r) {
        uint4 x = y[tw + 128 * r];
        x.x = square_bf16x2(x.x);
        x.y = square_bf16x2(x.y);
        x.z = square_bf16x2(x.z);
        x.w = square_bf16x2(x.w);
        w[tw + 128 * r] = x;
      }
      __syncwarp();
      if (lane == 0) wg::mbar_arrive(ev + 8 * sv);
      wg::fence_async_shared();
      bar_sync(1, 256);   // P(j) is in; every W write of this warpgroup is done

      // M2 = M2 alpha + P W
      const float* al = alpha_s + (j & 1) * T + 16 * wl + g8;
      const float alpha[2] = {al[0], al[8]};
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int i = 0; i < NV * 32; ++i) acc[i] *= alpha[(i >> 1) & 1];
      }
      wg::fence_acc(acc);
      wg::wgmma_fence();
      mma_p_slice(acc, pb + (j & 1) * CB, wb);
      wg::wgmma_commit();
      wg::wgmma_wait<0>();
      wg::fence_acc(acc);
    }
    bar_sync(1, 256);
    inv[0] = linv_s[16 * wl + g8];
    inv[1] = linv_s[16 * wl + g8 + 8];
    store_slice(a.m2, acc, inv, a, bi, q0, c0, wl, g8, tq);
  }
}

// ---------------------------------------------------------------- float32

constexpr int FSLICE = 256;            // value columns per block
constexpr int FNV = FSLICE / T;        // 64-column chunks of a slice
constexpr int FRQ = 3;                 // (Q, K) stages of 32 columns of d
constexpr int FRV = 3;                 // V^T (or W^T) slots of a consumer's ring
constexpr int FSLOT = 2 * FB;          // one (chunk, 32-key half): [big | small]
constexpr int FOFF_V = FRQ * FSTAGE;
constexpr int FOFF_W = FOFF_V + FRV * FSLOT;
constexpr int FOFF_P = FOFF_W + FRV * FSLOT;     // P: [half][big | small]
constexpr int FOFF_ROW = FOFF_P + 4 * FB;        // rescale factors [T], 1/l [T]
constexpr int FOFF_BAR = FOFF_ROW + 2 * T * 4;
constexpr int FNBAR = 2 * (FRQ + 2 * FRV);
constexpr int SMEM_F32 = 1024 + FOFF_BAR + FNBAR * 8;
static_assert(SMEM_F32 <= 232448, "f32 K3 exceeds a block's shared memory");

// The operands as the pre-pass writes them: tensor maps over (2 P, rows,
// cols) float32, big parts in planes [0, P), small in [P, 2P); P = 1 for
// an input broadcast over the batch (stride 0), else b.
struct SplitMaps {
  CUtensorMap q, k;     // (n, d), (m, d)
  CUtensorMap vt, wt;   // (c, m): keys contiguous
  int pq, pk, pv;
};

// acc[h] = acc[h] + P O_h^T over one key tile for the chunks h < nv: P
// (64 rows x 64 keys, tf32 parts in two 32-key halves) and the chunk's two
// 32-key halves of O^T (64 columns x 32 keys, big and small) from this
// consumer's ring (uses g and g + 1, counted across tiles).  Each chunk's
// 24 products go into a fresh partial sum, the small-part ones first,
// added to acc[h] in float32 once they are done; its slots are then
// released (one arrive per warp).
__device__ __forceinline__ void pv_tf32(float (&acc)[FNV][32], unsigned p,
                                        unsigned char* ring, unsigned full,
                                        unsigned empty, int& g, int nv,
                                        int lane) {
#pragma unroll
  for (int h = 0; h < FNV; ++h) {
    if (h < nv) {
      float part[32];
      wg::fence_acc(part);
      wg::wgmma_fence();
#pragma unroll
      for (int kh = 0; kh < 2; ++kh) {   // the small-part products first
        const int u = g + kh, slot = u % FRV;
        wg::mbar_wait(full + 8 * slot, (u / FRV) & 1);
        const unsigned b = wg::smem_u32(ring + slot * FSLOT), a = p + kh * 2 * FB;
#pragma unroll
        for (int ks = 0; ks < FW / 8; ++ks) {
          wg::wgmma_tf32(part, kmajor(a + FB, ks), kmajor(b, ks), kh + ks > 0);
          wg::wgmma_tf32(part, kmajor(a, ks), kmajor(b + FB, ks));
        }
      }
#pragma unroll
      for (int kh = 0; kh < 2; ++kh) {
        const unsigned b = wg::smem_u32(ring + (g + kh) % FRV * FSLOT),
                       a = p + kh * 2 * FB;
#pragma unroll
        for (int ks = 0; ks < FW / 8; ++ks)
          wg::wgmma_tf32(part, kmajor(a, ks), kmajor(b, ks));
      }
      wg::wgmma_commit();
      wg::wgmma_wait<0>();
      wg::fence_acc(part);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[h][i] += part[i];
      if (lane == 0) {
        wg::mbar_arrive(empty + 8 * (g % FRV));
        wg::mbar_arrive(empty + 8 * ((g + 1) % FRV));
      }
      g += 2;
    }
  }
}

// Writes acc[h] * inv (acc[h][4 jj + 2 hh + t]: row q0 + 16 wl + g8 + 8 hh,
// column c0 + 64 h + 8 jj + 2 tq + t) into out (b, n, c) float32, inside
// [0, n) x [0, c).
__device__ __forceinline__ void store_slice_f32(void* out,
                                                const float (&acc)[FNV][32],
                                                const float (&inv)[2],
                                                const AttnArgs& a, int bi,
                                                int q0, int c0, int wl, int g8,
                                                int tq) {
  float* o = static_cast<float*>(out) + (size_t)bi * a.n * a.c;
#pragma unroll
  for (int h = 0; h < FNV; ++h)
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int col = c0 + T * h + 8 * (e >> 2) + 2 * tq + (e & 1);
      const int hh = (e >> 1) & 1, row = q0 + 16 * wl + g8 + 8 * hh;
      if (col < a.c && row < a.n) o[(size_t)row * a.c + col] = acc[h][e] * inv[hh];
    }
}

// The f32 kernel, block (query tile, value slice, image).  Consumer 0
// computes S = Q K^T over d in stages of 32 columns (phase1_tf32: a fresh
// partial per stage), runs the online softmax in natural exponentials,
// writes P as tf32 parts and the tile's rescale factors to shared memory,
// then M1 = M1 alpha + P V; consumer 1 computes M2 = M2 alpha + P W from
// the same P.  P has one buffer: consumer 0 writes P(j) once consumer 1
// is done with P(j - 1) (named barrier 2), consumer 1 reads it once it is
// out (named barrier 1), so consumer 1's P W of tile j runs beside
// consumer 0's S of tile j + 1.  The producer's warps run one ring each:
// (Q, K) stages; V^T slots (consumer 0's); W^T slots (consumer 1's).
__global__ void __launch_bounds__(NTH, 1)
    attn_fwd_tf32(AttnArgs a, const __grid_constant__ SplitMaps mp) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm =
      smem_raw + ((1024 - (wg::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ring_qk = sm;
  float* alpha_s = reinterpret_cast<float*>(sm + FOFF_ROW);   // [T]
  float* linv_s = alpha_s + T;                                 // [T]
  const unsigned fq = wg::smem_u32(sm + FOFF_BAR), eq = fq + 8 * FRQ;
  const unsigned fv = eq + 8 * FRQ, ev = fv + 8 * FRV;
  const unsigned fw = ev + 8 * FRV, ew = fw + 8 * FRV;
  const unsigned pb = wg::smem_u32(sm + FOFF_P);

  const int bi = blockIdx.z, q0 = blockIdx.x * T, c0 = blockIdx.y * FSLICE;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nkt = (a.m + T - 1) / T, nd = (a.d + FW - 1) / FW;
  const int nv = min(FNV, (a.c - c0 + T - 1) / T);   // chunks inside c

  // Full barriers: one arrive (the producer's expect_tx).  Empty: one
  // arrive per warp of the consumer that reads the ring.
  if (tid == 0) {
    for (int i = 0; i < FRQ; ++i) {
      wg::mbar_init(fq + 8 * i, 1);
      wg::mbar_init(eq + 8 * i, 4);
    }
    for (int i = 0; i < FRV; ++i) {
      wg::mbar_init(fv + 8 * i, 1);
      wg::mbar_init(ev + 8 * i, 4);
      wg::mbar_init(fw + 8 * i, 1);
      wg::mbar_init(ew + 8 * i, 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (lane != 0) return;
    if (warp == 8) {          // Q and K over d, for every key tile
      for (int j = 0, g = 0; j < nkt; ++j)
        for (int t = 0; t < nd; ++t, ++g) {
          const int s = claim<FRQ>(fq, eq, g, FSTAGE);
          load_stage(wg::smem_u32(ring_qk + s * FSTAGE), fq + 8 * s, &mp.q,
                     mp.pq, q0, &mp.k, mp.pk, T * j, FW * t, bi);
        }
    } else if (warp <= 10) {  // V^T (warp 9) or W^T (warp 10) at the slice
      const bool w = warp == 10;
      const CUtensorMap* map = w ? &mp.wt : &mp.vt;
      unsigned char* ring = sm + (w ? FOFF_W : FOFF_V);
      const unsigned full = w ? fw : fv, empty = w ? ew : ev;
      for (int j = 0, u = 0; j < nkt; ++j)
        for (int h = 0; h < nv; ++h)
          for (int kh = 0; kh < 2; ++kh, ++u) {
            const int s = claim<FRV>(full, empty, u, FSLOT);
            const unsigned dst = wg::smem_u32(ring + s * FSLOT);
            const int key = T * j + FW * kh, col = c0 + T * h;
            wg::tma_load_3d(dst, map, key, col, plane(0, mp.pv, bi),
                            full + 8 * s);
            wg::tma_load_3d(dst + FB, map, key, col, plane(1, mp.pv, bi),
                            full + 8 * s);
          }
    }
    return;
  }
  // -------------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wgi = warp >> 2, wl = warp & 3;
  const int g8 = lane >> 2, tq = lane & 3;
  float acc[FNV][32];   // consumer 0: M1, consumer 1: M2 (unnormalized)
#pragma unroll
  for (int h = 0; h < FNV; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[h][i] = 0.f;
  float inv[2];
  int g = 0;   // uses of this consumer's value ring

  if (wgi == 0) {
    float mrow[2] = {NEG, NEG};   // running max of this thread's two rows
    float lrow[2] = {0.f, 0.f};   // this thread's share of their running sums
    int gq = 0;
    for (int j = 0; j < nkt; ++j) {
      float s[32];
      phase1_tf32<FRQ>(s, ring_qk, fq, eq, gq, nd, lane);
      // Online softmax.  s[4 jj + 2 h + t]: row 16 wl + g8 + 8 h, key T j +
      // 8 jj + 2 tq + t.
      float tmax[2] = {NEG, NEG};
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        if (T * j + 8 * (e >> 2) + 2 * tq + (e & 1) >= a.m) s[e] = NEG;
        tmax[(e >> 1) & 1] = fmaxf(tmax[(e >> 1) & 1], s[e]);
      }
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(0xffffffffu, tmax[h], 1));
        tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(0xffffffffu, tmax[h], 2));
        const float mnew = fmaxf(mrow[h], tmax[h]);
        alpha[h] = expf(mrow[h] - mnew);
        mrow[h] = mnew;
      }
      if (j > 0) bar_sync(2, 256);   // consumer 1 is done with P(j - 1)
      unsigned char* P = sm + FOFF_P;
      float ls[2] = {0.f, 0.f};
#pragma unroll
      for (int e = 0; e < 32; e += 2) {
        const int h = (e >> 1) & 1;
        const float p0 = expf(s[e] - mrow[h]), p1 = expf(s[e + 1] - mrow[h]);
        ls[h] += p0 + p1;
        store_p_tf32(P, p_offset(wl, g8, tq, e >> 2, h), p0, p1);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        lrow[h] = lrow[h] * alpha[h] + ls[h];
        if (tq == 0) alpha_s[16 * wl + g8 + 8 * h] = alpha[h];
      }
      wg::fence_async_shared();
      bar_arrive(1, 256);   // P(j) and its factors are out
#pragma unroll
      for (int h = 0; h < FNV; ++h)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[h][i] *= alpha[(i >> 1) & 1];
      pv_tf32(acc, pb, sm + FOFF_V, fv, ev, g, nv, lane);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float l = lrow[h];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      inv[h] = 1.f / l;
      const int r = 16 * wl + g8 + 8 * h;
      if (tq == 0) {
        linv_s[r] = inv[h];
        if (blockIdx.y == 0 && q0 + r < a.n)
          a.lse[(size_t)bi * a.n + q0 + r] = mrow[h] + logf(l);
      }
    }
    bar_sync(2, 256);     // consumer 1 is past its last tile's factors
    bar_arrive(1, 256);   // 1/l is out
    store_slice_f32(a.m1, acc, inv, a, bi, q0, c0, wl, g8, tq);
  } else {
    for (int j = 0; j < nkt; ++j) {
      bar_sync(1, 256);   // P(j) and its factors are in
      const float alpha[2] = {alpha_s[16 * wl + g8], alpha_s[16 * wl + g8 + 8]};
#pragma unroll
      for (int h = 0; h < FNV; ++h)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[h][i] *= alpha[(i >> 1) & 1];
      pv_tf32(acc, pb, sm + FOFF_W, fw, ew, g, nv, lane);
      bar_arrive(2, 256);   // P(j) is free
    }
    bar_sync(1, 256);
    inv[0] = linv_s[16 * wl + g8];
    inv[1] = linv_s[16 * wl + g8 + 8];
    store_slice_f32(a.m2, acc, inv, a, bi, q0, c0, wl, g8, tq);
  }
}

// The f32 K3's split operands (q, k, v^T, w^T) one after another from base.
static SplitLayout<4> k3_layout(const AttnArgs& a, int b, float* base) {
  const int pq = a.q_bs ? b : 1, pk = a.k_bs ? b : 1, pv = a.v_bs ? b : 1;
  const int dp = (a.d + 3) / 4 * 4, mp = (a.m + 3) / 4 * 4;
  const float *q = static_cast<const float*>(a.q),
              *k = static_cast<const float*>(a.k),
              *v = static_cast<const float*>(a.v);
  const SplitJob spec[4] = {
      {q, a.q_bs, a.n, a.d, nullptr, a.n, dp, pq, 0},
      {k, a.k_bs, a.m, a.d, nullptr, a.m, dp, pk, 0},
      {v, a.v_bs, a.m, a.c, nullptr, a.c, mp, pv, 2},
      {v, a.v_bs, a.m, a.c, nullptr, a.c, mp, pv, 3}};
  return SplitLayout<4>(spec, base);
}

// The f32 K3's pre-pass and main kernel.  scratch holds
// vst_k3_scratch_floats(...) floats.
static cudaError_t k3_tf32(const AttnArgs& a, int b, float* scratch,
                           cudaStream_t s) {
  const SplitLayout<4> lay = k3_layout(a, b, scratch);
  SplitMaps mp;
  cudaError_t e = lay.run({&mp.q, &mp.k, &mp.vt, &mp.wt}, s);
  mp.pq = lay.job[0].planes;
  mp.pk = lay.job[1].planes;
  mp.pv = lay.job[2].planes;
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(attn_fwd_tf32,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_F32);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.n + T - 1) / T, (a.c + FSLICE - 1) / FSLICE, b);
  attn_fwd_tf32<<<grid, NTH, SMEM_F32, s>>>(a, mp);
  return cudaGetLastError();
}

}  // namespace k3

// Returns 0 on success, else the CUDA error of the tensor maps, the
// attribute call or the launch.  bf16 needs d and c multiples of 8 and
// 16-byte aligned rows and batch strides (TMA); the wrapper checks.
// float32 needs scratch of vst_k3_scratch_floats(...) floats (its split
// operands); bf16 takes none.
extern "C" int vst_k3_attention_moments(
    const void* q, const void* k, const void* v, void* m1, void* m2,
    float* lse, void* scratch, int b, int n, int m, int d, int c,
    long long q_bs, long long k_bs, long long v_bs, int bf16, void* stream) {
  using namespace k3;
  AttnArgs a{q, k, v, m1, m2, lse, n, m, d, c, q_bs, k_bs, v_bs};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!bf16) return static_cast<int>(k3_tf32(a, b, static_cast<float*>(scratch), s));
  Maps mp;
  cudaError_t e = chunk_map(&mp.q, q, d, n, b, q_bs);
  if (e == cudaSuccess) e = chunk_map(&mp.k, k, d, m, b, k_bs);
  if (e == cudaSuccess) e = chunk_map(&mp.v, v, c, m, b, v_bs);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(attn_fwd_bf16,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BF16);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((n + T - 1) / T, (c + SLICE - 1) / SLICE, b);
  attn_fwd_bf16<<<grid, NTH, SMEM_BF16, s>>>(a, mp);
  return static_cast<int>(cudaGetLastError());
}

// Floats of scratch the f32 K3 needs (its split operands; the wrapper
// allocates them).
extern "C" long long vst_k3_scratch_floats(int b, int n, int m, int d, int c,
                                          long long q_bs, long long k_bs,
                                          long long v_bs) {
  using namespace k3;
  const AttnArgs a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                   n, m, d, c, q_bs, k_bs, v_bs};
  return k3_layout(a, b, nullptr).total;
}

// The launch configuration of both bodies: out = {bf16 dynamic shared
// memory bytes per block, resident blocks per SM, value columns per block,
// then the same three of the f32 (3xTF32) body}.  Returns a CUDA error
// code.
extern "C" int vst_k3_launch_config(int* out) {
  using namespace k3;
  cudaError_t e = cudaFuncSetAttribute(
      attn_fwd_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BF16);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(attn_fwd_tf32,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_F32);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], attn_fwd_bf16,
                                                      NTH, SMEM_BF16);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[4], attn_fwd_tf32,
                                                      NTH, SMEM_F32);
  out[0] = SMEM_BF16;
  out[2] = SLICE;
  out[3] = SMEM_F32;
  out[5] = FSLICE;
  return static_cast<int>(e);
}
