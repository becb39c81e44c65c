// K4 and K5: the backward of the AdaAttN softmax attention moments (K3).
//
// With S = Q K^T, A = exp(S - L), W = V o V and the row term
// D = sum_c(dM1 o M1 + dM2 o M2) (float32, computed by the caller):
//   dA = dM1 V^T + dM2 W^T,   dS = A o (dA - D)
//   K4:  dQ = dS K
//   K5:  dK = dS^T Q,   dV = A^T dM1 + 2 V o (A^T dM2)
// q (b, n, d), k (b, m, d), v (b, m, c) in bfloat16 or float32, with batch
// strides as arguments (a Q, K or V broadcast with stride 0 is read in
// place); dM1, dM2 (b, n, c) contiguous in the inputs' type; L, D (b, n)
// float32, L in the natural log.  dQ (b, n, d), dK (b, m, d), dV (b, m, c)
// come out contiguous in the inputs' type.  The float32 K4 and K5 also
// take scratch for their split operands (vst_k4_scratch_floats,
// vst_k5_scratch_floats).
//
// Replaces the Pallas TPU kernels vst_tpu/kernels/adaattn_attention.py
// _bwd_dq_kernel (:151, K4) and _bwd_dkv_kernel (:182, K5), driven by
// _backward.  As there, K4 owns query rows and walks over the keys, K5
// owns keys and walks over the queries: nothing of the (n x m) map reaches
// device memory, no atomics, the result does not depend on the order
// blocks run in (two launches give the same bits).  Ragged n, m, d and c
// are masked in the kernel (zero-filled loads, A = 0 outside [0, n) x
// [0, m)): no padded copies, but for the float32 split operands.
//
// bf16 (training at the serving type), on Hopper's wgmma.  The TPU keeps a
// whole (block x d) float32 accumulator in VMEM; a 64 x 1472 one (376 KB)
// fits neither a block's registers nor its shared memory, so a block owns
// an output slice of at most 512 columns (dQ, dK) or 256 (dV) and
// computes S and dA once per (tile, slice):
// - K4 block = (image, 64 query rows, <= 512 dQ columns), walking the key
//   tiles of 64.  K5 block = (image, 64 keys, a role): a dK role owns <= 512
//   dK columns and computes S^T and dA^T; a dV role owns <= 256 dV columns
//   and computes S^T only (dV needs A, not dS).
// - Three warpgroups.  Consumer 0 computes S over d (K4, K5 dK) while
//   consumer 1 computes dA over c; in a dV role they split d in halves and
//   consumer 0 adds the two.  One of them then forms dS = A o (dA - D)
//   (or A^T), rounds it to bf16 and writes it to shared memory once; both
//   accumulate their half of the slice from it: dQ[:, half] += dS K[:, half]
//   (4 chunks of 64 columns each, 128 float32 registers a thread), dK
//   likewise from Q, and in a dV role each consumer keeps A^T dM1 and
//   A^T dM2 for its 128 columns, so dV = A^T dM1 + 2 V o (A^T dM2) is formed
//   in float32 in the epilogue without an exchange.
// - Every product is wgmma m64n64k16 (bf16 in, float32 accumulate) with
//   both operands in shared memory.  Operand chunks are 64 x 64 bf16 boxes
//   loaded by TMA (3-D tensor maps over (columns, rows, image): rows
//   outside [0, n) or [0, m) of an image and columns past d or c arrive as
//   zeros) with the 128-byte swizzle.  S = Q K^T and dA = dM V^T read K and
//   V as K-major B; dQ = dS K and dK = dS^T Q read the same boxes N-major;
//   dS and A^T are written by the threads in the same swizzled K-major
//   layout.
// - The producer warpgroup (setmaxnreg 40) runs three rings, one thread
//   each, behind full/empty mbarriers: consumer 0's chunks of d (Q and K, 3
//   stages of 16 KB), consumer 1's chunks of c (dM1, dM2 and V, 2 stages of
//   32 KB; W = V o V is squared in float32 into the slot's fourth quarter
//   and rounded to bf16 by consumer 1), and the slice's output-product
//   chunks (8 slots of 8 KB, reloaded per tile).  Consumers
//   (setmaxnreg 232) keep one wgmma group in flight (wait_group 1) and
//   release a stage once its multiply is done.  The two consumers meet at
//   two named barriers per tile, around the dS exchange (16 KB float32 of
//   A, S or partial S, and 8 KB of bf16 dS).
// - K5's L log2 e and D of each query tile are staged in shared memory,
//   double-buffered, by the producer's fourth warp (read from global
//   memory by the consumers, their latency sat on every tile's path).
// - Shared memory per block: 48 + 64 + 64 + 8 + 16 + 1 KB, 30 mbarriers
//   and 1 KB of alignment, 207,088 bytes: one block of 384 threads per SM.
//   Registers (ptxas): 168 a thread at launch, no spills; the consumers
//   hold 128 accumulator registers (4 chunks of 64 columns) plus the
//   32 of S or dA.
//   Q and dM are streamed beside K and V, not kept resident: a 64 x 1472 Q
//   tile alone would be 188 KB.
//
// Executed work against the least (4nm(d + c) for K4, 4nmd + 8nmc for K5
// per image): K4 runs s (2nmd + 4nmc) + 2nmd with s = ceil(d / 512) slices,
// K5 s (2nmd + 4nmc) + 2nmd + r 2nmd + 4nmc with r = ceil(c / 256) dV
// roles: at AdaAttN's relu3_1 / relu4_1 / relu5_1 (d = 448 / 960 / 1472,
// c = 256 / 512 / 512) K4 1.00 / 1.67 / 2.26x and K5 1.23 / 1.98 / 2.59x.
// What bounds them on the H100: the least work is tensor-core (bf16)
// bound, but these blocks reread their streamed chunks from L2 every tile
// (Q and dM per key tile in K4, K and V per query tile in K5: 264 KB per
// K4 tile at relu3_1 for 11.5 MFLOP), which asks about 6 TB/s of L2 at the
// measured 256 TFLOP/s, and the phases of a tile (S and dA, the exchange,
// the output product) run one after the other in the one block an SM holds
// (PERF.md).
//
// Rounding points, as the plain version: W = V o V squared in float32 and
// rounded to bf16; A and dS rounded to bf16 before their products; dA, the
// accumulators and dV's epilogue in float32.  Scores are scaled by log2 e
// for exp2f; L arrives in the natural log and is scaled the same way.
//
// float32 (parity, 1e-4 of each output's scale against float64): 3xTF32
// on wgmma m64n64k8 with the bf16 bodies' tiling, roles and rings (K4
// attn_dq_tf32, K5 attn_dkv_tf32): x = big + small with big = tf32(x) and
// small = tf32(x - big) (both rounded to nearest by cvt.rna, so nothing
// depends on whether the tensor core truncates or rounds a raw float32's
// low 13 bits), and a b = a_small b_big + a_big b_small + a_big b_big, the
// small terms first, small x small dropped (relative error about 2^-21 a
// product).  A pre-pass kernel (split_tf32, attn_common.cuh, shared with
// the float32 K3) writes both parts of every operand the rings read into
// scratch the wrapper allocates (K^T for K4, Q^T and dM^T for K5 too: tf32
// takes no N-major B), and the threads split dS (dS^T, A^T).  The tensor
// core's float32 accumulation does not round to nearest: S and dA as one
// chain of wgmma per tile left dK 1.3e-4 of its scale from float64 at
// relu3_1 with scores of std 10, the output products as one chain over 64
// query tiles 3e-5 at unit scores, so every stage (32 columns of d or c)
// and every output chunk of a tile is summed in a fresh partial that the
// consumer adds in float32: 8e-7 / 6e-6 / 4e-5 at scores of std 1 / 10 /
// 100, for 1% of the time (experiments/k5_f32_variants.py,
// k4_f32_variants.py).  K4 is K5's dK role with queries and keys swapped:
// a block owns 64 query rows and 512 dQ columns and walks the key tiles,
// consumer 0 computes S over d, consumer 1 dA over c, the exchange goes
// through P in place (A = exp(S - L) raw, then dS as tf32 parts), each
// consumer adds dS K into its 256 columns from an output ring of K^T
// halves; L and D of the block's rows are written once to shared memory.
// Shared memory (both): rings of 2 x 32 KB and 2 x 32 KB, two output rings
// of 2 x 16 KB (one per consumer), 32 KB of dS / dS^T / A^T parts, 1 KB of
// L and D: 231,584 bytes, one block per SM; 168 registers at launch, no
// spills.  Executed tf32 work 3 x the bf16
// factors: K4 3.0 / 5.0 / 6.8x and K5 3.7 / 6.0 / 7.8x the least at relu3_1
// / relu4_1 / relu5_1; the least work is bound by the tensor cores' 495
// TFLOP/s tf32 peak (165 for 3xTF32 on the least work).  What holds the
// f32 K4 (experiments/k4_f32_variants.py, PERF.md) is not its products but
// the L2 bytes: a block streams the parts of Q, K, dM1, dM2, V, W and K^T
// every key tile, 1.2 MB per (block, key tile) at relu3_1, 39.5 GB a
// launch, about 5.5 TB/s at its 7.2 ms; without dA it is no faster,
// without S 3%, without dS K 8%.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attn_common.cuh"   // bf16 packing, LOG2E / NEG, chunks, TMA maps

namespace k45 {

using namespace attn;

struct BwdArgs {
  const void* q;      // (b, n, d), batch stride q_bs (may be 0)
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

constexpr int SLICE_DQ = 512;          // dQ or dK columns per block: 8 chunks
constexpr int SLICE_DV = 256;          // dV columns per block: 4 chunks
constexpr int R0 = 3;                  // consumer 0's ring: stages of 2 chunks
constexpr int R1 = 2;                  // consumer 1's ring: stages of 4 chunks
constexpr int NO = 8;                  // output-product chunk slots
constexpr int SLOT0 = 2 * CB;          // ring 0 slot: [A | B]
constexpr int SLOT1 = 4 * CB;          // ring 1 slot: [dM1 | dM2 | V | W] or [K | Q]
constexpr int NTH = 384;               // two consumer warpgroups, one producer
constexpr int OFF_R1 = R0 * SLOT0;
constexpr int OFF_O = OFF_R1 + R1 * SLOT1;
constexpr int OFF_P = OFF_O + NO * CB;          // dS or A^T, bf16
constexpr int OFF_X = OFF_P + CB;               // the exchange, float32
constexpr int OFF_ROW = OFF_X + T * T * 4;      // K5: L log2 e and D, [2][2][T] float32
constexpr int OFF_BAR = OFF_ROW + 2 * 2 * T * 4;
constexpr int NBAR = 2 * (R0 + R1 + NO + 2);
constexpr int SMEM_BF16 = 1024 + OFF_BAR + NBAR * 8;

// The operands' tensor maps (bf16, 64 x 64 boxes, 128-byte swizzle).
struct Maps {
  CUtensorMap q, k, v, dm1, dm2;
};

// Phase-1 stage kinds: S (or S^T) over one chunk of d from [A | B]; dA
// over one chunk of c from [dM1 | dM2 | V | W], as dM V^T (K4) or V dM^T
// (K5).
enum Kind { QK, DA_K4, DA_K5 };

// acc (64 x 64) += P O over the tile: P (64 x 64, K-major) and one chunk O
// whose 64 rows are the K dimension (N-major).
__device__ __forceinline__ void mma_po(float (&acc)[32], unsigned p,
                                       unsigned o) {
#pragma unroll
  for (int ks = 0; ks < T / 16; ++ks)
    wg::wgmma_bf16<64, wg::B_NMAJOR>(acc, kmajor(p, ks), nmajor(o, ks));
}

// One consumer warpgroup's first phase on one tile: `count` stages of its
// ring (D slots of SLOT bytes, stage counter g carried across tiles) into
// acc, which starts at zero.  A slot is released (one arrive per warp)
// once the multiply that reads it is done.
template <int D, int SLOT, Kind K>
__device__ __forceinline__ void phase1(float (&acc)[32], unsigned char* ring,
                                       unsigned full, unsigned empty, int& g,
                                       int count, int tw) {
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  for (int t = 0; t < count; ++t, ++g) {
    const int slot = g % D;
    unsigned char* s = ring + slot * SLOT;
    wg::mbar_wait(full + 8 * slot, (g / D) & 1);
    if (K != QK) {   // W = V o V into the fourth chunk (same swizzle)
      const uint4* y = reinterpret_cast<const uint4*>(s + 2 * CB);
      uint4* w = reinterpret_cast<uint4*>(s + 3 * CB);
#pragma unroll
      for (int r = 0; r < CB / 16 / 128; ++r) {
        uint4 x = y[tw + 128 * r];
        x.x = square_bf16x2(x.x);
        x.y = square_bf16x2(x.y);
        x.z = square_bf16x2(x.z);
        x.w = square_bf16x2(x.w);
        w[tw + 128 * r] = x;
      }
      wg::fence_async_shared();
      bar_sync(2, 128);   // only consumer 1 squares
    }
    const unsigned b = wg::smem_u32(s);
    wg::fence_acc(acc);
    wg::wgmma_fence();
    if (K == QK) {
      mma_xyt(acc, b, b + CB);
    } else if (K == DA_K4) {   // dM1 V^T + dM2 W^T
      mma_xyt(acc, b, b + 2 * CB);
      mma_xyt(acc, b + CB, b + 3 * CB);
    } else {                   // V dM1^T + W dM2^T
      mma_xyt(acc, b + 2 * CB, b);
      mma_xyt(acc, b + 3 * CB, b + CB);
    }
    wg::wgmma_commit();
    wg::wgmma_wait<1>();   // the stage before is done
    wg::fence_acc(acc);
    if (t > 0 && (tw & 31) == 0) wg::mbar_arrive(empty + 8 * ((g - 1) % D));
  }
  wg::wgmma_wait<0>();
  wg::fence_acc(acc);
  if (count > 0 && (tw & 31) == 0) wg::mbar_arrive(empty + 8 * ((g - 1) % D));
}

// Second phase: acc[h] += P O_h for the chunks slots first + h (h < 4)
// whose bit is set in `mask`, from the output ring (parity = tile & 1).
// One wgmma group per chunk, the one before kept in flight: each slot is
// released as soon as its multiply is done, so the producer refills it
// for the next tile while the rest of this product runs.
__device__ __forceinline__ void phase2(float (&acc)[4][32], unsigned p,
                                       unsigned och, unsigned full,
                                       unsigned empty, int tile, int first,
                                       int mask, int lane) {
#pragma unroll
  for (int h = 0; h < 4; ++h) wg::fence_acc(acc[h]);
  wg::wgmma_fence();
  int prev = -1;   // the chunk whose group is still in flight
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    if (mask >> h & 1) {
      wg::mbar_wait(full + 8 * (first + h), tile & 1);
      mma_po(acc[h], p, och + (first + h) * CB);
      wg::wgmma_commit();
      wg::wgmma_wait<1>();
      if (prev >= 0 && lane == 0) wg::mbar_arrive(empty + 8 * (first + prev));
      prev = h;
    }
  }
  wg::wgmma_wait<0>();
#pragma unroll
  for (int h = 0; h < 4; ++h) wg::fence_acc(acc[h]);
  if (prev >= 0 && lane == 0) wg::mbar_arrive(empty + 8 * (first + prev));
}

// The output-ring slot sl of a block: tensor (0 = k for K4, q for K5 dK;
// 1 = dM1, 2 = dM2 for a dV role) and column; false if it lies past the
// output.  dQ / dK: slot sl is columns o0 + 64 sl (consumer sl / 4).  dV:
// consumer g = sl / 4 owns columns o0 + 128 g .. + 128; its slots hold dM1
// and then dM2 at those columns.
__device__ __forceinline__ bool out_chunk(int sl, bool dv_role, int o0,
                                          int width, int* which, int* col) {
  if (!dv_role) {
    *which = 0;
    *col = o0 + T * sl;
  } else {
    const int q = sl & 3;
    *which = 1 + (q >> 1);
    *col = o0 + 128 * (sl >> 2) + T * (q & 1);
  }
  return *col < width;
}

// Consumer g's chunk mask of the output ring (bit h: slot 4 g + h).
__device__ __forceinline__ int out_mask(int g, bool dv_role, int o0,
                                        int width) {
  int mask = 0, which, col;
#pragma unroll
  for (int h = 0; h < 4; ++h)
    if (out_chunk(4 * g + h, dv_role, o0, width, &which, &col)) mask |= 1 << h;
  return mask;
}

// Shared-memory layout and barrier addresses of both kernels.
struct Smem {
  unsigned char *ring0, *ring1, *och, *p;
  float *xs, *rowv;
  unsigned f0, e0, f1, e1, fo, eo, fr, er;
  __device__ explicit Smem(unsigned char* raw) {
    unsigned char* sm = raw + ((1024 - (wg::smem_u32(raw) & 1023)) & 1023);
    ring0 = sm;
    ring1 = sm + OFF_R1;
    och = sm + OFF_O;
    p = sm + OFF_P;
    xs = reinterpret_cast<float*>(sm + OFF_X);
    rowv = reinterpret_cast<float*>(sm + OFF_ROW);
    f0 = wg::smem_u32(sm + OFF_BAR);
    e0 = f0 + 8 * R0;
    f1 = e0 + 8 * R0;
    e1 = f1 + 8 * R1;
    fo = e1 + 8 * R1;
    eo = fo + 8 * NO;
    fr = eo + 8 * NO;
    er = fr + 8 * 2;
  }
  // Full barriers: one arrive (the producer's expect_tx, or the row
  // loader's lane 0).  Empty: one arrive per consumer warp that reads the
  // slot (4; the row vectors 8).
  __device__ void init() const {
    const unsigned bars[8][3] = {{f0, R0, 1}, {e0, R0, 4}, {f1, R1, 1},
                                 {e1, R1, 4}, {fo, NO, 1}, {eo, NO, 4},
                                 {fr, 2, 1},  {er, 2, 8}};
    for (const auto& b : bars)
      for (unsigned i = 0; i < b[1]; ++i) wg::mbar_init(b[0] + 8 * i, b[2]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
};

// K4, bf16.  Block (query tile, dQ slice of 512 columns, image).
__global__ void __launch_bounds__(NTH, 1)
    attn_dq_bf16(BwdArgs a, const __grid_constant__ Maps mp) {
  extern __shared__ unsigned char smem_raw[];
  const Smem sm(smem_raw);
  const int bi = blockIdx.z, q0 = blockIdx.x * T, o0 = blockIdx.y * SLICE_DQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nkt = (a.m + T - 1) / T, nd = (a.d + T - 1) / T;
  const int nc = (a.c + T - 1) / T;
  const int qb = a.q_bs ? bi : 0, kb = a.k_bs ? bi : 0, vb = a.v_bs ? bi : 0;

  if (tid == 0) sm.init();
  __syncthreads();

  if (warp >= 8) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (lane != 0) return;
    if (warp == 8) {          // Q and K over d
      for (int j = 0, g = 0; j < nkt; ++j)
        for (int t = 0; t < nd; ++t, ++g) {
          const int s = claim<R0>(sm.f0, sm.e0, g, 2 * CB);
          const unsigned dst = wg::smem_u32(sm.ring0 + s * SLOT0);
          wg::tma_load_3d(dst, &mp.q, T * t, q0, qb, sm.f0 + 8 * s);
          wg::tma_load_3d(dst + CB, &mp.k, T * t, T * j, kb, sm.f0 + 8 * s);
        }
    } else if (warp == 9) {   // dM1, dM2 and V over c
      for (int j = 0, g = 0; j < nkt; ++j)
        for (int u = 0; u < nc; ++u, ++g) {
          const int s = claim<R1>(sm.f1, sm.e1, g, 3 * CB);
          const unsigned dst = wg::smem_u32(sm.ring1 + s * SLOT1);
          wg::tma_load_3d(dst, &mp.dm1, T * u, q0, bi, sm.f1 + 8 * s);
          wg::tma_load_3d(dst + CB, &mp.dm2, T * u, q0, bi, sm.f1 + 8 * s);
          wg::tma_load_3d(dst + 2 * CB, &mp.v, T * u, T * j, vb, sm.f1 + 8 * s);
        }
    } else if (warp == 10) {  // this key tile's rows of K at the slice
      for (int j = 0; j < nkt; ++j)
        for (int sl = 0; sl < NO; ++sl) {
          int which, col;
          if (!out_chunk(sl, false, o0, a.d, &which, &col)) break;
          wg::mbar_wait(sm.eo + 8 * sl, (j & 1) ^ 1);
          wg::mbar_expect_tx(sm.fo + 8 * sl, CB);
          wg::tma_load_3d(wg::smem_u32(sm.och + sl * CB), &mp.k, col, T * j,
                          kb, sm.fo + 8 * sl);
        }
    }
    return;
  }
  // -------------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wgi = warp >> 2, wl = warp & 3, tw = tid & 127;
  const int g8 = lane >> 2, tq = lane & 3;
  float rowv[2];   // consumer 0: L log2 e of its two rows; consumer 1: D
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + 16 * wl + g8 + 8 * h;
    const bool ok = row < a.n;
    const size_t at = (size_t)bi * a.n + (ok ? row : 0);
    rowv[h] = wgi == 0 ? (ok ? a.lse[at] * LOG2E : BIG) : (ok ? a.dd[at] : 0.f);
  }
  const int mask = out_mask(wgi, false, o0, a.d);
  const unsigned p = wg::smem_u32(sm.p), och = wg::smem_u32(sm.och);
  float acc[4][32];
#pragma unroll
  for (int h = 0; h < 4; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[h][i] = 0.f;

  int g = 0;
  for (int j = 0; j < nkt; ++j) {
    float s[32];   // consumer 0: S; consumer 1: dA
    if (wgi == 0)
      phase1<R0, SLOT0, QK>(s, sm.ring0, sm.f0, sm.e0, g, nd, tw);
    else
      phase1<R1, SLOT1, DA_K4>(s, sm.ring1, sm.f1, sm.e1, g, nc, tw);
    // s[4 jj + 2 h + t]: row 16 wl + g8 + 8 h, key T j + 8 jj + 2 tq + t
    if (wgi == 0) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int key = T * j + 8 * (i >> 2) + 2 * tq + (i & 1);
        const float x = key < a.m ? s[i] * LOG2E : NEG;
        sm.xs[i * 128 + tw] = exp2f(x - rowv[(i >> 1) & 1]);
      }
    }
    bar_sync(1, 256);
    if (wgi == 1) {   // dS = A o (dA - D), rounded to bf16
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int h = (i >> 1) & 1;
        store_p(sm.p, wl, g8, tq, i >> 2, h,
                sm.xs[i * 128 + tw] * (s[i] - rowv[h]),
                sm.xs[(i + 1) * 128 + tw] * (s[i + 1] - rowv[h]));
      }
      wg::fence_async_shared();
    }
    bar_sync(1, 256);
    phase2(acc, p, och, sm.fo, sm.eo, j, 4 * wgi, mask, lane);
  }

  bf16* dq = static_cast<bf16*>(a.dq) + (size_t)bi * a.n * a.d;
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    if (!(mask >> h & 1)) continue;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int col = o0 + T * (4 * wgi + h) + 8 * jj + 2 * tq;
      if (col >= a.d) continue;   // d % 8 == 0, so col + 1 < d as well
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = q0 + 16 * wl + g8 + 8 * hh;
        if (row < a.n)
          *reinterpret_cast<__nv_bfloat162*>(dq + (size_t)row * a.d + col) =
              __floats2bfloat162_rn(acc[h][4 * jj + 2 * hh],
                                    acc[h][4 * jj + 2 * hh + 1]);
      }
    }
  }
}

// K5, bf16.  Block (key tile, role, image); roles < n_dk_roles own dK's
// columns [512 role, +512), the rest dV's columns [256 (role -
// n_dk_roles), +256).
__global__ void __launch_bounds__(NTH, 1)
    attn_dkv_bf16(BwdArgs a, const __grid_constant__ Maps mp, int n_dk_roles) {
  extern __shared__ unsigned char smem_raw[];
  const Smem sm(smem_raw);
  const int bi = blockIdx.z, k0 = blockIdx.x * T;
  const bool dv_role = static_cast<int>(blockIdx.y) >= n_dk_roles;
  const int o0 = dv_role ? (blockIdx.y - n_dk_roles) * SLICE_DV
                         : blockIdx.y * SLICE_DQ;
  const int width = dv_role ? a.c : a.d;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nqt = (a.n + T - 1) / T, nd = (a.d + T - 1) / T;
  const int nc = (a.c + T - 1) / T;
  // S^T over d: consumer 0 takes chunks [0, split), consumer 1 the rest in
  // a dV role; in a dK role consumer 0 takes all of d, consumer 1 dA over c
  const int split = dv_role ? (nd + 1) / 2 : nd;
  const int qb = a.q_bs ? bi : 0, kb = a.k_bs ? bi : 0, vb = a.v_bs ? bi : 0;

  if (tid == 0) sm.init();
  __syncthreads();

  if (warp >= 8) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == 11) {         // L log2 e and D of each query tile, double-buffered
      for (int i = 0; i < nqt; ++i) {
        float* rv = sm.rowv + (i & 1) * 2 * T;
        wg::mbar_wait(sm.er + 8 * (i & 1), ((i >> 1) & 1) ^ 1);
        for (int r = lane; r < T; r += 32) {
          const int qq = T * i + r;
          const bool ok = qq < a.n;
          const size_t at = (size_t)bi * a.n + (ok ? qq : 0);
          rv[r] = ok ? a.lse[at] * LOG2E : BIG;
          rv[T + r] = ok ? a.dd[at] : 0.f;
        }
        __syncwarp();
        if (lane == 0) wg::mbar_arrive(sm.fr + 8 * (i & 1));
      }
      return;
    }
    if (lane != 0) return;
    if (warp == 8) {          // K and Q over d, chunks [0, split)
      for (int i = 0, g = 0; i < nqt; ++i)
        for (int t = 0; t < split; ++t, ++g) {
          const int s = claim<R0>(sm.f0, sm.e0, g, 2 * CB);
          const unsigned dst = wg::smem_u32(sm.ring0 + s * SLOT0);
          wg::tma_load_3d(dst, &mp.k, T * t, k0, kb, sm.f0 + 8 * s);
          wg::tma_load_3d(dst + CB, &mp.q, T * t, T * i, qb, sm.f0 + 8 * s);
        }
    } else if (warp == 9) {   // dK: dM1, dM2, V over c; dV: K, Q over the rest of d
      for (int i = 0, g = 0; i < nqt; ++i) {
        const int stages = dv_role ? nd - split : nc;
        for (int u = 0; u < stages; ++u, ++g) {
          const int s = claim<R1>(sm.f1, sm.e1, g, (dv_role ? 2 : 3) * CB);
          const unsigned dst = wg::smem_u32(sm.ring1 + s * SLOT1);
          const unsigned bar = sm.f1 + 8 * s;
          if (dv_role) {
            wg::tma_load_3d(dst, &mp.k, T * (split + u), k0, kb, bar);
            wg::tma_load_3d(dst + CB, &mp.q, T * (split + u), T * i, qb, bar);
          } else {
            wg::tma_load_3d(dst, &mp.dm1, T * u, T * i, bi, bar);
            wg::tma_load_3d(dst + CB, &mp.dm2, T * u, T * i, bi, bar);
            wg::tma_load_3d(dst + 2 * CB, &mp.v, T * u, k0, vb, bar);
          }
        }
      }
    } else if (warp == 10) {  // this query tile's rows of Q, or dM1 and dM2, at the slice
      for (int i = 0; i < nqt; ++i)
        for (int sl = 0; sl < NO; ++sl) {
          int which, col;
          if (!out_chunk(sl, dv_role, o0, width, &which, &col)) continue;
          wg::mbar_wait(sm.eo + 8 * sl, (i & 1) ^ 1);
          wg::mbar_expect_tx(sm.fo + 8 * sl, CB);
          wg::tma_load_3d(wg::smem_u32(sm.och + sl * CB),
                          which == 0 ? &mp.q : which == 1 ? &mp.dm1 : &mp.dm2,
                          col, T * i, which == 0 ? qb : bi, sm.fo + 8 * sl);
        }
    }
    return;
  }
  // -------------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wgi = warp >> 2, wl = warp & 3, tw = tid & 127;
  const int g8 = lane >> 2, tq = lane & 3;
  const int mask = out_mask(wgi, dv_role, o0, width);
  const unsigned p = wg::smem_u32(sm.p), och = wg::smem_u32(sm.och);
  // dK role: acc[h] = columns o0 + 64 (4 wgi + h).  dV role: acc[h] =
  // A^T dM1 and acc[2 + h] = A^T dM2 at columns o0 + 128 wgi + 64 h (h < 2).
  float acc[4][32];
#pragma unroll
  for (int h = 0; h < 4; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[h][i] = 0.f;

  int g = 0;
  for (int i = 0; i < nqt; ++i) {
    float s[32];
    if (wgi == 0)
      phase1<R0, SLOT0, QK>(s, sm.ring0, sm.f0, sm.e0, g, split, tw);
    else if (dv_role)
      phase1<R1, SLOT1, QK>(s, sm.ring1, sm.f1, sm.e1, g, nd - split, tw);
    else
      phase1<R1, SLOT1, DA_K5>(s, sm.ring1, sm.f1, sm.e1, g, nc, tw);

    // The exchange: dK role, consumer 0 sends A^T and consumer 1 forms
    // dS^T; dV role, consumer 1 sends its part of S^T and consumer 0 forms
    // A^T.  s[4 jj + 2 h + t]: key 16 wl + g8 + 8 h, query T i + 8 jj +
    // 2 tq + t, whose L log2 e is lt[8 jj + 2 tq + t] and D lt[T + ...].
    const float* lt = sm.rowv + (i & 1) * 2 * T + 2 * tq;
    wg::mbar_wait(sm.fr + 8 * (i & 1), (i >> 1) & 1);
    if (wgi == (dv_role ? 1 : 0)) {
#pragma unroll
      for (int e = 0; e < 32; ++e)
        sm.xs[e * 128 + tw] = dv_role
            ? s[e] : exp2f(s[e] * LOG2E - lt[8 * (e >> 2) + (e & 1)]);
    }
    bar_sync(1, 256);
    if (wgi == (dv_role ? 0 : 1)) {
#pragma unroll
      for (int e = 0; e < 32; e += 2) {
        const float* lc = lt + 8 * (e >> 2);
        float x0, x1;
        if (dv_role) {
          x0 = exp2f((s[e] + sm.xs[e * 128 + tw]) * LOG2E - lc[0]);
          x1 = exp2f((s[e + 1] + sm.xs[(e + 1) * 128 + tw]) * LOG2E - lc[1]);
        } else {
          x0 = sm.xs[e * 128 + tw] * (s[e] - lc[T]);
          x1 = sm.xs[(e + 1) * 128 + tw] * (s[e + 1] - lc[T + 1]);
        }
        store_p(sm.p, wl, g8, tq, e >> 2, (e >> 1) & 1, x0, x1);
      }
      wg::fence_async_shared();
    }
    bar_sync(1, 256);
    if (lane == 0) wg::mbar_arrive(sm.er + 8 * (i & 1));
    phase2(acc, p, och, sm.fo, sm.eo, i, 4 * wgi, mask, lane);
  }

  if (!dv_role) {
    bf16* dk = static_cast<bf16*>(a.dk) + (size_t)bi * a.m * a.d;
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      if (!(mask >> h & 1)) continue;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int col = o0 + T * (4 * wgi + h) + 8 * jj + 2 * tq;
        if (col >= a.d) continue;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int key = k0 + 16 * wl + g8 + 8 * hh;
          if (key < a.m)
            *reinterpret_cast<__nv_bfloat162*>(dk + (size_t)key * a.d + col) =
                __floats2bfloat162_rn(acc[h][4 * jj + 2 * hh],
                                      acc[h][4 * jj + 2 * hh + 1]);
        }
      }
    }
  } else {
    const bf16* v = static_cast<const bf16*>(a.v) + bi * a.v_bs;
    bf16* dv = static_cast<bf16*>(a.dv) + (size_t)bi * a.m * a.c;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!(mask >> h & 1)) continue;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int col = o0 + 128 * wgi + T * h + 8 * jj + 2 * tq;
        if (col >= a.c) continue;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int key = k0 + 16 * wl + g8 + 8 * hh;
          if (key >= a.m) continue;
          const float2 vv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(v + (size_t)key * a.c + col));
          const int e = 4 * jj + 2 * hh;
          *reinterpret_cast<__nv_bfloat162*>(dv + (size_t)key * a.c + col) =
              __floats2bfloat162_rn(acc[h][e] + 2.f * vv.x * acc[h + 2][e],
                                    acc[h][e + 1] + 2.f * vv.y * acc[h + 2][e + 1]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------- float32

// K4 and K5, float32: 3xTF32 on wgmma.  The pre-pass (split_tf32) writes
// every operand the rings read as two tf32 parts, big = tf32(x) and small
// = tf32(x - big), into wrapper-allocated scratch: Q, K, V, W = V o V, dM1
// and dM2 as they lie (K-major over d or c), and the output products' B
// K-major over the tile's rows, which tf32's wgmma needs: K^T (K4; keys
// contiguous), Q^T, dM1^T, dM2^T (K5; queries contiguous).  Rows are
// padded to a multiple of 4 floats (16 bytes, TMA's row stride) with
// zeros.  dS (K4), dS^T and A^T (K5) are split by the threads that form
// them.

constexpr int FR0 = 2;                  // consumer 0's ring (S or S^T over d)
constexpr int FR1 = 2;                  // consumer 1's ring (dA or dA^T over c, or S^T)
constexpr int FNO = 4;                  // output-product rings: 2 slots a consumer
constexpr int FOFF_R1 = FR0 * FSTAGE;
constexpr int FOFF_O = FOFF_R1 + FR1 * FSTAGE;
constexpr int FOFF_P = FOFF_O + FNO * 2 * FB;   // dS^T or A^T: [half][big | small]
constexpr int FOFF_ROW = FOFF_P + 4 * FB;       // L and D, [2][2][T] float32
constexpr int FOFF_BAR = FOFF_ROW + 2 * 2 * T * 4;
constexpr int FNBAR = 2 * (FR0 + FR1 + FNO + 2);
constexpr int SMEM_F32 = 1024 + FOFF_BAR + FNBAR * 8;
static_assert(SMEM_F32 <= 232448, "f32 K4/K5 exceed a block's shared memory");

// The operands of the f32 K4 and K5 as the pre-pass writes them: tensor
// maps over (2 P, rows, cols) float32, big parts in planes [0, P), small in
// [P, 2P); P = 1 for an input broadcast over the batch (stride 0), else b.
struct SplitMaps {
  CUtensorMap q, k, v, w, dm1, dm2;   // as they lie
  CUtensorMap qt, dm1t, dm2t;         // K5: transposed (queries contiguous)
  CUtensorMap kt;                     // K4: K^T (keys contiguous)
  int pq, pk, pv;                     // planes of Q, K and V (dM: b)
};

// Second phase: acc[h] += P O_h^T over the tile for the chunks whose bit
// is set in mask: P (64 x 64, tf32 parts: dS^T or A^T of 64 keys x 64
// queries in K5, dS of 64 queries x 64 keys in K4) and O_h's two 32-row
// halves of the tile from this consumer's output ring (slots 2 g and 2 g +
// 1; the consumer's use j, counted across tiles, in slot 2 g + j % 2),
// both K-major over the tile's rows.  Each chunk's 24 products go
// into a fresh partial sum, the small-part ones first, added to acc[h] in
// float32 once they are done (as in phase1_tf32).  A ring of its own per
// consumer: with one shared ring a consumer could wait on a slot whose
// previous use, the other consumer's, had not landed yet, and the
// barrier's parity would pass it a phase early.
__device__ __forceinline__ void phase2_tf32(float (&acc)[4][32], unsigned p,
                                            unsigned och, unsigned full,
                                            unsigned empty, int& j, int g,
                                            int mask, int lane) {
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    if (mask >> h & 1) {
      float part[32];
      wg::fence_acc(part);
      wg::wgmma_fence();
#pragma unroll
      for (int kh = 0; kh < 2; ++kh) {   // the small-part products first
        const int slot = 2 * g + kh;
        wg::mbar_wait(full + 8 * slot, (j >> 1) & 1);
        const unsigned b = och + slot * 2 * FB, a = p + kh * 2 * FB;
#pragma unroll
        for (int ks = 0; ks < FW / 8; ++ks) {
          wg::wgmma_tf32(part, kmajor(a + FB, ks), kmajor(b, ks), kh + ks > 0);
          wg::wgmma_tf32(part, kmajor(a, ks), kmajor(b + FB, ks));
        }
      }
#pragma unroll
      for (int kh = 0; kh < 2; ++kh) {
        const unsigned b = och + (2 * g + kh) * 2 * FB, a = p + kh * 2 * FB;
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
        wg::mbar_arrive(empty + 8 * (2 * g));
        wg::mbar_arrive(empty + 8 * (2 * g + 1));
      }
      j += 2;
    }
  }
}

// Shared-memory layout and barrier addresses of the f32 K4 and K5 (K4
// writes its row stage once and uses no row barriers).
struct SmemF32 {
  unsigned char *ring0, *ring1, *och, *p;
  float* rowv;
  unsigned f0, e0, f1, e1, fo, eo, fr, er;
  __device__ explicit SmemF32(unsigned char* raw) {
    unsigned char* sm = raw + ((1024 - (wg::smem_u32(raw) & 1023)) & 1023);
    ring0 = sm;
    ring1 = sm + FOFF_R1;
    och = sm + FOFF_O;
    p = sm + FOFF_P;
    rowv = reinterpret_cast<float*>(sm + FOFF_ROW);
    f0 = wg::smem_u32(sm + FOFF_BAR);
    e0 = f0 + 8 * FR0;
    f1 = e0 + 8 * FR0;
    e1 = f1 + 8 * FR1;
    fo = e1 + 8 * FR1;
    eo = fo + 8 * FNO;
    fr = eo + 8 * FNO;
    er = fr + 8 * 2;
  }
  // Full barriers: one arrive (the producer's expect_tx, or the row
  // loader's lane 0).  Empty: one arrive per consumer warp that reads the
  // slot (4; the row vectors 8).
  __device__ void init() const {
    const unsigned bars[8][3] = {{f0, FR0, 1}, {e0, FR0, 4}, {f1, FR1, 1},
                                 {e1, FR1, 4}, {fo, FNO, 1}, {eo, FNO, 4},
                                 {fr, 2, 1},   {er, 2, 8}};
    for (const auto& b : bars)
      for (unsigned i = 0; i < b[1]; ++i) wg::mbar_init(b[0] + 8 * i, b[2]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
};

// K5, float32.  Block (key tile, role, image) as attn_dkv_bf16: roles <
// n_dk_roles own dK's columns [512 role, +512), the rest dV's columns
// [256 (role - n_dk_roles), +256).
__global__ void __launch_bounds__(NTH, 1)
    attn_dkv_tf32(BwdArgs a, const __grid_constant__ SplitMaps mp,
                  int n_dk_roles) {
  extern __shared__ unsigned char smem_raw[];
  const SmemF32 sm(smem_raw);
  const int bi = blockIdx.z, k0 = blockIdx.x * T;
  const bool dv_role = static_cast<int>(blockIdx.y) >= n_dk_roles;
  const int o0 = dv_role ? (blockIdx.y - n_dk_roles) * SLICE_DV
                         : blockIdx.y * SLICE_DQ;
  const int width = dv_role ? a.c : a.d;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nqt = (a.n + T - 1) / T, nd = (a.d + FW - 1) / FW;
  const int nc = (a.c + FW - 1) / FW;
  // S^T over d: consumer 0 takes chunks [0, split), consumer 1 the rest in
  // a dV role; in a dK role consumer 0 takes all of d, consumer 1 dA over
  // c in stages of (V, dM1) and (W, dM2)
  const int split = dv_role ? (nd + 1) / 2 : nd;

  if (tid == 0) sm.init();
  __syncthreads();

  if (warp >= 8) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == 11) {         // L and D of each query tile, double-buffered
      for (int i = 0; i < nqt; ++i) {
        float* rv = sm.rowv + (i & 1) * 2 * T;
        wg::mbar_wait(sm.er + 8 * (i & 1), ((i >> 1) & 1) ^ 1);
        for (int r = lane; r < T; r += 32) {
          const int qq = T * i + r;
          const bool ok = qq < a.n;
          const size_t at = (size_t)bi * a.n + (ok ? qq : 0);
          rv[r] = ok ? a.lse[at] : BIG;
          rv[T + r] = ok ? a.dd[at] : 0.f;
        }
        __syncwarp();
        if (lane == 0) wg::mbar_arrive(sm.fr + 8 * (i & 1));
      }
      return;
    }
    if (lane != 0) return;
    if (warp == 8) {          // K and Q over d, chunks [0, split)
      for (int i = 0, g = 0; i < nqt; ++i)
        for (int t = 0; t < split; ++t, ++g) {
          const int s = claim<FR0>(sm.f0, sm.e0, g, FSTAGE);
          load_stage(wg::smem_u32(sm.ring0 + s * FSTAGE), sm.f0 + 8 * s,
                     &mp.k, mp.pk, k0, &mp.q, mp.pq, T * i, FW * t, bi);
        }
    } else if (warp == 9) {   // dK: (V, dM1), (W, dM2) over c; dV: K, Q over the rest of d
      for (int i = 0, g = 0; i < nqt; ++i) {
        const int stages = dv_role ? nd - split : 2 * nc;
        for (int u = 0; u < stages; ++u, ++g) {
          const int s = claim<FR1>(sm.f1, sm.e1, g, FSTAGE);
          const unsigned dst = wg::smem_u32(sm.ring1 + s * FSTAGE);
          const unsigned bar = sm.f1 + 8 * s;
          if (dv_role)
            load_stage(dst, bar, &mp.k, mp.pk, k0, &mp.q, mp.pq, T * i,
                       FW * (split + u), bi);
          else
            load_stage(dst, bar, u & 1 ? &mp.w : &mp.v, mp.pv, k0,
                       u & 1 ? &mp.dm2 : &mp.dm1, gridDim.z, T * i,
                       FW * (u >> 1), bi);
        }
      }
    } else if (warp == 10) {  // Q^T (dK) or dM1^T, dM2^T (dV) at the slice, per query half
      int used[2] = {0, 0};   // uses of each consumer's output ring
      for (int i = 0; i < nqt; ++i)
        for (int h = 0; h < 4; ++h)
          for (int kh = 0; kh < 2; ++kh)
            for (int g = 0; g < 2; ++g) {
              int which, col;
              if (!out_chunk(4 * g + h, dv_role, o0, width, &which, &col))
                continue;
              const int j = used[g]++, s = 2 * g + (j & 1);
              wg::mbar_wait(sm.eo + 8 * s, ((j >> 1) & 1) ^ 1);
              wg::mbar_expect_tx(sm.fo + 8 * s, 2 * FB);
              const unsigned dst = wg::smem_u32(sm.och + s * 2 * FB);
              const CUtensorMap* map =
                  which == 0 ? &mp.qt : which == 1 ? &mp.dm1t : &mp.dm2t;
              const int p = which == 0 ? mp.pq : gridDim.z;
              const int qc = T * i + FW * kh;
              wg::tma_load_3d(dst, map, qc, col, plane(0, p, bi), sm.fo + 8 * s);
              wg::tma_load_3d(dst + FB, map, qc, col, plane(1, p, bi),
                              sm.fo + 8 * s);
            }
    }
    return;
  }
  // -------------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wgi = warp >> 2, wl = warp & 3;
  const int g8 = lane >> 2, tq = lane & 3;
  const unsigned och = wg::smem_u32(sm.och), p = wg::smem_u32(sm.p);
  const int mask = out_mask(wgi, dv_role, o0, width);
  // dK role: acc[h] = columns o0 + 256 wgi + 64 h.  dV role: acc[h] =
  // A^T dM1 and acc[2 + h] = A^T dM2 at columns o0 + 128 wgi + 64 h (h < 2).
  float acc[4][32];
#pragma unroll
  for (int h = 0; h < 4; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[h][i] = 0.f;

  int g = 0, j = 0;   // stages of this consumer's ring, uses of its output ring
  for (int i = 0; i < nqt; ++i) {
    float s[32];
    if (wgi == 0)
      phase1_tf32<FR0>(s, sm.ring0, sm.f0, sm.e0, g, split, lane);
    else
      phase1_tf32<FR1>(s, sm.ring1, sm.f1, sm.e1, g,
                       dv_role ? nd - split : 2 * nc, lane);

    // The exchange, through P in place (each thread reads and writes only
    // its own positions): dK role, consumer 0 writes A^T = exp(S^T - L) and
    // consumer 1 replaces it with dS^T = A^T o (dA^T - D); dV role,
    // consumer 1 writes its part of S^T and consumer 0 replaces it with
    // A^T.  The first writes raw float32 into the big boxes, the second
    // writes both tf32 parts.  s[4 jj + 2 h + t]: key 16 wl + g8 + 8 h,
    // query T i + 8 jj + 2 tq + t, whose L is lt[8 jj + 2 tq + t] and D
    // lt[T + ...].  S - L is formed before the exponential, so two large
    // scores do not cancel after rounding.  The first barrier keeps P
    // until both consumers' output products of the tile before are done.
    const float* lt = sm.rowv + (i & 1) * 2 * T + 2 * tq;
    wg::mbar_wait(sm.fr + 8 * (i & 1), (i >> 1) & 1);
    bar_sync(1, 256);
    if (wgi == (dv_role ? 1 : 0)) {
#pragma unroll
      for (int e = 0; e < 32; e += 2) {
        const float* lc = lt + 8 * (e >> 2);
        *reinterpret_cast<float2*>(
            sm.p + p_offset(wl, g8, tq, e >> 2, (e >> 1) & 1)) =
            dv_role ? make_float2(s[e], s[e + 1])
                    : make_float2(expf(s[e] - lc[0]), expf(s[e + 1] - lc[1]));
      }
    }
    bar_sync(1, 256);
    if (wgi == (dv_role ? 0 : 1)) {
#pragma unroll
      for (int e = 0; e < 32; e += 2) {
        const float* lc = lt + 8 * (e >> 2);
        const int off = p_offset(wl, g8, tq, e >> 2, (e >> 1) & 1);
        const float2 x = *reinterpret_cast<const float2*>(sm.p + off);
        float x0, x1;
        if (dv_role) {
          x0 = expf((s[e] + x.x) - lc[0]);
          x1 = expf((s[e + 1] + x.y) - lc[1]);
        } else {
          x0 = x.x * (s[e] - lc[T]);
          x1 = x.y * (s[e + 1] - lc[T + 1]);
        }
        store_p_tf32(sm.p, off, x0, x1);
      }
      wg::fence_async_shared();
    }
    bar_sync(1, 256);
    if (lane == 0) wg::mbar_arrive(sm.er + 8 * (i & 1));
    phase2_tf32(acc, p, och, sm.fo, sm.eo, j, wgi, mask, lane);
  }

  if (!dv_role) {
    float* dk = static_cast<float*>(a.dk) + (size_t)bi * a.m * a.d;
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      if (!(mask >> h & 1)) continue;
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int col = o0 + 256 * wgi + T * h + 8 * (e >> 2) + 2 * tq + (e & 1);
        const int key = k0 + 16 * wl + g8 + 8 * ((e >> 1) & 1);
        if (col < a.d && key < a.m) dk[(size_t)key * a.d + col] = acc[h][e];
      }
    }
  } else {
    const float* v = static_cast<const float*>(a.v) + bi * a.v_bs;
    float* dv = static_cast<float*>(a.dv) + (size_t)bi * a.m * a.c;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!(mask >> h & 1)) continue;
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int col = o0 + 128 * wgi + T * h + 8 * (e >> 2) + 2 * tq + (e & 1);
        const int key = k0 + 16 * wl + g8 + 8 * ((e >> 1) & 1);
        if (col < a.c && key < a.m) {
          const size_t at = (size_t)key * a.c + col;
          dv[at] = acc[h][e] + 2.f * v[at] * acc[h + 2][e];
        }
      }
    }
  }
}

// K4, float32.  Block (query tile, dQ slice of 512 columns, image) as
// attn_dq_bf16, walking the key tiles of 64: K5's dK role with queries and
// keys swapped.  Consumer 0 computes S = Q K^T over d in (Q, K) stages,
// consumer 1 dA = dM1 V^T + dM2 W^T over c in stages of (dM1, V) and (dM2,
// W), each stage a fresh partial (phase1_tf32); the exchange goes through
// P in place; then each consumer adds dS K into its 256 dQ columns, one
// fresh partial per (key tile, 64-column chunk), from its output ring of
// K^T halves (64 columns x 32 keys).  L and D of the block's rows are the
// same for every key tile: the consumers write them once into the row
// stage, no loader warp.  The producer's warps run one ring each: (Q, K)
// stages, (dM, V or W) stages, K^T slots.
__global__ void __launch_bounds__(NTH, 1)
    attn_dq_tf32(BwdArgs a, const __grid_constant__ SplitMaps mp) {
  extern __shared__ unsigned char smem_raw[];
  const SmemF32 sm(smem_raw);
  const int bi = blockIdx.z, q0 = blockIdx.x * T, o0 = blockIdx.y * SLICE_DQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nkt = (a.m + T - 1) / T, nd = (a.d + FW - 1) / FW;
  const int nc = (a.c + FW - 1) / FW;

  if (tid == 0) sm.init();
  __syncthreads();

  if (warp >= 8) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (lane != 0) return;
    if (warp == 8) {          // Q and K over d, for every key tile
      for (int j = 0, g = 0; j < nkt; ++j)
        for (int t = 0; t < nd; ++t, ++g) {
          const int s = claim<FR0>(sm.f0, sm.e0, g, FSTAGE);
          load_stage(wg::smem_u32(sm.ring0 + s * FSTAGE), sm.f0 + 8 * s,
                     &mp.q, mp.pq, q0, &mp.k, mp.pk, T * j, FW * t, bi);
        }
    } else if (warp == 9) {   // (dM1, V), (dM2, W) over c, for every key tile
      for (int j = 0, g = 0; j < nkt; ++j)
        for (int u = 0; u < 2 * nc; ++u, ++g) {
          const int s = claim<FR1>(sm.f1, sm.e1, g, FSTAGE);
          load_stage(wg::smem_u32(sm.ring1 + s * FSTAGE), sm.f1 + 8 * s,
                     u & 1 ? &mp.dm2 : &mp.dm1, gridDim.z, q0,
                     u & 1 ? &mp.w : &mp.v, mp.pv, T * j, FW * (u >> 1), bi);
        }
    } else if (warp == 10) {  // K^T at the slice, per key half
      int used[2] = {0, 0};   // uses of each consumer's output ring
      for (int j = 0; j < nkt; ++j)
        for (int h = 0; h < 4; ++h)
          for (int kh = 0; kh < 2; ++kh)
            for (int g = 0; g < 2; ++g) {
              int which, col;
              if (!out_chunk(4 * g + h, false, o0, a.d, &which, &col)) continue;
              const int u = used[g]++, s = 2 * g + (u & 1);
              wg::mbar_wait(sm.eo + 8 * s, ((u >> 1) & 1) ^ 1);
              wg::mbar_expect_tx(sm.fo + 8 * s, 2 * FB);
              const unsigned dst = wg::smem_u32(sm.och + s * 2 * FB);
              const int key = T * j + FW * kh;
              wg::tma_load_3d(dst, &mp.kt, key, col, plane(0, mp.pk, bi),
                              sm.fo + 8 * s);
              wg::tma_load_3d(dst + FB, &mp.kt, key, col, plane(1, mp.pk, bi),
                              sm.fo + 8 * s);
            }
    }
    return;
  }
  // -------------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wgi = warp >> 2, wl = warp & 3;
  const int g8 = lane >> 2, tq = lane & 3;
  const unsigned och = wg::smem_u32(sm.och), p = wg::smem_u32(sm.p);
  const int mask = out_mask(wgi, false, o0, a.d);
  // L (consumer 0; BIG past n) or D (consumer 1) of this thread's two
  // rows, rv[0] and rv[8], in the row stage (held in registers they
  // spill); written once, read after the first exchange barrier.
  float* rv = sm.rowv + T * wgi + 16 * wl + g8;
  if (tq == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + 16 * wl + g8 + 8 * h;
      const bool ok = row < a.n;
      const size_t at = (size_t)bi * a.n + (ok ? row : 0);
      rv[8 * h] = wgi == 0 ? (ok ? a.lse[at] : BIG) : (ok ? a.dd[at] : 0.f);
    }
  }
  // acc[h] = dQ's columns o0 + 256 wgi + 64 h
  float acc[4][32];
#pragma unroll
  for (int h = 0; h < 4; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[h][i] = 0.f;

  int g = 0, uo = 0;   // stages of this consumer's ring, uses of its output ring
  for (int j = 0; j < nkt; ++j) {
    float s[32];
    if (wgi == 0)
      phase1_tf32<FR0>(s, sm.ring0, sm.f0, sm.e0, g, nd, lane);
    else
      phase1_tf32<FR1>(s, sm.ring1, sm.f1, sm.e1, g, 2 * nc, lane);

    // The exchange, through P in place (each thread reads and writes only
    // its own positions): consumer 0 writes A = exp(S - L) as raw float32
    // into the big boxes (0 for keys >= m), consumer 1 replaces it with dS
    // = A o (dA - D) as tf32 parts.  s[4 jj + 2 h + t]: row 16 wl + g8 + 8
    // h, key T j + 8 jj + 2 tq + t.  S - L is formed before the
    // exponential, so two large scores do not cancel after rounding.  The
    // first barrier keeps P until both consumers' output products of the
    // tile before are done.
    bar_sync(1, 256);
    if (wgi == 0) {
#pragma unroll
      for (int e = 0; e < 32; e += 2) {
        const int key = T * j + 8 * (e >> 2) + 2 * tq;
        const float l = rv[8 * ((e >> 1) & 1)];
        *reinterpret_cast<float2*>(
            sm.p + p_offset(wl, g8, tq, e >> 2, (e >> 1) & 1)) =
            make_float2(key < a.m ? expf(s[e] - l) : 0.f,
                        key + 1 < a.m ? expf(s[e + 1] - l) : 0.f);
      }
    }
    bar_sync(1, 256);
    if (wgi == 1) {
#pragma unroll
      for (int e = 0; e < 32; e += 2) {
        const float dd = rv[8 * ((e >> 1) & 1)];
        const int off = p_offset(wl, g8, tq, e >> 2, (e >> 1) & 1);
        const float2 x = *reinterpret_cast<const float2*>(sm.p + off);
        store_p_tf32(sm.p, off, x.x * (s[e] - dd), x.y * (s[e + 1] - dd));
      }
      wg::fence_async_shared();
    }
    bar_sync(1, 256);
    phase2_tf32(acc, p, och, sm.fo, sm.eo, uo, wgi, mask, lane);
  }

  float* dq = static_cast<float*>(a.dq) + (size_t)bi * a.n * a.d;
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    if (!(mask >> h & 1)) continue;
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int col = o0 + 256 * wgi + T * h + 8 * (e >> 2) + 2 * tq + (e & 1);
      const int row = q0 + 16 * wl + g8 + 8 * ((e >> 1) & 1);
      if (col < a.d && row < a.n) dq[(size_t)row * a.d + col] = acc[h][e];
    }
  }
}

// The split operands both f32 kernels read as they lie (q, k, v, w, dm1,
// dm2), the first six jobs of their layouts.
static void direct_jobs(const BwdArgs& a, int b, SplitJob* spec) {
  const int pq = a.q_bs ? b : 1, pk = a.k_bs ? b : 1, pv = a.v_bs ? b : 1;
  const int dp = (a.d + 3) / 4 * 4, cp = (a.c + 3) / 4 * 4;
  const long long nc = static_cast<long long>(a.n) * a.c;
  const float *q = static_cast<const float*>(a.q),
              *k = static_cast<const float*>(a.k),
              *v = static_cast<const float*>(a.v),
              *d1 = static_cast<const float*>(a.dm1),
              *d2 = static_cast<const float*>(a.dm2);
  spec[0] = {q, a.q_bs, a.n, a.d, nullptr, a.n, dp, pq, 0};
  spec[1] = {k, a.k_bs, a.m, a.d, nullptr, a.m, dp, pk, 0};
  spec[2] = {v, a.v_bs, a.m, a.c, nullptr, a.m, cp, pv, 0};
  spec[3] = {v, a.v_bs, a.m, a.c, nullptr, a.m, cp, pv, 1};
  spec[4] = {d1, nc, a.n, a.c, nullptr, a.n, cp, b, 0};
  spec[5] = {d2, nc, a.n, a.c, nullptr, a.n, cp, b, 0};
}

// The f32 K4's split operands (q, k, v, w, dm1, dm2, kt) one after another
// from base.
static SplitLayout<7> k4_layout(const BwdArgs& a, int b, float* base) {
  SplitJob spec[7];
  direct_jobs(a, b, spec);
  spec[6] = {static_cast<const float*>(a.k), a.k_bs, a.m, a.d, nullptr, a.d,
             (a.m + 3) / 4 * 4, spec[1].planes, 2};
  return SplitLayout<7>(spec, base);
}

// The f32 K5's split operands (q, k, v, w, dm1, dm2, qt, dm1t, dm2t) one
// after another from base.
static SplitLayout<9> k5_layout(const BwdArgs& a, int b, float* base) {
  SplitJob spec[9];
  direct_jobs(a, b, spec);
  const int np = (a.n + 3) / 4 * 4;
  const long long nc = static_cast<long long>(a.n) * a.c;
  spec[6] = {static_cast<const float*>(a.q), a.q_bs, a.n, a.d, nullptr, a.d,
             np, spec[0].planes, 2};
  spec[7] = {static_cast<const float*>(a.dm1), nc, a.n, a.c, nullptr, a.c,
             np, b, 2};
  spec[8] = {static_cast<const float*>(a.dm2), nc, a.n, a.c, nullptr, a.c,
             np, b, 2};
  return SplitLayout<9>(spec, base);
}

static cudaError_t make_maps(Maps* mp, const BwdArgs& a, int b) {
  cudaError_t e = chunk_map(&mp->q, a.q, a.d, a.n, b, a.q_bs);
  if (e == cudaSuccess) e = chunk_map(&mp->k, a.k, a.d, a.m, b, a.k_bs);
  if (e == cudaSuccess) e = chunk_map(&mp->v, a.v, a.c, a.m, b, a.v_bs);
  const long long nc = static_cast<long long>(a.n) * a.c;
  if (e == cudaSuccess) e = chunk_map(&mp->dm1, a.dm1, a.c, a.n, b, nc);
  if (e == cudaSuccess) e = chunk_map(&mp->dm2, a.dm2, a.c, a.n, b, nc);
  return e;
}

// The f32 K4's pre-pass and main kernel.  scratch holds
// vst_k4_scratch_floats(...) floats.
static cudaError_t k4_tf32(const BwdArgs& a, int b, float* scratch,
                           cudaStream_t s) {
  const SplitLayout<7> lay = k4_layout(a, b, scratch);
  SplitMaps mp;
  cudaError_t e = lay.run({&mp.q, &mp.k, &mp.v, &mp.w, &mp.dm1, &mp.dm2,
                           &mp.kt}, s);
  mp.pq = lay.job[0].planes;
  mp.pk = lay.job[1].planes;
  mp.pv = lay.job[2].planes;
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(attn_dq_tf32,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_F32);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.n + T - 1) / T, (a.d + SLICE_DQ - 1) / SLICE_DQ, b);
  attn_dq_tf32<<<grid, NTH, SMEM_F32, s>>>(a, mp);
  return cudaGetLastError();
}

// The f32 K5's pre-pass and main kernel.  scratch holds
// vst_k5_scratch_floats(...) floats.
static cudaError_t k5_tf32(const BwdArgs& a, int b, float* scratch,
                           cudaStream_t s) {
  const SplitLayout<9> lay = k5_layout(a, b, scratch);
  SplitMaps mp;
  cudaError_t e = lay.run({&mp.q, &mp.k, &mp.v, &mp.w, &mp.dm1, &mp.dm2,
                           &mp.qt, &mp.dm1t, &mp.dm2t}, s);
  mp.pq = lay.job[0].planes;
  mp.pk = lay.job[1].planes;
  mp.pv = lay.job[2].planes;
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(attn_dkv_tf32,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_F32);
  if (e != cudaSuccess) return e;
  const int roles = (a.d + SLICE_DQ - 1) / SLICE_DQ;
  const dim3 grid((a.m + T - 1) / T, roles + (a.c + SLICE_DV - 1) / SLICE_DV,
                  b);
  attn_dkv_tf32<<<grid, NTH, SMEM_F32, s>>>(a, mp, roles);
  return cudaGetLastError();
}

}  // namespace k45


// Each returns 0 on success, else the CUDA error of the tensor maps, the
// attribute call or the launch.  bf16 needs d and c multiples of 8 and
// 16-byte aligned rows and batch strides; the wrapper checks.  float32
// needs scratch of vst_k4_scratch_floats(...) or vst_k5_scratch_floats(...)
// floats (its split operands); bf16 takes none.
extern "C" int vst_k4_attention_dq(
    const void* q, const void* k, const void* v, const void* dm1,
    const void* dm2, const float* lse, const float* dd, void* dq,
    void* scratch, int b, int n, int m, int d, int c, long long q_bs,
    long long k_bs, long long v_bs, int bf16, void* stream) {
  using namespace k45;
  BwdArgs a{q, k, v, dm1, dm2, lse, dd, dq, nullptr, nullptr,
            n, m, d, c, q_bs, k_bs, v_bs};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!bf16) return static_cast<int>(k4_tf32(a, b, static_cast<float*>(scratch), s));
  Maps mp;
  cudaError_t e = make_maps(&mp, a, b);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(attn_dq_bf16,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BF16);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((n + T - 1) / T, (d + SLICE_DQ - 1) / SLICE_DQ, b);
  attn_dq_bf16<<<grid, NTH, SMEM_BF16, s>>>(a, mp);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int vst_k5_attention_dkv(
    const void* q, const void* k, const void* v, const void* dm1,
    const void* dm2, const float* lse, const float* dd, void* dk, void* dv,
    void* scratch, int b, int n, int m, int d, int c, long long q_bs,
    long long k_bs, long long v_bs, int bf16, void* stream) {
  using namespace k45;
  BwdArgs a{q, k, v, dm1, dm2, lse, dd, nullptr, dk, dv,
            n, m, d, c, q_bs, k_bs, v_bs};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!bf16) return static_cast<int>(k5_tf32(a, b, static_cast<float*>(scratch), s));
  Maps mp;
  cudaError_t e = make_maps(&mp, a, b);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(attn_dkv_bf16,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BF16);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int roles = (d + SLICE_DQ - 1) / SLICE_DQ;
  const dim3 grid((m + T - 1) / T, roles + (c + SLICE_DV - 1) / SLICE_DV, b);
  attn_dkv_bf16<<<grid, NTH, SMEM_BF16, s>>>(a, mp, roles);
  return static_cast<int>(cudaGetLastError());
}

// Floats of scratch the f32 K4 and K5 need (their split operands; the
// wrapper allocates them).
extern "C" long long vst_k4_scratch_floats(int b, int n, int m, int d, int c,
                                          long long q_bs, long long k_bs,
                                          long long v_bs) {
  using namespace k45;
  const BwdArgs a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                  nullptr, nullptr, nullptr, nullptr,
                  n, m, d, c, q_bs, k_bs, v_bs};
  return k4_layout(a, b, nullptr).total;
}

extern "C" long long vst_k5_scratch_floats(int b, int n, int m, int d, int c,
                                          long long q_bs, long long k_bs,
                                          long long v_bs) {
  using namespace k45;
  const BwdArgs a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                  nullptr, nullptr, nullptr, nullptr,
                  n, m, d, c, q_bs, k_bs, v_bs};
  return k5_layout(a, b, nullptr).total;
}

// The launch configuration of the wgmma bodies: out = {bf16 K4/K5 dynamic
// shared memory bytes per block, resident blocks per SM of bf16 K4, of
// bf16 K5, dQ/dK columns per block, dV columns per block, then the f32
// K5's shared memory, blocks per SM, dK and dV columns per block, then the
// f32 K4's shared memory, blocks per SM and dQ columns per block}.
// Returns a CUDA error code.
extern "C" int vst_k45_launch_config(int* out) {
  using namespace k45;
  cudaError_t e = cudaFuncSetAttribute(
      attn_dq_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BF16);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(attn_dkv_bf16,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BF16);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(attn_dkv_tf32,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_F32);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(attn_dq_tf32,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_F32);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], attn_dq_bf16,
                                                      NTH, SMEM_BF16);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], attn_dkv_bf16,
                                                      NTH, SMEM_BF16);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[6], attn_dkv_tf32,
                                                      NTH, SMEM_F32);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[10], attn_dq_tf32,
                                                      NTH, SMEM_F32);
  out[0] = SMEM_BF16;
  out[3] = SLICE_DQ;
  out[4] = SLICE_DV;
  out[5] = SMEM_F32;
  out[7] = SLICE_DQ;
  out[8] = SLICE_DV;
  out[9] = SMEM_F32;
  out[11] = SLICE_DQ;
  return static_cast<int>(e);
}
