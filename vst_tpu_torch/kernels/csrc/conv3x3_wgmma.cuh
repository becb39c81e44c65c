// conv3x3_wgmma: the bfloat16 body of K1 (res_block.cu) and K2
// (head_conv.cu), a 3x3 stride-1 conv over NHWC activations and HWIO
// weights as an implicit GEMM on Hopper's warpgroup tensor-core
// instruction (wgmma.mma_async, bf16 in, float32 accumulate), with the
// flags and rounding points of conv3x3_tile.cuh (REFLECT, PROLOGUE, STATS).
//
// Grid: one persistent block per SM (at most one per tile); block b takes
// tiles b, b + gridDim.x, ... so the next tile's loads overlap this tile's
// epilogue.  A tile is 8*MT rows x 16 columns of one image by N output
// channels, N one of 32, 48, 64, 128, 192, 256 and Co split into as few
// N-wide tiles as fit (192 -> one, 768 -> three of 256, 48 -> one of 48;
// at most 192 with STATS).  MT = 2 for tiles of N <= 64 (K2's heads, the
// narrow K1), else 1.  The output-channel tile varies fastest, so the
// blocks that read one input tile run together.
//
// Block: three warpgroups, warp-specialized, synchronized by mbarriers
// only (consumers among themselves by one named barrier in the epilogue).
// - Consumers, warpgroups 0 and 1: warpgroup g owns columns 8g..8g+7 of
//   the tile, so each of its MT 64-row GEMM blocks is 8 tile rows x 8
//   columns, and its accumulator is MT * N/2 float32 registers a thread
//   (setmaxnreg 224).  Per stage: wait, one m64nNk16 wgmma per k16 step
//   and block, commit; the stage before stays in flight (wait_group 1)
//   and is released once done.
// - Producer, warpgroup 2 (setmaxnreg 56): one thread keeps the weight
//   ring full through TMA (the narrow K1: loads its nine taps once); three
//   warps (the narrow K1: all four) stage the input halos, NA - 1 chunks
//   ahead, through cp.async.
//
// K loop: C in chunks of up to 64 channels (48 -> one chunk of three k16
// steps), and in each chunk the nine taps.
// - A, the input: once per chunk the (8*MT + 2) x 18 halo of the tile is
//   staged in shared memory (NA buffers), reflect padding resolved by
//   index (pixels that feed only outputs outside the image are
//   zero-filled), and with PROLOGUE normalized+relu'd once, in place, by
//   the thread that loaded it.  The layout is [8-channel group][halo
//   pixel][8 channels]: every pixel's 8-channel group is one 16-byte row
//   of a wgmma "core matrix" (no swizzle), so the nine taps read the same
//   halo through shared-memory descriptors whose start moves by one pixel
//   (16 bytes) per column shift and one halo row per row shift
//   (stride-byte offset = a halo row).  Reflect padding rules out TMA's
//   zero fill here, and a swizzled layout could not be shifted by one
//   pixel.
// - B, the weights of one (chunk, tap): the rows tap*C + c0 .. +63 of the
//   (9C, Co) weight matrix, N columns, loaded by TMA in boxes of 64 (or 32,
//   16) columns into the matching 128 (64, 32)-byte swizzled layout, which
//   wgmma reads N-major; a ring of NB full/empty mbarrier pairs.
//
// Epilogue: the bias is added to the float32 accumulator; with STATS each
// warp sums y and y*y over its rows by shuffles, then the block sums its
// eight warps in a fixed order into partial[n][tile][2][Co] (no atomics,
// the same bits every run).  y is rounded to bf16 into a staging tile in
// shared memory and written out as 16-byte vectors, one pixel's channels
// contiguous.
//
// The narrow K1 (STATS, C <= 64 and N <= 64: RTNSTV's 48 channels,
// SD1/SD2's 64) differs in three ways, because at these widths a tile's
// products are short and the fixed costs of stages, tiles and launches
// held the launch (experiments/k1_narrow_variants.py, PERF.md):
// - 16 x 16-pixel tiles (MT = 2), half as many tiles as 8 x 16;
// - the nine (tap) weight stages, (9C, N) bf16 (41.5 KB at 48 -> 48, 73.7
//   KB at 64 -> 64), are loaded once per block by TMA and stay in shared
//   memory, so each tile waits once for its halo and issues its 9 taps x
//   k16 steps x MT products as one commit group (the other bodies wait
//   for and release every stage), with two halo buffers, which all four
//   producer warps stage (and normalize, the prologue's longest part);
// - the halo threads derive the prologue's per-(image, channel) mean and
//   scale from the previous conv's statistics themselves, so a call is
//   two launches (the conv, finalize_stats) where the wider K1 takes three
//   (res_block_common.cuh::k1_run).  Finishing the statistics inside the
//   launch as well, with atomic counts of each image's tiles, cost more
//   than the launch it saved.
//
// Needs C % 8 == 0 and Co % 8 == 0 (the wrappers check it).
#pragma once

#include <atomic>
#include <cstdint>
#include <initializer_list>
#include <type_traits>

#include "conv3x3_tile.cuh"
#include "wgmma.cuh"   // cp.async, mbarriers, TMA, wgmma, encode_tiled

namespace vst {
namespace wg {

constexpr int TW = 16;                          // output tile columns
constexpr int HW = TW + 2;                      // halo columns
constexpr int KC = 64;                          // channels per chunk
constexpr int NCONS = 256;                      // two consumer warpgroups
constexpr int NTH = NCONS + 128;                // and one producer warpgroup

// 64-row GEMM blocks per consumer warpgroup: 2 for narrow tiles (K2's
// heads, the narrow K1), so each stage does twice the work and the tile's
// fixed costs are paid half as often; else 1.  The output tile is 8 * mt
// rows x 16 columns.
__host__ __device__ constexpr int m_blocks(int n) { return n <= 64 ? 2 : 1; }

// The narrow K1: STATS with a tile of <= 64 channels (and C <= 64, one
// chunk: tile_n sends wider inputs to a 128 tile).  Its nine (tap) weight
// stages stay in shared memory for all of a block's tiles, and each tile's
// 9 x k16 x MT products go out as one commit group.
__host__ __device__ constexpr bool narrow(int n, bool stats) {
  return stats && n <= 64;
}

// Halo pixels and bytes of one staged 64-channel chunk.
__host__ __device__ constexpr int halo_pixels(int mt) { return (8 * mt + 2) * HW; }
__host__ __device__ constexpr int halo_bytes(int mt) {
  return (KC / 8) * halo_pixels(mt) * 16;
}

// Output tiles of one image (mt = 1: the float32 body's).
__host__ __device__ inline int tiles(int h, int w, int mt = 1) {
  return ((h + 8 * mt - 1) / (8 * mt)) * ((w + TW - 1) / TW);
}

// Weight rows per stage: 64, or C rounded up to 16 when C < 64.
__host__ __device__ inline int stage_rows(int c) {
  return c >= KC ? KC : (c + 15) / 16 * 16;
}

// Output channels per TMA box (and swizzle span / 2 bytes) for tile N.
__host__ __device__ constexpr int box_cols(int n) {
  return n % 64 == 0 ? 64 : (n % 32 == 0 ? 32 : 16);
}

// Ring depths: weight slots (the narrow K1's nine are its resident taps),
// and halo buffers (narrow tiles finish a chunk fast, so they stage more
// halos ahead); shared memory stays under 227 KB.
__host__ __device__ constexpr int ring_b(int n, bool stats) {
  return narrow(n, stats) ? 9 : (n == 256 ? 3 : 4);
}
__host__ __device__ constexpr int ring_a(int n, int mt, bool stats) {
  return narrow(n, stats) ? 2 : (mt == 2 ? 3 : (n <= 64 ? 4 : 2));
}

// Shared memory: the weight ring, the halos, the epilogue's staging tile,
// with STATS the per-warp sums and the bias, the mbarriers; plus 1 KB to
// align the ring for the 128-byte swizzle.
inline int smem_bytes(int n, int co, bool stats) {
  const int mt = m_blocks(n), nb = ring_b(n, stats), na = ring_a(n, mt, stats);
  return 1024 + nb * KC * n * 2 + na * halo_bytes(mt) +
         mt * 128 * (n + 8) * 2 + (stats ? 16 * n * 4 + co * 4 : 0) +
         2 * (nb + na) * 8;
}

// The output-channel tile for Co: as few tiles of <= max_n as cover it,
// each rounded up to an instantiated width.
inline int pick_n(int co, int max_n) {
  const int tiles_n = (co + max_n - 1) / max_n;
  const int per = (co + tiles_n - 1) / tiles_n;
  for (int n : {32, 48, 64, 128, 192, 256})
    if (n >= per) return n;
  return max_n;
}

// The output-channel tile of a launch for (C, Co): pick_n, but 128 where
// a narrow K1's C would need more than one chunk.
inline int tile_n(int c, int co, bool stats) {
  const int n = pick_n(co, stats ? 192 : 256);
  return narrow(n, stats) && c > KC ? 128 : n;
}

// The bf16 K1 (STATS) for (C, Co): whether it is the narrow kernel, and
// the partial sums it writes per (h, w) image.
inline bool k1_narrow(int c, int co) { return narrow(tile_n(c, co, true), true); }
inline int k1_tiles(int h, int w, int c, int co) {
  return tiles(h, w, m_blocks(tile_n(c, co, true)));
}

template <bool REFLECT, bool PROLOGUE, bool STATS, int N>
__global__ void __launch_bounds__(NTH, 1)
    conv3x3_wgmma(ConvArgs a, const __grid_constant__ CUtensorMap wmap,
                  int images) {
  extern __shared__ unsigned char smem_raw[];
  using bf16 = __nv_bfloat16;
  constexpr int MT = m_blocks(N);
  constexpr bool NARROW = narrow(N, STATS);
  constexpr int TH = 8 * MT, HP = halo_pixels(MT), A_BYTES = halo_bytes(MT);
  constexpr int NG = N / 8;                 // 8-channel groups of a row
  constexpr int BOX = box_cols(N);          // output channels per TMA box
  constexpr unsigned LAYOUT = BOX == 64 ? 1 : (BOX == 32 ? 2 : 3);
  constexpr int NB = ring_b(N, STATS), NA = ring_a(N, MT, STATS);
  constexpr int B_BYTES = KC * N * 2;       // one weight slot
  // [NB] weight slots | [NA] halos | staging [MT * 128][N + 8] bf16 |
  // STATS: red [8][2][N], bias [Co] | mbarriers
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* Bs = smem;
  unsigned char* As = Bs + NB * B_BYTES;
  bf16* stage = reinterpret_cast<bf16*>(As + NA * A_BYTES);
  float* red = reinterpret_cast<float*>(stage + MT * 128 * (N + 8));
  float* bias_s = red + (STATS ? 16 * N : 0);
  uint64_t* bars = reinterpret_cast<uint64_t*>(bias_s + (STATS ? a.co : 0));
  const unsigned b_full = smem_u32(bars), b_empty = b_full + NB * 8;
  const unsigned a_full = b_empty + NB * 8, a_empty = a_full + NA * 8;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tiles_x = (a.w_out + TW - 1) / TW;
  const int tiles_pix = tiles(a.h_out, a.w_out, MT);
  const int ntn = (a.co + N - 1) / N;
  const int total = images * tiles_pix * ntn;
  // This block's tiles: blockIdx.x, + gridDim.x, ...  The output-channel
  // tile varies fastest, so the blocks that share an input tile run
  // together.
  const int my_tiles = total > static_cast<int>(blockIdx.x)
      ? (total - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
  struct Tile { int n, pt, co0, oy0, ox0; };
  auto tile_at = [&](int i) {
    const int t = blockIdx.x + i * gridDim.x;
    Tile r;
    r.co0 = (t % ntn) * N;
    r.pt = (t / ntn) % tiles_pix;
    r.n = t / (ntn * tiles_pix);
    r.oy0 = (r.pt / tiles_x) * TH;
    r.ox0 = (r.pt % tiles_x) * TW;
    return r;
  };
  const int nch = (a.c + KC - 1) / KC;
  const int stages = 9 * nch;
  const int rows = stage_rows(a.c);
  // 8-channel groups staged for chunk ch: whole k16 steps, zero past C.
  auto groups = [&](int ch) { return 2 * ((min(KC, a.c - ch * KC) + 15) / 16); };

  if (STATS) {
    for (int o = tid; o < a.co; o += NTH)
      bias_s[o] = __bfloat162float(static_cast<const bf16*>(a.bias)[o]);
  }
  if (tid == 0) {
    for (int i = 0; i < NB; ++i) {
      mbar_init(b_full + 8 * i, 1);            // the producer's expect_tx
      mbar_init(b_empty + 8 * i, NCONS / 32);  // lane 0 of each consumer warp
    }
    for (int i = 0; i < NA; ++i) {
      mbar_init(a_full + 8 * i, NARROW ? 4 : 3);   // lane 0 of each halo warp
      mbar_init(a_empty + 8 * i, NCONS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= NCONS / 32) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    if (warp == NCONS / 32 && lane == 0) {
      if (NARROW) {   // every tap, once
        for (int tap = 0; tap < 9 && my_tiles > 0; ++tap) {
          mbar_expect_tx(b_full + 8 * tap, rows * N * 2);
          const unsigned dst = smem_u32(Bs + tap * B_BYTES);
#pragma unroll
          for (int j = 0; j < N / BOX; ++j)
            tma_load_2d(dst + j * rows * BOX * 2, &wmap, j * BOX, tap * a.c,
                        b_full + 8 * tap);
        }
      } else {   // the weight ring
        int gs = 0;
        for (int i = 0; i < my_tiles; ++i) {
          const Tile tl = tile_at(i);
          for (int s = 0; s < stages; ++s, ++gs) {
            const int ch = s / 9, tap = s - 9 * (s / 9), slot = gs % NB;
            mbar_wait(b_empty + 8 * slot, ((gs / NB) & 1) ^ 1);
            mbar_expect_tx(b_full + 8 * slot, rows * N * 2);
            const unsigned dst = smem_u32(Bs + slot * B_BYTES);
#pragma unroll
            for (int j = 0; j < N / BOX; ++j)
              tma_load_2d(dst + j * rows * BOX * 2, &wmap, tl.co0 + j * BOX,
                          tap * a.c + ch * KC, b_full + 8 * slot);
          }
        }
      }
    }
    if (NARROW || warp > NCONS / 32) {
      // The halos, NA - 1 chunks ahead, by warps 1-3 of the producer (and
      // warp 0 too in the narrow K1, whose weights need one thread once).
      // Thread t keeps one 8-channel group g and walks every pstep-th halo
      // pixel: of 8 groups, every 12th, neighbouring threads taking the two
      // halves of one pixel's 32 bytes; in the narrow K1, of the tile's G,
      // every (128 / G)-th, neighbouring threads taking a pixel's
      // neighbouring 16 bytes.
      const int t = tid - NCONS - (NARROW ? 0 : 32);   // 0..127 or 0..95
      int g, p0, pstep;
      if (NARROW) {
        const int ng = groups(0);
        pstep = 128 / ng;
        g = t < pstep * ng ? t % ng : KC / 8;   // KC / 8: idle
        p0 = t / ng;
      } else {
        g = 2 * (t / 24) + (t & 1);
        p0 = (t % 24) >> 1;
        pstep = 12;
      }
      const int chunks = my_tiles * nch;
      auto stage_halo = [&](int gc) {
        const Tile tl = tile_at(gc / nch);
        const int cc = (gc % nch) * KC + 8 * g;
        if (g >= groups(gc % nch)) return;
        const bf16* xn = static_cast<const bf16*>(a.x) +
                         (size_t)tl.n * a.h_in * a.w_in * a.c;
        const unsigned dst = smem_u32(As + (gc % NA) * A_BYTES + g * HP * 16);
        for (int p = p0; p < HP; p += pstep) {
          const int hr = p / HW, hc = p - (p / HW) * HW;
          int iy, ix;
          bool ok;
          if (REFLECT) {   // input row oy0-1+hr; rows past H feed no output
            iy = tl.oy0 - 1 + hr;
            ix = tl.ox0 - 1 + hc;
            ok = iy <= a.h_in && ix <= a.w_in;
            iy = reflect1(iy, a.h_in);
            ix = reflect1(ix, a.w_in);
          } else {
            iy = tl.oy0 + hr;
            ix = tl.ox0 + hc;
            ok = iy < a.h_in && ix < a.w_in;
          }
          ok = ok && cc < a.c;
          cp_async16(dst + p * 16,
                     ok ? xn + ((size_t)iy * a.w_in + ix) * a.c + cc : xn, ok);
        }
      };
      // relu((v - mean) * scale + beta), rounded to bf16, in place; only
      // zero-filled pixels that feed no output are normalized needlessly
      auto normalize = [&](int gc) {
        const int n = tile_at(gc / nch).n;
        const int cc = (gc % nch) * KC + 8 * g;
        if (g >= groups(gc % nch) || cc >= a.c) return;
        float mean[8], scale[8], beta[8];
        if (NARROW && a.stats_in != nullptr) {
          // prologue_params' arithmetic, here: scale = gamma * rsqrt(var +
          // eps) from the previous conv's (mean, var) of this image
          const float* st = a.stats_in + (size_t)n * 2 * a.c + cc;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float gm =
                a.gb_bf16 ? __bfloat162float(static_cast<const bf16*>(a.gamma)[cc + i])
                          : static_cast<const float*>(a.gamma)[cc + i];
            beta[i] = a.gb_bf16 ? __bfloat162float(static_cast<const bf16*>(a.beta)[cc + i])
                                : static_cast<const float*>(a.beta)[cc + i];
            mean[i] = __ldg(st + i);
            scale[i] = __fmul_rn(gm, rsqrtf(__fadd_rn(__ldg(st + a.c + i), 1e-5f)));
          }
        } else {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            *reinterpret_cast<float4*>(&mean[4 * h]) = __ldg(
                reinterpret_cast<const float4*>(a.pro_mean + n * a.c + cc) + h);
            *reinterpret_cast<float4*>(&scale[4 * h]) = __ldg(
                reinterpret_cast<const float4*>(a.pro_scale + n * a.c + cc) + h);
            *reinterpret_cast<float4*>(&beta[4 * h]) = __ldg(
                reinterpret_cast<const float4*>(a.pro_beta + cc) + h);
          }
        }
        uint4* q = reinterpret_cast<uint4*>(As + (gc % NA) * A_BYTES + g * HP * 16);
        for (int p = p0; p < HP; p += pstep) {
          uint4 v = q[p];
          unsigned* u = reinterpret_cast<unsigned*>(&v);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float2 f = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&u[i]));
            // no FMA contraction: the same roundings as the plain version
            const float z0 = __fadd_rn(
                __fmul_rn(__fsub_rn(f.x, mean[2 * i]), scale[2 * i]),
                beta[2 * i]);
            const float z1 = __fadd_rn(
                __fmul_rn(__fsub_rn(f.y, mean[2 * i + 1]), scale[2 * i + 1]),
                beta[2 * i + 1]);
            __nv_bfloat162 hv =
                __floats2bfloat162_rn(fmaxf(z0, 0.f), fmaxf(z1, 0.f));
            u[i] = *reinterpret_cast<unsigned*>(&hv);
          }
          q[p] = v;
        }
      };
#pragma unroll
      for (int k = 0; k < NA - 1; ++k) {
        if (k < chunks) stage_halo(k);   // the buffers start empty
        cp_async_commit();
      }
      for (int gc = 0; gc < chunks; ++gc) {
        cp_async_wait<NA - 2>();    // chunk gc has landed (this thread's part)
        if (PROLOGUE) normalize(gc);
        fence_async_shared();
        __syncwarp();
        if (lane == 0) mbar_arrive(a_full + 8 * (gc % NA));
        const int next = gc + NA - 1;   // into chunk gc - 1's buffer
        if (next < chunks) {
          mbar_wait(a_empty + 8 * (next % NA), ((next / NA) & 1) ^ 1);
          stage_halo(next);
        }
        cp_async_commit();
      }
    }
  } else {
    // ---------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
    const int wgi = warp >> 2, wl = warp & 3;
    int gs = 0, gc = 0;
    for (int i = 0; i < my_tiles; ++i) {
      const Tile tl = tile_at(i);
      float acc[MT][N / 2];
#pragma unroll
      for (int mb = 0; mb < MT; ++mb)
#pragma unroll
        for (int k = 0; k < N / 2; ++k) acc[mb][k] = 0.f;
      if constexpr (NARROW) {
        // One chunk, the taps resident: the tile's products in one group.
        const int buf = gc % NA;
        mbar_wait(a_full + 8 * buf, (gc / NA) & 1);
        if (i == 0)
          for (int tap = 0; tap < 9; ++tap) mbar_wait(b_full + 8 * tap, 0);
        const int nks = groups(0) / 2;
#pragma unroll
        for (int mb = 0; mb < MT; ++mb) fence_acc(acc[mb]);
        wgmma_fence();
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const int dy = tap / 3, dx = tap - 3 * (tap / 3);
          const unsigned a0 = smem_u32(As + buf * A_BYTES) +
                              (dy * HW + wgi * 8 + dx) * 16;
          const unsigned b0 = smem_u32(Bs + tap * B_BYTES);
          for (int ks = 0; ks < nks; ++ks) {
            const uint64_t db = desc(b0 + ks * 16 * BOX * 2, rows * BOX * 2,
                                     8 * BOX * 2, LAYOUT);
#pragma unroll
            for (int mb = 0; mb < MT; ++mb)
              wgmma_bf16<N, B_NMAJOR>(acc[mb],
                            desc(a0 + (mb * 8 * HW + ks * 2 * HP) * 16,
                                 HP * 16, HW * 16, 0), db);
          }
        }
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int mb = 0; mb < MT; ++mb) fence_acc(acc[mb]);
        if (lane == 0) mbar_arrive(a_empty + 8 * buf);
        gc += 1;
      } else {
        for (int s = 0; s < stages; ++s, ++gs) {
          const int ch = s / 9, tap = s - 9 * (s / 9), slot = gs % NB;
          const int buf = (gc + ch) % NA;
          if (tap == 0) mbar_wait(a_full + 8 * buf, ((gc + ch) / NA) & 1);
          mbar_wait(b_full + 8 * slot, (gs / NB) & 1);
          const int dy = tap / 3, dx = tap - 3 * (tap / 3);
          const unsigned a0 = smem_u32(As + buf * A_BYTES) +
                              (dy * HW + wgi * 8 + dx) * 16;
          const unsigned b0 = smem_u32(Bs + slot * B_BYTES);
          const int nks = groups(ch) / 2;
#pragma unroll
          for (int mb = 0; mb < MT; ++mb) fence_acc(acc[mb]);
          wgmma_fence();
          for (int ks = 0; ks < nks; ++ks) {
            const uint64_t db = desc(b0 + ks * 16 * BOX * 2, rows * BOX * 2,
                                     8 * BOX * 2, LAYOUT);
#pragma unroll
            for (int mb = 0; mb < MT; ++mb)
              wgmma_bf16<N, B_NMAJOR>(acc[mb],
                            desc(a0 + (mb * 8 * HW + ks * 2 * HP) * 16,
                                 HP * 16, HW * 16, 0), db);
          }
          wgmma_commit();
          wgmma_wait<1>();              // stage s-1's multiply is done
#pragma unroll
          for (int mb = 0; mb < MT; ++mb) fence_acc(acc[mb]);
          if (s > 0 && lane == 0) {     // release stage s-1's buffers
            mbar_arrive(b_empty + 8 * ((gs - 1) % NB));
            if (tap == 0) mbar_arrive(a_empty + 8 * ((gc + ch - 1) % NA));
          }
        }
        wgmma_wait<0>();
#pragma unroll
        for (int mb = 0; mb < MT; ++mb) fence_acc(acc[mb]);
        if (lane == 0) {
          mbar_arrive(b_empty + 8 * ((gs - 1) % NB));
          mbar_arrive(a_empty + 8 * ((gc + nch - 1) % NA));
        }
        gc += nch;
      }

      // Epilogue.  acc[mb][4j + 2h + t]: GEMM row 16*(warp%4) + lane/4 +
      // 8h of block mb of this warpgroup = tile row 8mb + 2*(warp%4) + h,
      // tile column 8*wgi + lane/4; channel 8j + 2*(lane%4) + t.  Staging
      // row 128mb + 64wgi + that GEMM row.  The first barrier waits for
      // the previous tile's stores to leave the staging buffer.
      asm volatile("bar.sync 1, %0;\n" :: "n"(NCONS) : "memory");
      const int ox = tl.ox0 + 8 * wgi + (lane >> 2);
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        const int col = 8 * j + 2 * (lane & 3);
        const bool live = tl.co0 + col < a.co;
        const float b0 = STATS && live ? bias_s[tl.co0 + col] : 0.f;
        const float b1 = STATS && live ? bias_s[tl.co0 + col + 1] : 0.f;
        float s0 = 0.f, s1 = 0.f, q0 = 0.f, q1 = 0.f;
#pragma unroll
        for (int mb = 0; mb < MT; ++mb) {
          bf16* row = stage + (mb * 128 + wgi * 64 + wl * 16 + (lane >> 2)) * (N + 8);
          const float y00 = acc[mb][4 * j] + b0, y01 = acc[mb][4 * j + 1] + b1;
          const float y10 = acc[mb][4 * j + 2] + b0, y11 = acc[mb][4 * j + 3] + b1;
          *reinterpret_cast<__nv_bfloat162*>(row + col) =
              __floats2bfloat162_rn(y00, y01);
          *reinterpret_cast<__nv_bfloat162*>(row + 8 * (N + 8) + col) =
              __floats2bfloat162_rn(y10, y11);
          if (STATS) {
            const int oy = tl.oy0 + 8 * mb + 2 * wl;
            const bool in0 = oy < a.h_out && ox < a.w_out;
            const bool in1 = oy + 1 < a.h_out && ox < a.w_out;
            s0 += (in0 ? y00 : 0.f) + (in1 ? y10 : 0.f);
            s1 += (in0 ? y01 : 0.f) + (in1 ? y11 : 0.f);
            q0 += (in0 ? y00 * y00 : 0.f) + (in1 ? y10 * y10 : 0.f);
            q1 += (in0 ? y01 * y01 : 0.f) + (in1 ? y11 * y11 : 0.f);
          }
        }
        if (STATS) {
          // Sum the four values over the 8 rows of the warp (lane bits
          // 2..4) in 4 shuffles: lane bit 4 keeps y or y*y, bit 3 the even
          // or odd channel, and the halves travel.
          const bool hi = lane & 16, odd = lane & 8;
          const float k0 = (hi ? q0 : s0) + __shfl_xor_sync(0xffffffffu, hi ? s0 : q0, 16);
          const float k1 = (hi ? q1 : s1) + __shfl_xor_sync(0xffffffffu, hi ? s1 : q1, 16);
          float v = (odd ? k1 : k0) + __shfl_xor_sync(0xffffffffu, odd ? k0 : k1, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          if (!(lane & 4)) red[(warp * 2 + hi) * N + col + odd] = v;
        }
      }
      asm volatile("bar.sync 1, %0;\n" :: "n"(NCONS) : "memory");

      bf16* y = static_cast<bf16*>(a.y);
      for (int e = tid; e < MT * 128 * NG; e += NCONS) {
        const int m = e / NG, g = e - (e / NG) * NG;
        const int mr = m & 63, r = m & 127;
        const int py = tl.oy0 + 8 * (m >> 7) + (mr >> 3);
        const int px = tl.ox0 + 8 * (r >> 6) + (mr & 7);
        const int o = tl.co0 + 8 * g;
        if (py < a.h_out && px < a.w_out && o < a.co)
          *reinterpret_cast<uint4*>(
              y + (((size_t)tl.n * a.h_out + py) * a.w_out + px) * a.co + o) =
              *reinterpret_cast<const uint4*>(stage + m * (N + 8) + 8 * g);
      }
      if (STATS && tid < N && tl.co0 + tid < a.co) {
        float t1 = 0.f, t2 = 0.f;
        for (int r = 0; r < 8; ++r) {
          t1 += red[(r * 2) * N + tid];
          t2 += red[(r * 2 + 1) * N + tid];
        }
        float* pb = a.partial + ((size_t)tl.n * tiles_pix + tl.pt) * 2 * a.co;
        pb[tl.co0 + tid] = t1;
        pb[a.co + tl.co0 + tid] = t2;
      }
    }
  }
}

// The weights as a (9C rows, Co columns) bf16 matrix, read in boxes of
// stage_rows(C) rows x box_cols(N) columns, swizzled to the box's width.
inline cudaError_t weight_map(CUtensorMap* map, const ConvArgs& a, int n_tile) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  const int box = box_cols(n_tile);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(a.co),
                              static_cast<cuuint64_t>(9) * a.c};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(a.co) * 2};
  const cuuint32_t boxdim[2] = {static_cast<cuuint32_t>(box),
                                static_cast<cuuint32_t>(stage_rows(a.c))};
  const cuuint32_t estride[2] = {1, 1};
  const CUtensorMapSwizzle swz = box == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : box == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                             : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                         const_cast<void*>(a.w), dims, strides, boxdim,
                         estride, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Calls f(std::integral_constant<int, N>) with N = tile_n(c, co, STATS):
// tiles of up to 192 channels with STATS (the per-warp sums and the bias
// must fit beside the rings), of up to 256 without.
template <bool STATS, class F>
cudaError_t with_tile(int c, int co, F&& f) {
  switch (tile_n(c, co, STATS)) {
    case 32: return f(std::integral_constant<int, 32>{});
    case 48: return f(std::integral_constant<int, 48>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 128: return f(std::integral_constant<int, 128>{});
    case 192: return f(std::integral_constant<int, 192>{});
    default: return f(std::integral_constant<int, 256>{});
  }
}

// The kernel allowed the device's whole opt-in shared memory (so any Co's
// launch fits) and the device's SM count, asked of the runtime once per
// (device, kernel) through the caller's static cache, as they cost host
// time on every call otherwise.  The cache holds the kernel's address, not
// a flag: a template's static is one object across the libraries of a
// process (GNU unique symbols), and a variant library's copy of a kernel
// (experiments/) needs its own allowance.
constexpr int kMaxDevices = 64;
template <class Kernel>
cudaError_t ready(Kernel kernel,
                  std::atomic<const void*> (&cache)[kMaxDevices], int* sms) {
  static std::atomic<int> sm_count[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const void* key = reinterpret_cast<const void*>(kernel);
  if (dev < kMaxDevices && cache[dev].load() == key &&
      (*sms = sm_count[dev].load()) > 0)
    return cudaSuccess;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev < kMaxDevices) {
    sm_count[dev].store(*sms);
    cache[dev].store(key);
  }
  return err;
}

// Launches conv3x3_wgmma: one block per SM (at most one per tile), each
// walking its tiles.
template <bool REFLECT, bool PROLOGUE, bool STATS>
cudaError_t launch(const ConvArgs& a, int n, cudaStream_t s) {
  return with_tile<STATS>(a.c, a.co, [&](auto tile) {
    constexpr int N = decltype(tile)::value;
    auto kernel = conv3x3_wgmma<REFLECT, PROLOGUE, STATS, N>;
    static std::atomic<const void*> cache[kMaxDevices];
    int sms = 0;
    cudaError_t err = ready(kernel, cache, &sms);
    if (err != cudaSuccess) return err;
    CUtensorMap map;
    err = weight_map(&map, a, N);
    if (err != cudaSuccess) return err;
    const int total = n * tiles(a.h_out, a.w_out, m_blocks(N)) *
                      ((a.co + N - 1) / N);
    kernel<<<total < sms ? total : sms, NTH, smem_bytes(N, a.co, STATS), s>>>(
        a, map, n);
    return cudaGetLastError();
  });
}

// What launch() would run for (C, Co): out = {tile N, dynamic shared
// memory bytes, resident blocks per SM}.
template <bool REFLECT, bool PROLOGUE, bool STATS>
cudaError_t config(int c, int co, int* out) {
  return with_tile<STATS>(c, co, [&](auto tile) {
    constexpr int N = decltype(tile)::value;
    auto kernel = conv3x3_wgmma<REFLECT, PROLOGUE, STATS, N>;
    static std::atomic<const void*> cache[kMaxDevices];
    int sms = 0;
    cudaError_t err = ready(kernel, cache, &sms);
    if (err != cudaSuccess) return err;
    out[0] = N;
    out[1] = smem_bytes(N, co, STATS);
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], kernel, NTH,
                                                         out[1]);
  });
}

}  // namespace wg
}  // namespace vst
