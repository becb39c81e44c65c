// conv3x3_tf32: the float32 body of K1 (res_block.cu) and K2
// (head_conv.cu), a 3x3 stride-1 conv over NHWC activations and HWIO
// weights as an implicit GEMM on Hopper's warpgroup tensor-core
// instruction in 3xTF32 (wgmma.mma_async m64nNk8 .tf32, float32
// accumulate), with the flags and rounding points of conv3x3_tile.cuh
// (REFLECT, PROLOGUE, STATS).  The bf16 body's design (conv3x3_wgmma.cuh)
// with what the float32 attention kernels learned about 3xTF32.
//
// 3xTF32: an operand x enters as two tf32 parts, big = tf32(x) and small =
// tf32(x - big), both rounded to nearest by cvt.rna, and a product a b is
// a_small b_big + a_big b_small + a_big b_big, small x small dropped.  The
// tensor core's float32 accumulation does not round to nearest and its
// error grows with the chain, so every (channel chunk, tap) stage is
// summed into a fresh partial (the small-part products first) that the
// consumer adds to its accumulator in float32.
//
// Grid: one persistent block per SM (at most one per tile), walking tiles
// blockIdx.x, + gridDim.x, ...  A tile is 8 rows x 16 columns of one image
// by N output channels, N one of 32, 48, 64, 96, 128, 192 and Co split
// into as few N-wide tiles as fit (192 -> one, 768 -> four, 48 -> one of
// 48); the output-channel tile varies fastest, so the blocks that read one
// input tile run together.
//
// Block: three warpgroups, warp-specialized, synchronized by mbarriers
// (consumers among themselves by one named barrier in the STATS epilogue).
// - Consumers, warpgroups 0 and 1 (setmaxnreg 232): warpgroup g owns
//   columns 8g..8g+7 of the tile, one 64-row GEMM block, with an N/2-float
//   accumulator and an N/2-float fresh partial a thread.  Per stage: wait,
//   the 3 x (k8 steps) products into the partial, commit, wait, add,
//   release; the other consumer's products fill the tensor core meanwhile.
// - Producer, warpgroup 2 (setmaxnreg 40): one thread keeps the weight
//   ring full through TMA; three warps stage the input halos, NA - 1
//   chunks ahead, and split them.
//
// K loop: C in chunks of up to 32 channels (one 128-byte row of float32),
// and in each chunk the nine taps.
// - A, the input: once per chunk the 10 x 18 halo of the tile is staged
//   in shared memory, reflect padding resolved by index (pixels that feed
//   only outputs outside the image are zero-filled), through cp.async when
//   C % 4 == 0 and x starts on 16 bytes, else by plain loads that also
//   zero-fill the channel tail.  Then the thread that loaded a value
//   applies the PROLOGUE's normalize+relu (float32, no contraction) and
//   splits it, in shared memory: the big part in place, the small part in
//   a second plane.  The layout of each part is [4-channel group][halo
//   pixel][4 floats]: one pixel's 4-channel group is one 16-byte row of a
//   wgmma core matrix (no swizzle), so the nine taps read the same halo
//   through descriptors whose start moves by one pixel (16 bytes) per
//   column shift and one halo row per row shift, as in the bf16 body.
// - B, the weights: tf32 reads B K-major only, and the HWIO weights are
//   N-major, so a pre-pass per launch (split_tf32 of attn_common.cuh)
//   writes their big and small parts transposed, as (part, tap, Co, Cp)
//   with Cp = C rounded up to 4 and zeros past C; TMA loads a stage's two
//   boxes of 32 channels x N output channels (zeros past Cp and Co) in the
//   128-byte swizzle; a ring of NB full/empty mbarrier pairs.
//
// Epilogue: the bias is added to the float32 accumulator, and y is stored
// from the registers (float2 pairs: 32 contiguous bytes per four lanes);
// with STATS each warp sums y and y*y over its rows by shuffles, and the
// block sums its eight warps in a fixed order into partial[n][tile][2][Co]
// (no atomics, the same bits every run).
//
// Takes any C and Co.
//
// What holds it on the H100 (experiments/conv_f32_variants.py, PERF.md):
// the products first (three tf32 products for every float32 one), then
// the epilogue, which no multiply overlaps (both consumers finish a tile
// together), and the drain of each stage's fresh partial.
#pragma once

#include <atomic>
#include <cstdint>
#include <type_traits>

#include "attn_common.cuh"     // split_tf32, SplitJob (the weights' pre-pass)
#include "conv3x3_wgmma.cuh"   // ConvArgs, reflect1, tiles(), TW, HW, NCONS, NTH

namespace vst {
namespace tf {

using wg::HW;
using wg::NCONS;
using wg::NTH;
using wg::TW;

constexpr int TH = 8;                      // output tile rows
constexpr int KC = 32;                     // channels per chunk
constexpr int HP = (TH + 2) * HW;          // halo pixels: 180
constexpr int A_PART = (KC / 4) * HP * 16;   // one part of a staged chunk
constexpr int A_BYTES = 2 * A_PART;          // 46,080 B

// Ring depths: weight stages (2 x N x 128 bytes each) and halo buffers;
// shared memory stays under 227 KB.
__host__ __device__ constexpr int ring_b(int n) {
  return n >= 192 ? 2 : (n >= 96 ? 3 : 4);
}
__host__ __device__ constexpr int ring_a(int n) { return n <= 64 ? 3 : 2; }

// Shared memory: the weight ring, the halos, with STATS the per-warp sums,
// the mbarriers; plus 1 KB to align the ring for the 128-byte swizzle.
inline int smem_bytes(int n, bool stats) {
  return 1024 + ring_b(n) * 2 * n * KC * 4 + ring_a(n) * A_BYTES +
         (stats ? 16 * n * 4 : 0) + 2 * (ring_b(n) + ring_a(n)) * 8;
}

// Floats of the weights' split scratch for (C, Co): (2, 9, Co, Cp).
inline long long weight_floats(int c, int co) {
  return 18LL * co * ((c + 3) / 4 * 4);
}

// The output-channel tile for Co: as few tiles of <= 192 as cover it, each
// rounded up to an instantiated width.
inline int pick_n(int co) {
  const int tiles_n = (co + 191) / 192;
  const int per = (co + tiles_n - 1) / tiles_n;
  for (int n : {32, 48, 64, 96, 128})
    if (n >= per) return n;
  return 192;
}

__device__ __forceinline__ void store_pair(float* p, int o, int co, bool pair,
                                           float v0, float v1) {
  if (pair && o + 1 < co) {
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
  } else {
    if (o < co) p[0] = v0;
    if (o + 1 < co) p[1] = v1;
  }
}

template <bool REFLECT, bool PROLOGUE, bool STATS, int N>
__global__ void __launch_bounds__(NTH, 1)
    conv3x3_tf32(ConvArgs a, const __grid_constant__ CUtensorMap wmap,
                 int images) {
  extern __shared__ unsigned char smem_raw[];
  constexpr int NB = ring_b(N), NA = ring_a(N);
  constexpr int B_PART = N * KC * 4;        // one part of a weight stage
  constexpr int B_BYTES = 2 * B_PART;
  // [NB] weight stages (big | small) | [NA] halos (big | small) |
  // STATS: red [8][2][N] | mbarriers
  unsigned char* smem =
      smem_raw + ((1024 - (wg::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* Bs = smem;
  unsigned char* As = Bs + NB * B_BYTES;
  float* red = reinterpret_cast<float*>(As + NA * A_BYTES);
  uint64_t* bars = reinterpret_cast<uint64_t*>(red + (STATS ? 16 * N : 0));
  const unsigned b_full = wg::smem_u32(bars), b_empty = b_full + NB * 8;
  const unsigned a_full = b_empty + NB * 8, a_empty = a_full + NA * 8;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tiles_x = (a.w_out + TW - 1) / TW;
  const int tiles_pix = wg::tiles(a.h_out, a.w_out);
  const int ntn = (a.co + N - 1) / N;
  const int total = images * tiles_pix * ntn;
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
  // k8 steps of chunk ch (channels past C are zero on both sides)
  auto steps = [&](int ch) { return (min(KC, a.c - ch * KC) + 7) / 8; };

  if (tid == 0) {
    for (int i = 0; i < NB; ++i) {
      wg::mbar_init(b_full + 8 * i, 1);            // the producer's expect_tx
      wg::mbar_init(b_empty + 8 * i, NCONS / 32);  // lane 0 of each consumer warp
    }
    for (int i = 0; i < NA; ++i) {
      wg::mbar_init(a_full + 8 * i, 3);            // lane 0 of each halo warp
      wg::mbar_init(a_empty + 8 * i, NCONS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= NCONS / 32) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == NCONS / 32) {
      if (lane == 0) {   // the weight ring: big and small boxes per stage
        int gs = 0;
        for (int i = 0; i < my_tiles; ++i) {
          const int co0 = tile_at(i).co0;
          for (int s = 0; s < stages; ++s, ++gs) {
            const int ch = s / 9, tap = s - 9 * (s / 9), slot = gs % NB;
            wg::mbar_wait(b_empty + 8 * slot, ((gs / NB) & 1) ^ 1);
            wg::mbar_expect_tx(b_full + 8 * slot, B_BYTES);
            const unsigned dst = wg::smem_u32(Bs + slot * B_BYTES);
            wg::tma_load_3d(dst, &wmap, ch * KC, co0, tap, b_full + 8 * slot);
            wg::tma_load_3d(dst + B_PART, &wmap, ch * KC, co0, 9 + tap,
                            b_full + 8 * slot);
          }
        }
      }
    } else {
      // The halos, NA - 1 chunks ahead.  Thread t keeps one 4-channel group
      // g and walks every 12th halo pixel; eight neighbouring threads read
      // one pixel's 128 bytes.
      const int t = tid - NCONS - 32;          // 0..95
      const int g = t & 7, p0 = t >> 3;
      const int chunks = my_tiles * nch;
      const float* x = static_cast<const float*>(a.x);
      const bool vec = (a.c & 3) == 0 &&
                       (reinterpret_cast<uintptr_t>(a.x) & 15) == 0;
      auto stage_halo = [&](int gc) {
        const int ch = gc % nch;
        if (g >= 2 * steps(ch)) return;
        const Tile tl = tile_at(gc / nch);
        const int cc = ch * KC + 4 * g;
        const float* xn = x + (size_t)tl.n * a.h_in * a.w_in * a.c;
        unsigned char* dst = As + (gc % NA) * A_BYTES + g * HP * 16;
        for (int p = p0; p < HP; p += 12) {
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
          const float* src = xn + ((size_t)iy * a.w_in + ix) * a.c + cc;
          if (vec) {
            ok = ok && cc < a.c;
            wg::cp_async16(wg::smem_u32(dst + p * 16), ok ? src : xn, ok);
          } else {
            float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
            float* f = &v.x;
#pragma unroll
            for (int i = 0; i < 4; ++i)
              if (ok && cc + i < a.c) f[i] = src[i];
            *reinterpret_cast<float4*>(dst + p * 16) = v;
          }
        }
      };
      // (PROLOGUE: relu((v - mean) * scale + beta), float32, no FMA
      // contraction: the plain version's roundings) then the split, big
      // in place and small in the second plane.  Channels past C stay 0.
      auto split = [&](int gc) {
        const int ch = gc % nch;
        if (g >= 2 * steps(ch)) return;
        const int cc = ch * KC + 4 * g;
        float mean[4], scale[4], beta[4];
        if (PROLOGUE) {
          const int n = tile_at(gc / nch).n;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const bool in = cc + i < a.c;
            mean[i] = in ? __ldg(a.pro_mean + n * a.c + cc + i) : 0.f;
            scale[i] = in ? __ldg(a.pro_scale + n * a.c + cc + i) : 0.f;
            beta[i] = in ? __ldg(a.pro_beta + cc + i) : 0.f;
          }
        }
        uint4* big = reinterpret_cast<uint4*>(As + (gc % NA) * A_BYTES +
                                              g * HP * 16);
        uint4* small = big + A_PART / 16;
        for (int p = p0; p < HP; p += 12) {
          float4 v = *reinterpret_cast<const float4*>(big + p);
          float* f = &v.x;
          if (PROLOGUE) {
#pragma unroll
            for (int i = 0; i < 4; ++i)
              if (cc + i < a.c)
                f[i] = fmaxf(__fadd_rn(__fmul_rn(__fsub_rn(f[i], mean[i]),
                                                 scale[i]), beta[i]), 0.f);
          }
          uint4 hb, hs;
          wg::tf32_split(f[0], &hb.x, &hs.x);
          wg::tf32_split(f[1], &hb.y, &hs.y);
          wg::tf32_split(f[2], &hb.z, &hs.z);
          wg::tf32_split(f[3], &hb.w, &hs.w);
          big[p] = hb;
          small[p] = hs;
        }
      };
#pragma unroll
      for (int k = 0; k < NA - 1; ++k) {
        if (k < chunks) stage_halo(k);   // the buffers start empty
        wg::cp_async_commit();
      }
      for (int gc = 0; gc < chunks; ++gc) {
        wg::cp_async_wait<NA - 2>();   // chunk gc has landed (this thread's part)
        split(gc);
        wg::fence_async_shared();
        __syncwarp();
        if (lane == 0) wg::mbar_arrive(a_full + 8 * (gc % NA));
        const int next = gc + NA - 1;   // into chunk gc - 1's buffer
        if (next < chunks) {
          wg::mbar_wait(a_empty + 8 * (next % NA), ((next / NA) & 1) ^ 1);
          stage_halo(next);
        }
        wg::cp_async_commit();
      }
    }
  } else {
    // ---------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wgi = warp >> 2, wl = warp & 3;
    const bool pair = (a.co & 1) == 0;   // float2 stores stay aligned
    int gs = 0, gc = 0;
    for (int i = 0; i < my_tiles; ++i) {
      const Tile tl = tile_at(i);
      float acc[N / 2];
#pragma unroll
      for (int k = 0; k < N / 2; ++k) acc[k] = 0.f;
      for (int s = 0; s < stages; ++s, ++gs) {
        const int ch = s / 9, tap = s - 9 * (s / 9), slot = gs % NB;
        const int buf = (gc + ch) % NA;
        if (tap == 0) wg::mbar_wait(a_full + 8 * buf, ((gc + ch) / NA) & 1);
        wg::mbar_wait(b_full + 8 * slot, (gs / NB) & 1);
        const int dy = tap / 3, dx = tap - 3 * (tap / 3);
        const unsigned a0 = wg::smem_u32(As + buf * A_BYTES) +
                            (dy * HW + wgi * 8 + dx) * 16;
        const unsigned b0 = wg::smem_u32(Bs + slot * B_BYTES);
        const int nks = steps(ch);
        // A: k8 step = two 4-channel groups (leading byte offset: a group
        // plane), 8-row groups one halo row apart.  B: 128-byte swizzled
        // K-major rows of 32 floats, a k8 step 32 bytes along the row.
        auto da = [&](int ks, int part) {
          return wg::desc(a0 + part * A_PART + ks * 2 * HP * 16, HP * 16,
                          HW * 16, 0);
        };
        auto db = [&](int ks, int part) {
          return wg::desc(b0 + part * B_PART + ks * 32, 16, 1024, 1);
        };
        float part[N / 2];
        wg::fence_acc(part);
        wg::wgmma_fence();
        for (int ks = 0; ks < nks; ++ks) {   // small parts first
          wg::wgmma_tf32n<N>(part, da(ks, 1), db(ks, 0), ks > 0);
          wg::wgmma_tf32n<N>(part, da(ks, 0), db(ks, 1));
        }
        for (int ks = 0; ks < nks; ++ks)
          wg::wgmma_tf32n<N>(part, da(ks, 0), db(ks, 0));
        wg::wgmma_commit();
        wg::wgmma_wait<0>();
        wg::fence_acc(part);
#pragma unroll
        for (int k = 0; k < N / 2; ++k) acc[k] += part[k];
        if (lane == 0) {   // release the stage (and, after tap 8, the halo)
          wg::mbar_arrive(b_empty + 8 * slot);
          if (tap == 8) wg::mbar_arrive(a_empty + 8 * buf);
        }
      }
      gc += nch;

      // Epilogue.  acc[4j + 2h + t]: GEMM row 16*wl + lane/4 + 8h of this
      // warpgroup = tile row 2*wl + h, tile column 8*wgi + lane/4; channel
      // 8j + 2*(lane%4) + t.  The first barrier waits for the previous
      // tile's reads of the per-warp sums.
      if (STATS) asm volatile("bar.sync 1, %0;\n" :: "n"(NCONS) : "memory");
      const int oy = tl.oy0 + 2 * wl, ox = tl.ox0 + 8 * wgi + (lane >> 2);
      const bool in0 = oy < a.h_out && ox < a.w_out;
      const bool in1 = oy + 1 < a.h_out && ox < a.w_out;
      float* y0 = static_cast<float*>(a.y) +
                  (((size_t)tl.n * a.h_out + oy) * a.w_out + ox) * a.co;
      float* y1 = y0 + (size_t)a.w_out * a.co;
      const float* bias = static_cast<const float*>(a.bias);
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        const int col = 8 * j + 2 * (lane & 3), o = tl.co0 + col;
        const float b0 = STATS && o < a.co ? __ldg(bias + o) : 0.f;
        const float b1 = STATS && o + 1 < a.co ? __ldg(bias + o + 1) : 0.f;
        const float y00 = acc[4 * j] + b0, y01 = acc[4 * j + 1] + b1;
        const float y10 = acc[4 * j + 2] + b0, y11 = acc[4 * j + 3] + b1;
        if (in0) store_pair(y0 + o, o, a.co, pair, y00, y01);
        if (in1) store_pair(y1 + o, o, a.co, pair, y10, y11);
        if (STATS) {
          const float s0 = (in0 ? y00 : 0.f) + (in1 ? y10 : 0.f);
          const float s1 = (in0 ? y01 : 0.f) + (in1 ? y11 : 0.f);
          const float q0 = (in0 ? y00 * y00 : 0.f) + (in1 ? y10 * y10 : 0.f);
          const float q1 = (in0 ? y01 * y01 : 0.f) + (in1 ? y11 * y11 : 0.f);
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
      if (STATS) {
        asm volatile("bar.sync 1, %0;\n" :: "n"(NCONS) : "memory");
        if (tid < N && tl.co0 + tid < a.co) {
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
}

// The split weights (2 parts x 9 taps planes of Co rows x Cp floats),
// read in boxes of 32 floats x n_tile rows with the 128-byte swizzle;
// whatever lies past Cp or Co arrives as zeros.
inline cudaError_t weight_map(CUtensorMap* map, const float* wsplit, int c,
                              int co, int n_tile) {
  wg::EncodeTiled enc = wg::encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  const int cp = (c + 3) / 4 * 4;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cp),
                              static_cast<cuuint64_t>(co), 18};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cp) * 4,
                                 static_cast<cuuint64_t>(co) * cp * 4};
  const cuuint32_t box[3] = {KC, static_cast<cuuint32_t>(n_tile), 1};
  const cuuint32_t estride[3] = {1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                         const_cast<float*>(wsplit), dims, strides, box,
                         estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Calls f(std::integral_constant<int, N>) with N = pick_n(co).
template <class F>
cudaError_t with_tile(int co, F&& f) {
  switch (pick_n(co)) {
    case 32: return f(std::integral_constant<int, 32>{});
    case 48: return f(std::integral_constant<int, 48>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 96: return f(std::integral_constant<int, 96>{});
    case 128: return f(std::integral_constant<int, 128>{});
    default: return f(std::integral_constant<int, 192>{});
  }
}

// The weights' pre-pass into wsplit (weight_floats(C, Co) floats), then
// conv3x3_tf32: one block per SM (at most one per tile), each walking its
// tiles.
template <bool REFLECT, bool PROLOGUE, bool STATS>
cudaError_t launch(const ConvArgs& a, float* wsplit, int n, cudaStream_t s) {
  const int cp = (a.c + 3) / 4 * 4;
  const attn::SplitJob job{static_cast<const float*>(a.w),
                           static_cast<long long>(a.c) * a.co, a.c, a.co,
                           wsplit, a.co, cp, 9, 2};
  attn::split_tf32<<<dim3((cp + 31) / 32, (a.co + 31) / 32, 9), dim3(32, 8),
                     0, s>>>(job);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return with_tile(a.co, [&](auto tile) {
    constexpr int N = decltype(tile)::value;
    auto kernel = conv3x3_tf32<REFLECT, PROLOGUE, STATS, N>;
    static std::atomic<const void*> cache[wg::kMaxDevices];
    int sms = 0;
    cudaError_t e = wg::ready(kernel, cache, &sms);
    if (e != cudaSuccess) return e;
    CUtensorMap map;
    e = weight_map(&map, wsplit, a.c, a.co, N);
    if (e != cudaSuccess) return e;
    const int total = n * wg::tiles(a.h_out, a.w_out) * ((a.co + N - 1) / N);
    kernel<<<total < sms ? total : sms, NTH, smem_bytes(N, STATS), s>>>(a, map,
                                                                        n);
    return cudaGetLastError();
  });
}

// What launch() would run for (C, Co): out = {tile N, dynamic shared
// memory bytes, resident blocks per SM}.
template <bool REFLECT, bool PROLOGUE, bool STATS>
cudaError_t config(int co, int* out) {
  return with_tile(co, [&](auto tile) {
    constexpr int N = decltype(tile)::value;
    auto kernel = conv3x3_tf32<REFLECT, PROLOGUE, STATS, N>;
    static std::atomic<const void*> cache[wg::kMaxDevices];
    int sms = 0;
    cudaError_t err = wg::ready(kernel, cache, &sms);
    if (err != cudaSuccess) return err;
    out[0] = N;
    out[1] = smem_bytes(N, STATS);
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], kernel, NTH,
                                                         out[1]);
  });
}

}  // namespace tf
}  // namespace vst
