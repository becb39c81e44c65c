// conv3x3_tf32_narrow: the float32 body of K1 (res_block.cu,
// res_block_halo.cu) at narrow residual widths, C <= 64 and Co <= 64
// (RTNSTV's 48 channels, SD1/SD2's 64): conv3x3_tf32.cuh's 3xTF32 conv with
// STATS, on tiles twice as tall.
//
// What held conv3x3_tf32 at these widths (experiments/
// k1_f32_narrow_variants.py, PERF.md): not its products.  Without any
// product its launch keeps 58% of its time at 48 channels and 53% at 64;
// it loses 1-5% without its halo loads or its split.  What is left is
// per tile and per stage: each of its 8 x 16-pixel tiles
// runs 18 (chunk, tap) stages, each waited for, added and released, and
// an epilogue that no product overlaps.  Letting a stage's products run
// while the next stage is issued (two partial sets, wgmma_wait<1>), one
// stage per tap over all C, splitting a stage into more independent
// chains, or four halo warps with the weights fed by a consumer thread
// did not make it faster (ptxas serialized the products of the two-set
// form).
//
// So this body halves the stages and tiles per pixel:
// - 16 x 16-pixel tiles: each consumer warpgroup owns two 64-row GEMM
//   blocks (8 rows x 8 columns each) and one fresh partial per block and
//   stage, so each (chunk, tap) stage, its handshakes and its weights feed
//   256 pixels, and each epilogue 256; the 18 x 18 halo of a 32-channel
//   chunk in both parts is 82,944 bytes, two buffers;
// - the rest is conv3x3_tf32's: C in 32-channel chunks, and in each the
//   nine taps, every (chunk, tap) stage in a fresh partial of the 3xTF32
//   products (small terms first) added in float32; the halo staged by
//   three producer warps (threads spread over a partial chunk's groups)
//   and split in shared memory by the threads that staged it; the weights
//   split by a pre-pass (split_tf32) and loaded by TMA in 128-byte-swizzled
//   boxes, a ring of as many stages as fit;
// - the prologue's per-(image, channel) mean and scale = gamma * rsqrt(var
//   + eps) are derived by the halo threads from the previous conv's
//   statistics, as in the narrow bf16 body (conv3x3_wgmma.cuh), so a call
//   is three launches (split_tf32, the conv, finalize_stats) where
//   conv3x3_tf32 takes four;
// - one partial sum per 16 x 16 tile for finalize_stats, half as many.
//
// Include conv3x3_tf32.cuh (tf::) before this header: the sources include
// it themselves, so that a variant's copy of the wide body beside a copy of
// a source (experiments/) is the one they build.
#pragma once

namespace vst {
namespace tn {

using tf::KC;
using wg::HW;
using wg::NCONS;
using wg::NTH;
using wg::TW;

constexpr int MT = 2;                         // 64-row GEMM blocks a consumer
constexpr int TH = 8 * MT;                    // output tile rows
constexpr int HP = (TH + 2) * HW;             // halo pixels: 324
constexpr int A_PART = (KC / 4) * HP * 16;    // one part of a staged chunk
constexpr int A_BYTES = 2 * A_PART;           // 82,944 B
constexpr int NA = 2;                         // halo buffers
constexpr int SMEM_MAX = 232448;              // a block's opt-in shared memory

// K1 calls that take this body: C and Co <= 64 (one output-channel tile
// of 32, 48 or 64).
inline bool k1_narrow(int c, int co) { return c <= 64 && co <= 64; }

// Partial-sum blocks per (h, w) image: one per tile.
inline int k1_blocks(int h, int w) { return wg::tiles(h, w, MT); }

// Weight stages (2 x N x 128 bytes each) that fit beside the halos, the
// per-warp sums and the mbarriers: 5 at N = 48, 3 at N = 64.
__host__ __device__ constexpr int ring_b(int n) {
  return (SMEM_MAX - 1024 - NA * A_BYTES - 16 * n * 4 - 256) / (2 * n * KC * 4);
}

inline int smem_bytes(int n) {
  return 1024 + ring_b(n) * 2 * n * KC * 4 + NA * A_BYTES + 16 * n * 4 +
         2 * (ring_b(n) + NA) * 8;
}

template <bool REFLECT, bool PROLOGUE, int N>
__global__ void __launch_bounds__(NTH, 1)
    conv3x3_tf32_narrow(ConvArgs a, const __grid_constant__ CUtensorMap wmap,
                        int images) {
  extern __shared__ unsigned char smem_raw[];
  constexpr int NB = ring_b(N);
  constexpr int B_PART = N * KC * 4;        // one part of a weight stage
  constexpr int B_BYTES = 2 * B_PART;
  // [NB] weight stages (big | small) | [NA] halos (big | small) |
  // red [8][2][N] | mbarriers
  unsigned char* smem =
      smem_raw + ((1024 - (wg::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* Bs = smem;
  unsigned char* As = Bs + NB * B_BYTES;
  float* red = reinterpret_cast<float*>(As + NA * A_BYTES);
  uint64_t* bars = reinterpret_cast<uint64_t*>(red + 16 * N);
  const unsigned b_full = wg::smem_u32(bars), b_empty = b_full + NB * 8;
  const unsigned a_full = b_empty + NB * 8, a_empty = a_full + NA * 8;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tiles_x = (a.w_out + TW - 1) / TW;
  const int tiles_pix = wg::tiles(a.h_out, a.w_out, MT);
  const int total = images * tiles_pix;
  const int my_tiles = total > static_cast<int>(blockIdx.x)
      ? (total - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
  struct Tile { int n, pt, oy0, ox0; };
  auto tile_at = [&](int i) {
    const int t = blockIdx.x + i * gridDim.x;
    Tile r;
    r.pt = t % tiles_pix;
    r.n = t / tiles_pix;
    r.oy0 = (r.pt / tiles_x) * TH;
    r.ox0 = (r.pt % tiles_x) * TW;
    return r;
  };
  const int nch = (a.c + KC - 1) / KC;      // 1 or 2
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
        const int all = my_tiles * stages;
        for (int gs = 0; gs < all; ++gs) {
          const int s = gs % stages, ch = s / 9, tap = s - 9 * ch;
          const int slot = gs % NB;
          wg::mbar_wait(b_empty + 8 * slot, ((gs / NB) & 1) ^ 1);
          wg::mbar_expect_tx(b_full + 8 * slot, B_BYTES);
          const unsigned dst = wg::smem_u32(Bs + slot * B_BYTES);
          wg::tma_load_3d(dst, &wmap, ch * KC, 0, tap, b_full + 8 * slot);
          wg::tma_load_3d(dst + B_PART, &wmap, ch * KC, 0, 9 + tap,
                          b_full + 8 * slot);
        }
      }
    } else {
      // The halos, NA - 1 chunks ahead, by the other three warps.  Of a
      // chunk's G 4-channel groups (8 for 32 channels), thread t keeps
      // group t % G and walks every (96 / G)-th halo pixel from t / G; G
      // neighbouring threads read one pixel's 16 G bytes.
      const int t = tid - NCONS - 32;          // 0..95
      const int chunks = my_tiles * nch;
      const float* x = static_cast<const float*>(a.x);
      const bool vec = (a.c & 3) == 0 &&
                       (reinterpret_cast<uintptr_t>(a.x) & 15) == 0;
      auto stage_halo = [&](int gc) {
        const int ch = gc % nch, ng = 2 * steps(ch), pstep = 96 / ng;
        const int g = t % ng, p0 = t / ng;
        const Tile tl = tile_at(gc / nch);
        const int cc = ch * KC + 4 * g;
        const float* xn = x + (size_t)tl.n * a.h_in * a.w_in * a.c;
        unsigned char* dst = As + (gc % NA) * A_BYTES + g * HP * 16;
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
        const int ch = gc % nch, ng = 2 * steps(ch), pstep = 96 / ng;
        const int g = t % ng, p0 = t / ng;
        const int cc = ch * KC + 4 * g;
        float mean[4], scale[4], beta[4];
        if (PROLOGUE) {
          // prologue_params' arithmetic, here: scale = gamma * rsqrt(var +
          // eps) from the previous conv's (mean, var) of this image
          const float* st =
              a.stats_in + (size_t)tile_at(gc / nch).n * 2 * a.c;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int o = cc + i < a.c ? cc + i : 0;
            const float gm =
                a.gb_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(a.gamma)[o])
                          : static_cast<const float*>(a.gamma)[o];
            beta[i] = a.gb_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(a.beta)[o])
                                : static_cast<const float*>(a.beta)[o];
            mean[i] = __ldg(st + o);
            scale[i] = __fmul_rn(gm, rsqrtf(__fadd_rn(__ldg(st + a.c + o), 1e-5f)));
          }
        }
        uint4* big = reinterpret_cast<uint4*>(As + (gc % NA) * A_BYTES +
                                              g * HP * 16);
        uint4* small = big + A_PART / 16;
        for (int p = p0; p < HP; p += pstep) {
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
    float acc[MT][N / 2];
#pragma unroll
    for (int mb = 0; mb < MT; ++mb)
#pragma unroll
      for (int k = 0; k < N / 2; ++k) acc[mb][k] = 0.f;

    // Epilogue of tile i.  acc[mb][4j + 2h + t]: GEMM row 16*wl + lane/4 +
    // 8h of block mb of this warpgroup = tile row 8mb + 2*wl + h, tile
    // column 8*wgi + lane/4; channel 8j + 2*(lane%4) + t.  The first
    // barrier waits for the previous tile's reads of the per-warp sums.
    auto epilogue = [&](int i) {
      const Tile tl = tile_at(i);
      asm volatile("bar.sync 1, %0;\n" :: "n"(NCONS) : "memory");
      const int ox = tl.ox0 + 8 * wgi + (lane >> 2);
      const float* bias = static_cast<const float*>(a.bias);
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        const int o = 8 * j + 2 * (lane & 3);
        const float b0 = o < a.co ? __ldg(bias + o) : 0.f;
        const float b1 = o + 1 < a.co ? __ldg(bias + o + 1) : 0.f;
        float s0 = 0.f, s1 = 0.f, q0 = 0.f, q1 = 0.f;
#pragma unroll
        for (int mb = 0; mb < MT; ++mb) {
          const int oy = tl.oy0 + 8 * mb + 2 * wl;
          const bool in0 = oy < a.h_out && ox < a.w_out;
          const bool in1 = oy + 1 < a.h_out && ox < a.w_out;
          float* y0 = static_cast<float*>(a.y) +
                      (((size_t)tl.n * a.h_out + oy) * a.w_out + ox) * a.co;
          float* y1 = y0 + (size_t)a.w_out * a.co;
          const float y00 = acc[mb][4 * j] + b0, y01 = acc[mb][4 * j + 1] + b1;
          const float y10 = acc[mb][4 * j + 2] + b0, y11 = acc[mb][4 * j + 3] + b1;
          if (in0) tf::store_pair(y0 + o, o, a.co, pair, y00, y01);
          if (in1) tf::store_pair(y1 + o, o, a.co, pair, y10, y11);
          s0 += (in0 ? y00 : 0.f) + (in1 ? y10 : 0.f);
          s1 += (in0 ? y01 : 0.f) + (in1 ? y11 : 0.f);
          q0 += (in0 ? y00 * y00 : 0.f) + (in1 ? y10 * y10 : 0.f);
          q1 += (in0 ? y01 * y01 : 0.f) + (in1 ? y11 * y11 : 0.f);
        }
        // Sum the four values over the 8 rows of the warp (lane bits 2..4)
        // in 4 shuffles: lane bit 4 keeps y or y*y, bit 3 the even or odd
        // channel, and the halves travel.
        const bool hi = lane & 16, odd = lane & 8;
        const float k0 = (hi ? q0 : s0) + __shfl_xor_sync(0xffffffffu, hi ? s0 : q0, 16);
        const float k1 = (hi ? q1 : s1) + __shfl_xor_sync(0xffffffffu, hi ? s1 : q1, 16);
        float v = (odd ? k1 : k0) + __shfl_xor_sync(0xffffffffu, odd ? k0 : k1, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        if (!(lane & 4)) red[(warp * 2 + hi) * N + o + odd] = v;
      }
      asm volatile("bar.sync 1, %0;\n" :: "n"(NCONS) : "memory");
      if (tid < N && tid < a.co) {
        float t1 = 0.f, t2 = 0.f;
        for (int r = 0; r < 8; ++r) {
          t1 += red[(r * 2) * N + tid];
          t2 += red[(r * 2 + 1) * N + tid];
        }
        float* pb = a.partial + ((size_t)tl.n * tiles_pix + tl.pt) * 2 * a.co;
        pb[tid] = t1;
        pb[a.co + tid] = t2;
      }
#pragma unroll
      for (int mb = 0; mb < MT; ++mb)
#pragma unroll
        for (int k = 0; k < N / 2; ++k) acc[mb][k] = 0.f;
    };

    int gs = 0, gc = 0;
    for (int i = 0; i < my_tiles; ++i) {
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
        // plane), 8-row groups one halo row apart, block mb 8 halo rows
        // down.  B: 128-byte swizzled K-major rows of 32 floats, a k8 step
        // 32 bytes along the row.
        auto da = [&](int mb, int ks, int p) {
          return wg::desc(a0 + p * A_PART + (mb * 8 * HW + ks * 2 * HP) * 16,
                          HP * 16, HW * 16, 0);
        };
        auto db = [&](int ks, int p) {
          return wg::desc(b0 + p * B_PART + ks * 32, 16, 1024, 1);
        };
        float part[MT][N / 2];
#pragma unroll
        for (int mb = 0; mb < MT; ++mb) wg::fence_acc(part[mb]);
        wg::wgmma_fence();
        for (int ks = 0; ks < nks; ++ks) {   // small parts first
#pragma unroll
          for (int mb = 0; mb < MT; ++mb) {
            wg::wgmma_tf32n<N>(part[mb], da(mb, ks, 1), db(ks, 0), ks > 0);
            wg::wgmma_tf32n<N>(part[mb], da(mb, ks, 0), db(ks, 1));
          }
        }
        for (int ks = 0; ks < nks; ++ks)
#pragma unroll
          for (int mb = 0; mb < MT; ++mb)
            wg::wgmma_tf32n<N>(part[mb], da(mb, ks, 0), db(ks, 0));
        wg::wgmma_commit();
        wg::wgmma_wait<0>();
#pragma unroll
        for (int mb = 0; mb < MT; ++mb) {
          wg::fence_acc(part[mb]);
#pragma unroll
          for (int k = 0; k < N / 2; ++k) acc[mb][k] += part[mb][k];
        }
        if (lane == 0) {   // release the stage (and, after tap 8, the halo)
          wg::mbar_arrive(b_empty + 8 * slot);
          if (tap == 8) wg::mbar_arrive(a_empty + 8 * buf);
        }
      }
      gc += nch;
      epilogue(i);
    }
  }
}

// Calls f(std::integral_constant<int, N>) with N = tf::pick_n(co) (32, 48
// or 64 for Co <= 64).
template <class F>
cudaError_t with_tile(int co, F&& f) {
  switch (tf::pick_n(co)) {
    case 32: return f(std::integral_constant<int, 32>{});
    case 48: return f(std::integral_constant<int, 48>{});
    default: return f(std::integral_constant<int, 64>{});
  }
}

// The weights' pre-pass into wsplit (tf::weight_floats(C, Co) floats, the
// layout of conv3x3_tf32), then conv3x3_tf32_narrow: one block per SM (at
// most one per tile), each walking its tiles.  The prologue's parameters
// come from a.stats_in, a.gamma and a.beta.
template <bool REFLECT, bool PROLOGUE>
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
    auto kernel = conv3x3_tf32_narrow<REFLECT, PROLOGUE, N>;
    static std::atomic<const void*> cache[wg::kMaxDevices];
    int sms = 0;
    cudaError_t e = wg::ready(kernel, cache, &sms);
    if (e != cudaSuccess) return e;
    CUtensorMap map;
    e = tf::weight_map(&map, wsplit, a.c, a.co, N);
    if (e != cudaSuccess) return e;
    const int total = n * wg::tiles(a.h_out, a.w_out, MT);
    kernel<<<total < sms ? total : sms, NTH, smem_bytes(N), s>>>(a, map, n);
    return cudaGetLastError();
  });
}

// What launch() would run for Co: out = {tile N, dynamic shared memory
// bytes, resident blocks per SM}.
template <bool REFLECT, bool PROLOGUE>
cudaError_t config(int co, int* out) {
  return with_tile(co, [&](auto tile) {
    constexpr int N = decltype(tile)::value;
    auto kernel = conv3x3_tf32_narrow<REFLECT, PROLOGUE, N>;
    static std::atomic<const void*> cache[wg::kMaxDevices];
    int sms = 0;
    cudaError_t err = wg::ready(kernel, cache, &sms);
    if (err != cudaSuccess) return err;
    out[0] = N;
    out[1] = smem_bytes(N);
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], kernel, NTH,
                                                         out[1]);
  });
}

}  // namespace tn
}  // namespace vst
