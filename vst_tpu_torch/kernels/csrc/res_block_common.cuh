// What K1's two entry points share: the reflect-mode launch of res_block.cu
// (vst_k1_conv3x3_in_stats) and the halo-rows mode of res_block_halo.cu
// (vst_k1_conv3x3_in_stats_halo).  Each translation unit instantiates only
// its own REFLECT flag, so nvcc builds the two in parallel.
//
// k1_run: the prologue's parameters (one small launch), the conv body with
// STATS, then one reduction of the per-tile partial sums in a fixed order:
// the (mean, biased var) over h_out * w_out in reflect mode, the raw sums
// Σy and Σy² in halo mode (a row shard's statistics are only part of the
// frame's: the caller all-reduces the sums and divides once).  The narrow
// bodies (C, Co <= 64) derive the prologue's parameters inside the conv:
// bf16 (conv3x3_wgmma.cuh) in two launches, float32
// (conv3x3_tf32_narrow.cuh) in three with its weights' pre-pass.
//
// Include conv3x3_tf32.cuh and conv3x3_tf32_narrow.cuh (the bodies) before
// this header: the sources include them themselves, so that a variant's
// copy of a body beside a copy of a source (experiments/conv_f32_variants.py,
// k1_f32_narrow_variants.py) is the one they build.
#pragma once

namespace vst {

template <bool SUMS>
__global__ void finalize_stats(const float* __restrict__ partial,
                               float* __restrict__ stats, int nblk, int co,
                               float hw) {
  const int n = blockIdx.y;
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= co) return;
  float s = 0.f, s2 = 0.f;
  for (int b = 0; b < nblk; ++b) {
    const float* pb = partial + ((size_t)n * nblk + b) * 2 * co;
    s += pb[o];
    s2 += pb[co + o];
  }
  if (SUMS) {
    stats[(size_t)n * 2 * co + o] = s;
    stats[(size_t)n * 2 * co + co + o] = s2;
    return;
  }
  const float mean = s / hw;
  stats[(size_t)n * 2 * co + o] = mean;
  stats[(size_t)n * 2 * co + co + o] = __fsub_rn(s2 / hw, __fmul_rn(mean, mean));
}

// The prologue's per-image mean and scale = gamma * rsqrt(var + eps) and
// beta, as float32 arrays, from the previous conv's (N, 2, C) statistics
// and gamma, beta (float32, or bf16 when gb_bf16): the arithmetic of the
// plain version's _prologue, in one launch.
__global__ void prologue_params(const float* __restrict__ stats_in,
                                const void* gamma, const void* beta,
                                int gb_bf16, float* __restrict__ mean,
                                float* __restrict__ scale,
                                float* __restrict__ beta_out, int n, int c) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n * c) return;
  const int img = i / c, ch = i - (i / c) * c;
  const float g = gb_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(gamma)[ch])
                          : static_cast<const float*>(gamma)[ch];
  mean[i] = stats_in[(size_t)img * 2 * c + ch];
  scale[i] = __fmul_rn(g, rsqrtf(__fadd_rn(stats_in[(size_t)img * 2 * c + c + ch], 1e-5f)));
  if (img == 0)
    beta_out[ch] = gb_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(beta)[ch])
                           : static_cast<const float*>(beta)[ch];
}

template <bool REFLECT, bool PRO>
cudaError_t launch(const ConvArgs& a, float* wsplit, int n, bool bf16,
                   cudaStream_t s) {
  if (bf16) return wg::launch<REFLECT, PRO, true>(a, n, s);
  return tn::k1_narrow(a.c, a.co) ? tn::launch<REFLECT, PRO>(a, wsplit, n, s)
                                  : tf::launch<REFLECT, PRO, true>(a, wsplit, n, s);
}

// Partial-sum blocks per image that K1 writes for an (h, wd) image: one per
// 8 x 16 tile, or per 16 x 16 tile in the narrow bodies (C, Co <= 64).
inline int k1_blocks(int h, int wd, int c, int co, bool bf16) {
  if (bf16) return wg::k1_tiles(h, wd, c, co);
  return tn::k1_narrow(c, co) ? tn::k1_blocks(h, wd) : wg::tiles(h, wd);
}

// K1's float32 workspace, which the wrapper keeps per device and stream and
// reuses call after call (one stream's launches run in order), in parts
// that start on 16 floats: the partial sums (n, k1_blocks, 2, co), the
// prologue's mean and scale (n, c) and beta (c) for prologue_params, and
// the float32 body's split weights (tf::weight_floats).
struct K1Work {
  long long pro, wsplit, total;
};
inline K1Work k1_work(int n, int h, int wd, int c, int co, bool bf16,
                      bool prologue) {
  auto part = [](long long floats) { return (floats + 15) / 16 * 16; };
  K1Work p;
  p.pro = part(2LL * n * k1_blocks(h, wd, c, co, bf16) * co);
  p.wsplit = p.pro + (prologue ? part(2LL * n * c + c) : 0);
  p.total = p.wsplit + (bf16 ? 0 : part(tf::weight_floats(c, co)));
  return p;
}

// One K1 call: x is (n, h_in, w_in, c), y (n, h, wd, co); h_in = h and
// w_in = wd in reflect mode, h + 2 and wd + 2 in halo mode.  stats gets
// the (mean, var) in reflect mode and the sums in halo mode, (n, 2, co).
// work: k1_work(...).total floats.  On the current device.
template <bool REFLECT>
int k1_launches(const void* x, const void* w, const void* b,
                const void* stats_in, const void* gamma, const void* beta,
                int gb_bf16, void* y, void* stats, void* work, int n, int h,
                int wd, int c, int co, int bf16, cudaStream_t s) {
  const K1Work parts =
      k1_work(n, h, wd, c, co, bf16 != 0, stats_in != nullptr);
  float* partial = static_cast<float*>(work);
  const int halo = REFLECT ? 0 : 2;
  ConvArgs a{x, w, b, nullptr, nullptr, nullptr,
             y, partial, h + halo, wd + halo, h, wd, c, co};
  if (stats_in != nullptr &&
      (bf16 ? wg::k1_narrow(c, co) : tn::k1_narrow(c, co))) {
    a.stats_in = static_cast<const float*>(stats_in);
    a.gamma = gamma;
    a.beta = beta;
    a.gb_bf16 = gb_bf16;
  } else if (stats_in != nullptr) {
    float* mean = partial + parts.pro;
    a.pro_mean = mean;
    a.pro_scale = mean + (size_t)n * c;
    a.pro_beta = mean + 2 * (size_t)n * c;
    prologue_params<<<(n * c + 255) / 256, 256, 0, s>>>(
        static_cast<const float*>(stats_in), gamma, beta, gb_bf16, mean,
        mean + (size_t)n * c, mean + 2 * (size_t)n * c, n, c);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  float* ws = partial + parts.wsplit;
  const cudaError_t err = stats_in != nullptr
                              ? launch<REFLECT, true>(a, ws, n, bf16 != 0, s)
                              : launch<REFLECT, false>(a, ws, n, bf16 != 0, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  finalize_stats<!REFLECT><<<dim3((co + 127) / 128, n), 128, 0, s>>>(
      partial, static_cast<float*>(stats),
      k1_blocks(h, wd, c, co, bf16 != 0),
      co, static_cast<float>(h * wd));
  return static_cast<int>(cudaGetLastError());
}

// k1_launches on ``device`` (the tensors' card), whose current stream is
// ``stream``: the wrapper passes the device instead of making it current
// itself, which costs more host time a call.
template <bool REFLECT>
int k1_run(const void* x, const void* w, const void* b, const void* stats_in,
           const void* gamma, const void* beta, int gb_bf16, void* y,
           void* stats, void* work, int n, int h, int wd, int c, int co,
           int bf16, int device, void* stream) {
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rc = k1_launches<REFLECT>(x, w, b, stats_in, gamma, beta, gb_bf16,
                                      y, stats, work, n, h, wd, c, co, bf16,
                                      static_cast<cudaStream_t>(stream));
  if (current != device) cudaSetDevice(current);
  return rc;
}

}  // namespace vst
