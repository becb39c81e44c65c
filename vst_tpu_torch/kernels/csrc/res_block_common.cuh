// What K1's two entry points share: the reflect-mode launch of res_block.cu
// (vst_k1_conv3x3_in_stats) and the halo-rows mode of res_block_halo.cu
// (vst_k1_conv3x3_in_stats_halo).  Each translation unit instantiates only
// its own REFLECT flag, so nvcc builds the two in parallel.
//
// k1_run: the prologue's parameters (one small launch), the conv body with
// STATS, then one reduction of the per-tile partial sums in a fixed order:
// the (mean, biased var) over h_out * w_out in reflect mode, the raw sums
// Σy and Σy² in halo mode (a row shard's statistics are only part of the
// frame's: the caller all-reduces the sums and divides once).
//
// Include conv3x3_tf32.cuh (the bodies) before this header: the sources
// include it themselves, so that a variant's copy of the body beside a copy
// of a source (experiments/conv_f32_variants.py) is the one they build.
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
  return bf16 ? wg::launch<REFLECT, PRO, true>(a, n, s)
              : tf::launch<REFLECT, PRO, true>(a, wsplit, n, s);
}

// One K1 launch: x is (n, h_in, w_in, c), y (n, h, wd, co); h_in = h and
// w_in = wd in reflect mode, h + 2 and wd + 2 in halo mode.  stats gets the
// (mean, var) in reflect mode and the sums in halo mode, (n, 2, co).
template <bool REFLECT>
int k1_run(const void* x, const void* w, const void* b, const void* stats_in,
           const void* gamma, const void* beta, int gb_bf16, void* pro,
           void* wsplit, void* y, void* partial, void* stats, int n, int h,
           int wd, int c, int co, int bf16, void* stream) {
  float* mean = stats_in != nullptr ? static_cast<float*>(pro) : nullptr;
  float* scale = mean != nullptr ? mean + (size_t)n * c : nullptr;
  float* beta_f = mean != nullptr ? scale + (size_t)n * c : nullptr;
  const int halo = REFLECT ? 0 : 2;
  ConvArgs a{x, w, b, mean, scale, beta_f,
             y, static_cast<float*>(partial), h + halo, wd + halo, h, wd, c, co};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stats_in != nullptr) {
    prologue_params<<<(n * c + 255) / 256, 256, 0, s>>>(
        static_cast<const float*>(stats_in), gamma, beta, gb_bf16, mean,
        scale, beta_f, n, c);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  float* ws = static_cast<float*>(wsplit);
  const cudaError_t err = stats_in != nullptr
                              ? launch<REFLECT, true>(a, ws, n, bf16 != 0, s)
                              : launch<REFLECT, false>(a, ws, n, bf16 != 0, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  finalize_stats<!REFLECT><<<dim3((co + 127) / 128, n), 128, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(stats),
      wg::tiles(h, wd), co, static_cast<float>(h * wd));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace vst
