// K1's halo-rows mode: the conv of res_block.cu over one row shard of an
// H-sharded frame, whose neighbours' rows come from outside the kernel.
//
// Replaces, for the spatially sharded serving path, what XLA's SPMD
// partitioner does around the Pallas TPU kernel vst_tpu/kernels/
// res_block.py (_conv_stats_kernel) when H is sharded: the reflect-mode
// kernel resolves its halo by index (reflect1), so an interior shard's
// first and last rows would reflect rows that belong to its neighbours.
//
// Input x (n, h + 2, wd + 2, c): the rows above and below the shard as the
// exchange assembled them (a neighbour's rows, or reflected rows at a
// global edge) and the W border reflect-padded.  The conv is VALID
// (REFLECT = false, the path K2 takes), with the same optional
// normalize+relu prologue and the same statistics epilogue, and writes
// y (n, h, wd, co) and this shard's per-image sums Σy and Σy² (n, 2, co),
// not (mean, var): the caller all-reduces the sums over the shards and
// divides by the frame's H * W once
// (vst_tpu_torch/kernels/res_block.py::residual_block_fused).
//
// The prologue is elementwise per (image, channel), so normalizing a
// reflected or a neighbour's raw row equals reflecting or fetching a
// normalized one: the halo rows can be raw activations.
//
// Cost against the reflect mode: the padded copy that the caller builds,
// one read and one write of the activation per launch (a later version may
// take the halo rows by pointer instead).
#include "conv3x3_tf32.cuh"      // and conv3x3_wgmma.cuh
#include "conv3x3_tf32_narrow.cuh"   // the f32 body at C, Co <= 64
#include "res_block_common.cuh"   // finalize_stats, prologue_params, k1_run

// Returns cudaGetLastError() after the launches (0 on success).  The
// arguments are vst_k1_conv3x3_in_stats's, with h and wd the OUTPUT's rows
// and columns (x has h + 2 and wd + 2) and stats receiving Σy and Σy² of
// this launch's output.
extern "C" int vst_k1_conv3x3_in_stats_halo(
    const void* x, const void* w, const void* b, const void* stats_in,
    const void* gamma, const void* beta, int gb_bf16, void* y, void* sums,
    void* work, int n, int h, int wd, int c, int co, int bf16, int device,
    void* stream) {
  return vst::k1_run<false>(x, w, b, stats_in, gamma, beta, gb_bf16, y, sums,
                            work, n, h, wd, c, co, bf16, device, stream);
}
