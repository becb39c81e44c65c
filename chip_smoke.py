#!/usr/bin/env python3
"""Smoke run of vst_tpu_torch on one NVIDIA GPU: builds the CUDA kernels,
holds each against its plain PyTorch version, drives the ten paths of
the port (ReCoNet streaming stylization, AdaAttN arbitrary-style serving,
AdaAttN training, ReCoNet training, RTNSTV serving, RTNSTV training,
evaluation, scale-out over torch.distributed, H-sharded 4K serving and
data × space training of every step builder) and checks what comes
out.

    python3 chip_smoke.py

Phases, each failing loudly (an exception exits non-zero and prints no
result line):

1. card: nvidia-smi's name and power limit;
2. build: every kernel of ``vst_tpu_torch/kernels/csrc`` from source, with
   each kernel's registers and spills (ptxas) and, for K1/K2 in bf16
   (``conv3x3_wgmma``) and f32 (``conv3x3_tf32``, 3xTF32), the
   output-channel tile, dynamic shared memory and resident blocks per SM
   at every shape phase 3 runs, and the same for the bf16 K3 and K4/K5
   and the f32 (3xTF32) K3, K4 and K5;
3. kernels: K1 (without and with its prologue) at (8,128,128,192), the
   SD1/SD2 width (8,128,128,64), the 640×360 stream's (8,90,160,192) and
   RTNSTV's 640×360 residual stack (8,90,160,48) (in f32 also against the
   float64 evaluation),
   K2 at the ReCoNet, SD1 and SD2 packed stems and heads and the stream's
   packed (8,92,162,·), in bf16 and f32, in f32 also at C = 6, Co = 10,
   K1 also at the narrow body's edges, (1,2,37,64) (the least height, a
   ragged width) and (2,90,37,48) (a last tile row of 10, a last tile
   column of 5), in both modes, and two launches of each giving the same
   bits; K3 in bf16 at the
   three AdaAttN 512² batch-2 level shapes (and at relu3_1's with sharp
   scores of std 10 and with a stride-0 K/V) and at the edge of its value
   slices (c = 264), and in f32 (3xTF32) against the float64 evaluation
   at the three training level shapes (256², batch 8), the serving
   relu3_1 shape, relu3_1's with scores of std 10 and 100, a ragged
   shape, its slice edges and with a stride-0 K/V and Q, every case
   launched twice for the same bits;
   K4 and K5 in bf16 at the three AdaAttN training level shapes (256²,
   batch 8; relu3_1's also with sharp scores), at the edges of their
   output slices (d = 520: two dQ/dK slices, the last ragged; c = 264:
   two dV slices, the last ragged; n ≠ m, both off the 64-row tile) and
   with a broadcast (stride-0) K/V and a broadcast Q at d = 448, each
   launched twice for the same bits, against the plain version on the
   same inputs; and in f32 (3xTF32) against the float64 evaluation at a
   ragged shape and the same three, relu3_1's with scores of std 10 and
   100, the slice edges and with a stride-0 K/V and Q, launched twice for
   the same bits; with ``--parent DIR`` the f32 K5 also gives the bits of
   DIR's (a checkout of the parent commit, built here) at the three level
   shapes; and at the spatial part's 4K shapes: K1's halo-rows mode in
   bf16 and f32 at (1,540,960,C), C = 192, 64, 48, without and with its
   prologue, the reflect-padded tensor cut into 4 row shards that carry
   their neighbours' rows and into 1, the stitched y and summed
   statistics against the halo mode's plain version and against one
   reflect-mode launch on the whole tensor, each shard launched twice for
   the same bits; K2 on the packed (1,542,962,·) ReCoNet and SD2 stems and
   heads; K3 (bf16) at a 2160×3840 content's three levels against a 512²
   style's; and at the data × space steps' shapes: K1's halo-rows mode at
   the flow step's (4,90,160,192), the coco step's (4,64,64,192), the SD
   stages' (4,90,160,64) and RTNSTV's (4,90,160,48), each whole (xh with
   its border) and split in 2, and K2 on the packed (4,92,162,·) ReCoNet,
   SD1 and SD2 and (4,66,66,·) coco stems and heads, bf16 and f32; the
   f32 K3, K4 and K5 at the AdaAttN training levels where [3] has not
   held them yet; and at uneven row blocks (``row_layout``), bf16 and
   f32: K1's halo-rows mode at a 1080×1920 ReCoNet frame's residual level
   over 4 ranks (68, 68, 67, 67 rows) and whole, at the 360×640 b2 flow
   step's over 4 (24, 22, 22, 22) at C = 192 and RTNSTV's 48, and at a
   356×640 flow step's whole (89 rows), the stitched y bit for bit one
   reflect-mode launch's; K2 on those blocks' packed stems and heads; K3,
   K4 and K5 at the query shards of a 272×256 b8 AdaAttN image step over
   2 ranks (144 and 128 rows) at its three attention levels
   (``--spatial``); and K4 and K5 at the ring backward's hop shapes, the
   levels of the 512² b2 bf16 serving and the 256² b8 f32 training with
   n and m cut by 4 (``ring_hop_shapes``: (2, 4096 / 1024 / 256 tokens,
   ·) bf16 against the plain version, (8, 1024 / 256 / 64 tokens, ·) f32
   against the float64 evaluation), each launched twice for the same
   bits (``--scale-out`` runs these with the spatial cases);
4. model: the f32 ReCoNet and RTNSTV forwards through the kernels against
   the same forwards through the plain versions at 1×256×256 (and, with
   grad mode on, the same kernels' outputs bit for bit), the f32 AdaAttN
   forward (softmax through K3 against the plain version, cosine against
   the materialized oracle) at 1×256², the ReCoNet, SD1, SD2, RTNSTV and
   both AdaAttN forwards against the reference goldens
   (tests/goldens/reference_numerics.npz), and one f32 AdaAttN image
   train step at 1×64² through K3-K5 against their plain versions
   (metrics and every parameter gradient);
5. main paths, each with the launch counts set to 0 just before it and
   read just after: full-width ReCoNet from the port's seeded init, 512²
   batch 8 bf16, through ``stylize_reconet`` (uint8 and I420 wires), then
   ``StreamingStylizer`` over 96 synthetic 640×360 uint8 frames; the same
   weights in f32 (the dtype of a reference checkpoint), 512² batch 8
   through ``stylize_reconet``, K1 10 and K2 2 launches a forward; then
   full-width AdaAttN (VGG19 seed 0, AdaAttN seed 1), 512² batch 2 bf16
   softmax, through ``stylize_adaattn`` and ``adaattn_style_state`` +
   ``stylize_adaattn_cached``, and ``AdaAttNVideoStylizer`` over 512×256
   synthetic uint8 frames at batch 4, softmax and cosine; then AdaAttN
   training, ``make_adaattn_image_step`` at 256² batch 8 softmax in f32
   and bf16 and ``make_adaattn_video_step`` at 256×512 batch 4 cosine;
5b. main path, the AdaAttN trainer through the loop: the image trainer at
   its config's settings (256² b8 softmax f32) through ``run_training`` on
   32 synthetic pairs (4 batches an epoch; the card's machine has no PIL):
   ``BatchLoader`` + ``device_prefetch`` bitwise against the host batches;
   an uninterrupted 2-epoch run (K3 48, K4 24, K5 24 launches, finite
   metrics at every step, the epoch ``.npz``/``.pth`` and ``_last_state``
   written, the ``.npz`` reloading to the model's tensors); a run preempted
   by SIGUSR1 at epoch 1 batch 3 and resumed through the CLI's
   ``resume_position`` (the same batches, losses within rtol 1e-3,
   parameters but the g biases within 1e-4 relative L2); the loop's
   samples/s after a warmup epoch beside [5]'s bare step; and the video
   trainer for 2 steps through the loop;
5c. main path, ReCoNet training: K1's and K2's autograd Functions
   (kernel forward, library conv-gradient backward) against the same
   Functions' plain route in float64 at the f32 flow step's shapes (K1
   (4,90,160,192) without and with the prologue, K2's packed stem and
   head), f32 (tol 1e-4 of each gradient's scale) and bf16 (3e-2); one
   full-width f32 flow step (``RECONET_CANDY``: ReCoNet 48/96/192 seed 1,
   VGG16 seed 0, 360×640 frame pairs, batch 2) through the kernels and
   one through the plain versions, each against the plain float64 step
   (metrics 1e-4 relative; gradients within max(1e-3, 2 × the plain f32
   route's distance) of their scale); the flow step timed (2 warmup, 6 timed: ms, samples/s,
   peak memory; K1 10, K2 2 launches a step), under remat (K1 20, K2 4),
   the coco step (256² b4) and the SD1 → SD2 distillation (K1 20, K2 4
   with the teacher; SD1's SD loss NaN); K1's and K2's forward and
   backward ms per flow step; the flow trainer through ``run_training``
   on 8 synthetic items, uninterrupted and preempted + resumed;
5. (again) main path, RTNSTV serving from the port's seeded init
   (16/32/48, five 48-channel blocks): ``stylize_rtnstv`` at 640×360
   batch 8 in bf16 and f32 (uint8 and I420 wires), ``StreamingStylizer``
   over 96 synthetic 640×360 frames, K1 10 launches a forward;
5d. main path, RTNSTV training at ``RTNSTVConfig()`` (360×640 b2 f32,
   RTNSTV seed 1, VGG19 seed 0): one step through K1 and one through the
   plain versions against the plain float64 step (as [5c]), the step
   timed (2 warmup, 6 timed: K1 10 a step) and under remat (K1 20), the
   trainer through ``run_training`` on 8 synthetic items;
5e. main path, evaluation from seeded weights on synthetic data, the
   counts reset before each item and read after it: the ``image`` loop
   of ``cli/experiments.py`` (2 contents × 2 styles at 512², AdaAttN
   softmax bf16, SSIM, histograms, f32 Gram and LPIPS-vgg; K3 12), Sintel
   Et (``temporal_error_sintel``, RTNSTV f32, 17 frames 640×360, flow of
   std 2 px and masks; K1 30), temporal MSE (``temporal_mse``, ReCoNet
   f32, 9 frames; K1 90, K2 18), the ``sintel-ada`` loop (256×512, batch
   8, 9 frames, AdaAttN f32, RAFT flows; cosine none, softmax K3 6), RAFT
   at 1×256×512 ×12 against the port's RAFT on the CPU, and SSIM, Gram,
   LPIPS (vgg, alex, squeeze) and SIFID's statistics and distance at dims
   64/192/768/2048 on one 512² pair against the CPU; ms of each;
8. scale-out (``--scale-out`` runs it alone after the build), the counts
   set to 0 before each run and read after: ``cli.infer_video
   --data-parallel 1`` (a world-1 NCCL group of its own; rank 0 scatters
   and gathers each batch) on 48 synthetic 640×360 frames of the f32
   ReCoNet against the same command without it (frames within one uint8
   step; K1 10, K2 2 a forward); then a world-1 NCCL group on cuda:0
   (``multihost.initialize`` over ``tcp://127.0.0.1:<free port>``) and
   ``make_mesh(1)``: the f32 ReCoNet flow step (360×640 b2) and the bf16
   AdaAttN image step (256² b8) with and without the mesh (metrics within
   rtol 1e-6, gradients within max(1e-3, 4 × two bare runs' distance) of
   each key's largest: the attention convs' and the biases before an
   instance norm aside; the same launches a step), timed alternating
   (median of 7) with the gradient all-reduce alone; ``AdaAttNVideoStylizer(mesh=)`` against ``mesh=None`` (softmax
   512×256 b4, within one uint8 step); the ring's ``fold_block`` of 4 key
   blocks through K3 against one K3 call at the 512² b2 bf16 levels (2 ×
   bf16's spacing of the largest M) and the 256² b8 f32 levels (1e-4),
   L within 1e-5, 4 K3 launches a level; the ring's backward over 4 × 4
   (query shard, key block) pairs in one process (``block_grads`` with
   the global L and D of one K3 call over all keys, the dQ parts summed
   over the blocks and the dK, dV parts over the shards in float32)
   against one K4 + K5 call over all keys at the same levels (each
   gradient within 1e-4 of its largest in f32 and 4 × bf16's spacing in
   bf16, four bf16 parts summed), 16 K4 and 16 K5 launches a level, its
   time beside the one call's; the world-1 sharded softmax and cosine
   moments on ``requires_grad`` inputs at the 512² b2 bf16 levels, M1,
   M2, dQ, dK and dV bit for bit the single-device ones (K3 1, K4 1, K5
   1 a softmax level, none for cosine); one f32 gradient of a fixed loss
   (the mean square of the output times a seeded cotangent) through
   ``stylizing_network(..., mesh=make_mesh(1))`` at 256² b8 softmax
   (AdaAttN seed 1, VGG19 seed 0) against ``mesh=None``, cuDNN
   deterministic: the output and the attention outputs bit for bit, the
   attention convs' gradients bit for bit for one cotangent of the
   decoder's inputs (torch's bilinear and reflect-pad backwards in the
   decoder accumulate with atomics, so two backwards differ), the decoder
   gradients through ``backward()`` within 4 × the spread of three bare
   runs, K3 3, K4 3 and K5 3 launches; and a Chrome trace
   of one 512² bf16 ReCoNet forward from ``utils.profiling.trace_context``
   that names K1's (``conv3x3_wgmma<true, …>``) and K2's
   (``conv3x3_wgmma<false, …>``) kernels, 10 and 2; then the spatial part
   (``--spatial`` runs it alone, after the build and [3]'s spatial cases,
   in a world-1 group of its own): a "space" mesh of one rank and one
   2160×3840 uint8 frame on the card through ``stylize_spatial_sharded``
   (ReCoNet bf16 and f32, SD2 bf16, RTNSTV bf16; and ReCoNet bf16 on a
   1078×1920 frame, an H the even rule refused) and
   ``stylize_adaattn_sharded`` (softmax bf16, cosine f32, a 512² style),
   each against the unsharded ``stylize_*``: the network outputs' max
   error and whether the bits are equal, ms per frame sharded and
   unsharded (median of 5, alternating), launches per frame (K1 10, all
   in the halo-rows mode, K2 2 or 0, K3 3 or 0), each forward's share of
   device time in padded copies (pad, cat and copy kernels) and in
   ``vst::relayout_rows`` (none at world 1), and every
   launch at a shape [3] held; then the data × space part (in the same
   group): K1's halo-rows autograd Function against its plain route in
   float64 at (4,92,162,192), without and with the prologue, f32 (1e-4 of
   each gradient's scale) and bf16 (3e-2), and every step builder on a
   (1, 1) ("data", "space") mesh, its batch placed by
   ``shard_batch_spatial``, against two bare steps (``_space_cases``):
   ``RECONET_CANDY``'s flow step (360×640 b2, [5c]'s seeded state, grams
   and batch) in f32 and bf16, and at 356×640 in f32 (an H the even rule
   refused), the coco step (256² b4), the SD1 and SD2
   distillation stages (360×640 b2) and RTNSTV (``RTNSTVConfig()``,
   360×640 b2), all f32 but the flow step's bf16 run, held to their plain
   float64 bare step: the sharded step's metrics and gradients within the
   larger of a floor (``SPACE_FLOORS``, [5c]'s) and 2 × the bare step's
   own distance from it; the AdaAttN image step (256² b8 softmax) and
   video step (256×512 b4 cosine), f32, held to two bare runs: decoder
   gradients within the larger of the gradient floor and 4 × their
   distance; every step's metrics within the larger of a floor
   (``SPACE_METRIC_FLOORS``) and 4 × two bare runs' distance of the bare
   step's, Adam's update on its own gradient within 1e-3·lr and the bare
   update's within 1e-3·lr where the reference gradient is above the
   tolerance; launches a step: K1 10 (flow, coco, RTNSTV) or 20 (SD, the
   teacher's forward included), all in the halo-rows mode, K2 2 or 4, K3
   6, K4 3 and K5 3 (image), none (video), each at a shape [3] held; ms
   per step sharded and bare (median of 6, alternating), the peak memory
   of one step each, and the sharded step's device time in
   ``vst::exchange_rows``, ``vst::exchange_rows_bwd`` and
   ``vst::relayout_rows`` (none at world 1);
6. timing: each kernel, its plain version and a library yardstick the
   port never calls (cuDNN ``F.conv2d`` of the same conv for K1/K2, in
   benchmark mode and the faster of NCHW and channels_last, bf16 and f32,
   ``F.scaled_dot_product_attention`` for K3 and its backward for K4/K5)
   at the main paths' shapes, printed as one JSON ``kernels`` line (K1/K2
   rows also carry ms, TFLOP/s and the bound's share per launch; K3-K5
   rows the same per level, and the f32 K3/K4/K5 times at the three
   training levels as ``ms_f32`` (with TFLOP/s and the executed-work
   factor per level) beside ``bound_ms_f32`` (3xTF32 peak),
   ``plain_ms_f32`` (the plain versions in f32) and ``library_ms_f32``
   (SDPA in f32, TF32 off); the f32 K1 and K2 at
   the bf16 rows' shapes beside their plain versions and cuDNN in f32,
   TF32 off, in benchmark mode and the faster of NCHW and channels_last);
   K3's (bf16 and
   f32) and K4/K5's executed-work factor per level is logged, from the
   slice widths the built library reports; K1 also at its narrow
   widths, RTNSTV's (8,90,160,48) and SD1/SD2's (8,128,128,64), in bf16
   and f32 beside cuDNN (benchmark mode), with each call's device time
   (torch.profiler, every kernel the call launches), its launches and its
   host time (200 calls, no synchronization between them);
7. profile: device time by kernel over two forwards (train steps) of each
   main path, ReCoNet in bf16 and f32, the f32 ReCoNet flow step, the
   RTNSTV 640×360 b8 bf16 forward (with K1's share of its device time)
   and the f32 RTNSTV step (torch.profiler), and the device's busy share
   of that window.

The last line is {"ok": true, "device": {...}}.  Needs one CUDA card and
the CUDA toolkit (nvcc); no network, no cv2, no PIL.

    python3 chip_smoke.py --parent DIR

runs everything above and holds the f32 K5 to the bits of DIR's.

    python3 chip_smoke.py --f32-step

breaks down the f32 AdaAttN image step alone (the config default): the
f32 K3, K4 and K5 at the three training levels, the step's time and its
device time by kernel.  It calls only the K3-K5 wrappers and the image
step builder, whose interfaces date from the port's training slice, so a
copy of this script placed beside an older checkout's ``vst_tpu_torch``
measures that checkout the same way.

    python3 chip_smoke.py --f32-reconet

does the same for the f32 ReCoNet 512² b8 batch: the f32 K1 and K2 per
launch, the batch's time with its launch counts, and its device time by
kernel; it calls only ``stylize_reconet``, ``init_reconet`` and the K1/K2
wrappers, whose interfaces date from the port's first slice.

    python3 chip_smoke.py --reconet-train

builds the kernels and runs [5c] alone, then profiles the f32 flow step.

    python3 chip_smoke.py --rtnstv

builds the kernels and runs RTNSTV's part alone: K1 at (8,90,160,48)
and the narrow shapes of [3], the RTNSTV forward and golden, serving,
training ([5d]), K1's times at its two narrow widths, and the profiles of
the bf16 forward and the f32 step.

    python3 chip_smoke.py --eval

builds the kernels and runs [5e] alone.

    python3 chip_smoke.py --scale-out

builds the kernels and runs [3]'s spatial cases and [8] alone.

    python3 chip_smoke.py --spatial

builds the kernels and runs [3]'s spatial cases and the spatial and data ×
space parts of [8] alone.
"""

import contextlib
import copy
import ctypes
import dataclasses
import functools
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from vst_tpu_torch.cli.experiments import (estimated_pairs, image_rows,
                                           lpips_metric, raft_flow_fn,
                                           sintel_ada_loss,
                                           sintel_ada_stylizer)
from vst_tpu_torch.cli.train import resume_position
from vst_tpu_torch.compat import load_weights, params_from_jax
from vst_tpu_torch.data.pipeline import BatchLoader, device_prefetch
from vst_tpu_torch.device import apply_precision
from vst_tpu_torch.eval import (gram_loss_5tap, lpips_distance, ssim,
                                temporal_error_sintel, temporal_mse)
from vst_tpu_torch.eval.inception import (BLOCK_INDEX_BY_DIM,
                                          inception_blocks, init_inception)
from vst_tpu_torch.eval.lpips import random_lpips_params
from vst_tpu_torch.eval.sifid import (activation_statistics,
                                      frechet_distance_branch)
from vst_tpu_torch.infer.image import (adaattn_style_state, stylize_adaattn,
                                       stylize_adaattn_cached, stylize_reconet,
                                       stylize_rtnstv)
from vst_tpu_torch.infer.video import AdaAttNVideoStylizer, StreamingStylizer
from vst_tpu_torch.kernels import (_build, adaattn_attention, head_conv,
                                   res_block)
from vst_tpu_torch.models.adaattn import (init_stylizing_network,
                                          stylizing_network_cached)
from vst_tpu_torch.models import rtnstv as rtnstv_m
from vst_tpu_torch.models.raft import init_raft, raft_flow
from vst_tpu_torch.models.reconet import (init_reconet, init_reconet_sd1,
                                          init_reconet_sd2)
from vst_tpu_torch.models.vgg import (init_vgg16_reconet, init_vgg19_adaattn,
                                      init_vgg19_rtnstv)
from vst_tpu_torch.ops import conv as ops_conv
from vst_tpu_torch.ops.yuv import rgb_to_i420
from vst_tpu_torch.train import checkpoint as ckpt
from vst_tpu_torch.train.config import (DISTILL_SD1, DISTILL_SD2,
                                        RECONET_CANDY, AdaAttNImageConfig,
                                        AdaAttNVideoConfig, ReCoNetCocoConfig,
                                        RTNSTVConfig)
from vst_tpu_torch.train.loop import TrainingPreempted, run_training
from vst_tpu_torch.train.state import create
from vst_tpu_torch.train import steps as steps_m
from vst_tpu_torch.train.steps import (make_adaattn_image_step,
                                       make_adaattn_video_step,
                                       make_reconet_coco_step,
                                       make_reconet_distill_step,
                                       make_reconet_flow_step,
                                       make_rtnstv_step, reconet_style_grams,
                                       rtnstv_style_grams)

ROOT = os.path.dirname(os.path.abspath(__file__))
# H100 SXM data sheet, dense: bf16 tensor-core peak, float32 outside the
# tensor cores, 3xTF32 (three tf32 products, 495 TFLOP/s, per product of
# the least work) and HBM3 bandwidth.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12,
              "tf32x3": 495e12 / 3}
PEAK_BYTES = 3.35e12
BF16_ULP = 2.0 ** -7      # relative spacing of bf16 at the top of a binade


def log(*a):
    print(*a, flush=True)


def rnd(g, shape, scale=1.0, dtype=torch.float32, shift=0.0):
    return (torch.randn(shape, device="cuda", generator=g) * scale
            + shift).to(dtype)


def max_err(a, b):
    return (a.float() - b.float()).abs().max().item()


def check(name, a, b, tol_rel):
    """|a − b| ≤ tol_rel · max|b|, else raise."""
    err = max_err(a, b)
    tol = tol_rel * b.float().abs().max().item()
    ok = err <= tol
    log(f"  {name}: max_abs_err {err:.3e} tol {tol:.3e} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: max_abs_err {err} > {tol}")
    return err


def event_ms(fn, reps=10, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def bound(flops, nbytes, dtype):
    """(least ms the card could take, what bounds it)."""
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


@contextlib.contextmanager
def plain_kernels():
    """Route the model through the kernels' plain versions on the card
    (the comparison of phase 4; the package itself never does this).
    ``SoftmaxAttentionMoments`` looks up K3, K4 and K5 at call time, so the
    port's own autograd Function runs on the plain side too."""
    att = adaattn_attention
    saved = (res_block.conv3x3_in_stats, ops_conv.conv3x3_valid,
             att._moments_fwd, att.softmax_attention_dq,
             att.softmax_attention_dkv)
    res_block.conv3x3_in_stats = res_block.conv3x3_in_stats_plain
    ops_conv.conv3x3_valid = head_conv.conv3x3_valid_plain
    att._moments_fwd = att.softmax_attention_moments_plain
    att.softmax_attention_dq = att.softmax_attention_dq_plain
    att.softmax_attention_dkv = att.softmax_attention_dkv_plain
    try:
        yield
    finally:
        (res_block.conv3x3_in_stats, ops_conv.conv3x3_valid,
         att._moments_fwd, att.softmax_attention_dq,
         att.softmax_attention_dkv) = saved


WRAPPERS = (res_block.conv3x3_in_stats, head_conv.conv3x3_valid,
            adaattn_attention.softmax_attention_moments,
            adaattn_attention.softmax_attention_dq,
            adaattn_attention.softmax_attention_dkv)


def reset_counts():
    for w in WRAPPERS + (res_block.conv3x3_in_stats_halo,):
        w.launches = 0


def counts():
    """Launches of K1 … K5 since the last ``reset_counts``; K1's in both
    of its modes (reflect and halo rows)."""
    out = [w.launches for w in WRAPPERS]
    out[0] += res_block.conv3x3_in_stats_halo.launches
    return tuple(out)


# ------------------------------------------------------------------ phases

def phase_card():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"[1] card: {smi}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; {torch.cuda.get_device_name(0)}")
    return smi


def ptxas_report(out):
    """(entry function, registers, spill stores, spill loads, static smem
    bytes) for each kernel in nvcc's ``-Xptxas -v`` output."""
    rows, entry, spills = [], None, (0, 0)
    for line in out.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "spill stores" in line:
            nums = [int(t) for t in line.replace(",", " ").split() if t.isdigit()]
            spills = (nums[1], nums[2])
        elif "Used" in line and "registers" in line and entry:
            words = line.replace(",", " ").split()
            regs = int(words[words.index("Used") + 1])
            smem = int(words[words.index("smem") - 2]) if "smem" in words else 0
            rows.append((entry, regs, *spills, smem))
            entry = None
    return rows


def _wgmma_config(lib_fn, *args, size=3):
    out = (ctypes.c_int * size)()
    rc = lib_fn(*args, out)
    if rc != 0:
        raise RuntimeError(f"launch config {args}: CUDA error {rc}")
    return tuple(out)


def phase_build():
    secs = _build.build_all()
    log(f"[2] build: {len(_build.KERNELS)} kernels in {secs:.2f} s")
    for name, out in _build.build_log.items():
        for entry, regs, st, ld, smem in ptxas_report(out):
            log(f"  {name}: {entry}: {regs} registers, spill stores {st}, "
                f"loads {ld}, static smem {smem} B")
    for name in _build.KERNELS:
        _build.load(name)
    k1 = _build.load("res_block").vst_k1_launch_config
    k1.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    k2 = _build.load("head_conv").vst_k2_launch_config
    k2.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    for bf16, body in ((1, "conv3x3_wgmma"), (0, "conv3x3_tf32")):
        shapes = K1_BF16 if bf16 else {**K1_BF16, **K1_F32_ODD}
        for c, co in sorted({(s[3], s[4] if len(s) > 4 else s[3])
                             for s in shapes.values()}):
            for pro in (0, 1):
                n, smem, occ = _wgmma_config(k1, c, co, pro, bf16)
                log(f"  K1 {body} {c}->{co}{' prologue' if pro else ''}: "
                    f"tile N={n}, dynamic smem {smem} B, {occ} block(s)/SM")
        shapes = K2_BF16 if bf16 else {**K2_BF16, **K2_F32_ODD}
        for c, co in sorted({s[3:] for s in shapes.values()}):
            n, smem, occ = _wgmma_config(k2, c, co, bf16)
            log(f"  K2 {body} {c}->{co}: tile N={n} x {-(-co // n)}, "
                f"dynamic smem {smem} B, {occ} block(s)/SM")
    k3 = _build.load("adaattn_fwd").vst_k3_launch_config
    k3.argtypes = [ctypes.c_void_p]
    smem, occ, slice_v, smem3, occ3, slice3 = _wgmma_config(k3, size=6)
    log(f"  K3 bf16 (wgmma): dynamic smem {smem} B, {occ} block(s)/SM, value "
        f"slices of {slice_v} columns")
    log(f"  K3 f32 (3xTF32 on wgmma, attn_fwd_tf32): dynamic smem {smem3} B, "
        f"{occ3} block(s)/SM, value slices of {slice3} columns")
    k45 = _build.load("adaattn_bwd").vst_k45_launch_config
    k45.argtypes = [ctypes.c_void_p]
    (smem, occ4, occ5, slice_dq, slice_dv, smem_f32, occ_f32, slice_dk_f32,
     slice_dv_f32, smem4_f32, occ4_f32, slice_dq_f32) = _wgmma_config(
         k45, size=12)
    log(f"  K4/K5 bf16 (wgmma): dynamic smem {smem} B, {occ4} / {occ5} "
        f"block(s)/SM, output slices of {slice_dq} dQ/dK and {slice_dv} dV "
        f"columns")
    log(f"  K4 f32 (3xTF32 on wgmma, attn_dq_tf32): dynamic smem {smem4_f32} "
        f"B, {occ4_f32} block(s)/SM, output slices of {slice_dq_f32} dQ "
        f"columns")
    log(f"  K5 f32 (3xTF32 on wgmma, attn_dkv_tf32): dynamic smem {smem_f32} "
        f"B, {occ_f32} block(s)/SM, output slices of {slice_dk_f32} dK and "
        f"{slice_dv_f32} dV columns")
    return {"K3": slice_v, "K3_f32": slice3, "K45": (slice_dq, slice_dv),
            "K4_f32": (slice_dq_f32, slice_dv),
            "K5_f32": (slice_dk_f32, slice_dv_f32)}


K1_SHAPE = (8, 128, 128, 192)
K2_SHAPES = {"stem": (48, 768), "head": (768, 48)}   # packed (C, Co)
# bf16 shapes of phase 3: (N, H, W, C) with Co = C for K1; (N, Hp, Wp, C,
# Co) packed for K2.  The 640×360 stream runs the residual stack at 90×160
# and the 9×9 layers on a 92×162 packed input.
# RTNSTV's residual stack at 640×360 batch 8: a quarter of the frame by 48
K1_RTNSTV = (8, 90, 160, 48)
K1_BF16 = {"ReCoNet": K1_SHAPE, "SD1/SD2": (8, 128, 128, 64),
           "stream": (8, 90, 160, 192), "RTNSTV": K1_RTNSTV}
K2_BF16 = {"ReCoNet stem": (8, 130, 130, 48, 768),
           "ReCoNet head": (8, 130, 130, 768, 48),
           "SD1 stem": (8, 130, 130, 48, 512), "SD1 head": (8, 130, 130, 512, 48),
           "SD2 stem": (8, 130, 130, 48, 256), "SD2 head": (8, 130, 130, 256, 48),
           "stream stem": (8, 92, 162, 48, 768),
           "stream head": (8, 92, 162, 768, 48)}
# f32 only: channel counts that are not multiples of 4 (the bf16 body
# takes multiples of 8); K1's shape is (N, H, W, C, Co).
K1_F32_ODD = {"C6 Co10": (2, 11, 19, 6, 10)}
# The narrow body's edges (C = Co <= 64, 16 × 16-pixel tiles), both modes
K1_NARROW_EDGES = {"ragged": (1, 2, 37, 64), "RTNSTV ragged": (2, 90, 37, 48)}
K2_F32_ODD = {"C6 Co10": (2, 12, 21, 6, 10)}
# [5e]'s temporal MSE: ReCoNet f32 one 640×360 frame at a time
K1_EVAL_F32 = {"temporal MSE": (1, 90, 160, 192)}
K2_EVAL_F32 = {"temporal MSE stem": (1, 92, 162, 48, 768),
               "temporal MSE head": (1, 92, 162, 768, 48)}

# The shapes [3] held against the plain versions: ("K1" | "K1h" | "K2" |
# "K3" | "K4" | "K5", dtype, shape, batch-stride-0 operands or Co); [5e]
# and the spatial and data × space parts of [8] fail on a launch outside.
CHECKED = set()


def _k3_key(q, k, v, kid="K3"):
    b = q.shape[0]
    bcast = "".join(t for t, x in (("q", q), ("kv", k))
                    if b > 1 and x.stride(0) == 0)
    return (kid, q.dtype, (b, q.shape[1], k.shape[1], q.shape[2],
                           v.shape[2]), bcast)


@contextlib.contextmanager
def recording_launches():
    """Record the key of every K1-K5 launch in the block (the wrappers'
    ``_launch`` / ``_launch_halo`` / ``_moments_fwd`` / ``_check_bwd``,
    which run only on the card; K1's halo-rows mode as "K1h"); yields the
    set."""
    seen = set()
    att = adaattn_attention
    saved = (res_block._launch, head_conv._launch, att._moments_fwd,
             res_block._launch_halo, att._check_bwd)

    def k1(x, w, *a, **kw):
        seen.add(("K1", x.dtype, tuple(x.shape), w.shape[3]))
        return saved[0](x, w, *a, **kw)

    def k1h(x, w, *a, **kw):
        seen.add(("K1h", x.dtype, tuple(x.shape), w.shape[3]))
        return saved[3](x, w, *a, **kw)

    def k2(x, w):
        seen.add(("K2", x.dtype, tuple(x.shape), w.shape[3]))
        return saved[1](x, w)

    def k3(q, k, v):
        seen.add(_k3_key(q, k, v))
        return saved[2](q, k, v)

    def k45(q, k, v, *rest):
        seen.add(_k3_key(q, k, v, "K4" if rest[-1].endswith("_dq")
                         else "K5"))
        return saved[4](q, k, v, *rest)

    (res_block._launch, head_conv._launch, att._moments_fwd,
     res_block._launch_halo, att._check_bwd) = k1, k2, k3, k1h, k45
    try:
        yield seen
    finally:
        (res_block._launch, head_conv._launch, att._moments_fwd,
         res_block._launch_halo, att._check_bwd) = saved


def k1_inputs(g, dtype, shape=K1_SHAPE):
    """x (N, H, W, C) and w, b, gamma, beta for Co output channels: shape
    (N, H, W, C) with Co = C, or (N, H, W, C, Co)."""
    c, co = shape[3], shape[-1]
    x = rnd(g, shape[:4], 3.0, dtype)
    wt = rnd(g, (3, 3, c, co), 0.02, dtype)
    b = rnd(g, (co,), 0.02, dtype)
    gamma = rnd(g, (co,), 0.3, shift=1.0)
    beta = rnd(g, (co,), 0.1)
    return x, wt, b, gamma, beta


def k2_inputs(g, shape, dtype):
    n, hp, wp, c, co = shape
    return rnd(g, (n, hp, wp, c), 1.0, dtype), rnd(g, (3, 3, c, co), 0.05, dtype)


def _k1_check(g, dtype, label, shape, tol):
    """K1 without and with its prologue (on the first launch's output and
    statistics) against the plain version at ``shape``, and a second
    launch of each, which must give the same bits.  Returns the worst y
    error."""
    x, wt, b, gamma, beta = k1_inputs(g, dtype, shape)
    c, co = wt.shape[2:]
    w2 = wt if c == co else rnd(g, (3, 3, co, co), 0.02, dtype)
    CHECKED.update({("K1", dtype, tuple(x.shape), co),
                    ("K1", dtype, (*x.shape[:3], co), co)})
    y, s = res_block.conv3x3_in_stats(x, wt, b)
    yp, sp = res_block.conv3x3_in_stats_plain(x, wt, b)
    e1 = check(f"K1 {label} {shape} y", y, yp, tol)
    check(f"K1 {label} stats", s, sp, 1e-4)
    y2, s2 = res_block.conv3x3_in_stats(y, w2, b, s, gamma, beta)
    y2p, s2p = res_block.conv3x3_in_stats_plain(y, w2, b, s, gamma, beta)
    e2 = check(f"K1 {label} prologue y", y2, y2p, tol)
    check(f"K1 {label} prologue stats", s2, s2p, 1e-4)
    again = (*res_block.conv3x3_in_stats(x, wt, b),
             *res_block.conv3x3_in_stats(y, w2, b, s, gamma, beta))
    if not all(torch.equal(a, r) for a, r in zip(again, (y, s, y2, s2))):
        raise AssertionError(f"K1 {label}: two launches differ")
    return max(e1, e2)


def _k2_check(g, dtype, label, shape, tol):
    xk, wk = k2_inputs(g, shape, dtype)
    CHECKED.add(("K2", dtype, tuple(xk.shape), wk.shape[3]))
    yk = head_conv.conv3x3_valid(xk, wk)
    err = check(f"K2 {label} {shape}", yk,
                head_conv.conv3x3_valid_plain(xk, wk), tol)
    if not torch.equal(yk, head_conv.conv3x3_valid(xk, wk)):
        raise AssertionError(f"K2 {label}: two launches differ")
    return err


def phase_kernels(g):
    """K1 and K2 against their plain versions on the same inputs, f32
    (3xTF32) and bf16, at every shape of K1_BF16 and K2_BF16 and in f32
    also at channel counts that are not multiples of 4 (K1_F32_ODD,
    K2_F32_ODD) and at [5e]'s batch-1 shapes (K1_EVAL_F32, K2_EVAL_F32);
    a second launch must give the same bits.  Tolerances: f32
    1e-4·max|plain| (sums in another order over up to 6912 terms, and the
    split's 2^-21-relative products); bf16 one bf16 ulp at the output's
    scale, 2^-7·max|plain| (the f32 sums may round to neighbouring bf16
    values); the f32 stats 1e-4·max|plain|."""
    log("[3] kernels against their plain versions")
    apply_precision(torch.float32)
    errs = {"K1 f32": max(_k1_check(g, torch.float32, f"f32 {label}", shape,
                                    1e-4) for label, shape in
                          {**K1_BF16, **K1_F32_ODD, **K1_NARROW_EDGES,
                           **K1_EVAL_F32}.items()),
            "K2 f32": max(_k2_check(g, torch.float32, f"f32 {label}", shape,
                                    1e-4) for label, shape in
                          {**K2_BF16, **K2_F32_ODD,
                           **K2_EVAL_F32}.items())}
    apply_precision(torch.bfloat16)
    errs.update(
        K1=max(_k1_check(g, torch.bfloat16, f"bf16 {label}", shape, BF16_ULP)
               for label, shape in {**K1_BF16, **K1_NARROW_EDGES}.items()),
        K2=max(_k2_check(g, torch.bfloat16, f"bf16 {label}", shape, BF16_ULP)
               for label, shape in K2_BF16.items()))
    log("  f32 and bf16 K1 and K2: a second launch gives the same bits at "
        "every shape")
    errs["K1 f32 RTNSTV vs f64"] = _k1_f64_check(
        torch.Generator(device="cuda").manual_seed(14), K1_RTNSTV)
    torch.cuda.synchronize()
    return errs


# AdaAttN attention levels at 512² (relu3_1, relu4_1, relu5_1): (n = m, d, c)
K3_LEVELS = [(16384, 448, 256), (4096, 960, 512), (1024, 1472, 512)]
K3_BATCH = 2
# and at 256×512, the sintel-ada frames
ADA_SINTEL_LEVELS = [(8192, 448, 256), (2048, 960, 512), (512, 1472, 512)]
# [5e]'s K3 cases: the image sweep's bf16 batch 1 at 512²; sintel-ada's f32
# batch 8 at 256×512 against the cached style's K/V (batch stride 0)
K3_EVAL = ([("bf16 image sweep", torch.bfloat16, (1, n, n, d, c), 1.0, "")
            for n, d, c in K3_LEVELS]
           + [("f32 sintel-ada", torch.float32, (8, n, n, d, c), 1.0, "kv")
              for n, d, c in ADA_SINTEL_LEVELS])


def k3_inputs(g, b, n, m, d, c, dtype, score_std=1.0):
    """Scores of std ``score_std``: 1 is what instance-normed features
    through a 1×1 conv give."""
    s = score_std ** 0.5 * d ** -0.25
    return (rnd(g, (b, n, d), s, dtype),
            rnd(g, (b, m, d), s, dtype), rnd(g, (b, m, c), 1.0, dtype))


def _broadcast(q, k, v, which):
    """``which`` "kv": one K and V for the batch, "q": one Q, read through a
    batch stride of 0."""
    if "q" in which:
        q = q[:1].expand_as(q)
    if "kv" in which:
        k, v = k[:1].expand_as(k), v[:1].expand_as(v)
    return q, k, v


def _k3_check(g, tag, dtype, shape, score_std, bcast):
    """One K3 case of ``phase_kernels_k3``, launched twice for the same
    bits; returns the worst M1/M2 error."""
    apply_precision(dtype)
    q, k, v = _broadcast(*k3_inputs(g, *shape, dtype, score_std), bcast)
    CHECKED.add(_k3_key(q, k, v))
    m1, m2, lse = adaattn_attention.softmax_attention_moments(q, k, v)
    again = adaattn_attention.softmax_attention_moments(q, k, v)
    if not all(torch.equal(a, b) for a, b in zip((m1, m2, lse), again)):
        raise AssertionError(f"K3 {tag} {shape}: two launches differ")
    del again
    if dtype == torch.bfloat16:
        ref, tol = adaattn_attention.softmax_attention_moments_plain(
            q, k, v), 2 * BF16_ULP
    else:
        ref, tol = adaattn_attention.softmax_attention_moments_plain(
            q.double(), k.double(), v.double()), 1e-4
    name = f"K3 {tag} {shape}"
    e = max(check(f"{name} M1", m1, ref[0], tol),
            check(f"{name} M2", m2, ref[1], tol))
    check(f"{name} L", lse, ref[2], 1e-5)
    return e


def phase_kernels_k3(g):
    """K3 against its plain version, every case launched twice for the
    same bits.  bf16 at the three AdaAttN 512² batch-2 level shapes, at
    relu3_1's with sharp scores of std 10 (base-2 running max and rescale,
    P rounded to bf16) and with a stride-0 K/V (the cached style), and at
    the edge of the value slices (c = 264: a second slice of 8 columns;
    d = 520, n ≠ m, both off the 64-row tile).  f32 (3xTF32) against the
    plain formulas evaluated in float64 on the same inputs: the three
    training level shapes (256² batch 8), the serving relu3_1 shape (512²
    batch 2), relu3_1's training shape with scores of std 10 and 100, a
    ragged shape, the slice edges (c = 264; c = 512 over two slices with
    d = 1480 past relu5_1's), a stride-0 K/V and a stride-0 Q.  And
    [5e]'s cases (K3_EVAL): bf16 at batch 1 at 512², f32 at batch 8 at
    256×512 with a stride-0 K/V.
    Tolerances: bf16 M1, M2 2^-6·max|plain| (one bf16 ulp of the output
    rounding plus the f32 difference of P rounded to bf16 against a
    running max instead of the row max); f32 1e-4 of each output's scale
    (3xTF32 products within about 2^-21 of float32's, sums in another
    order over up to 16384 keys; float64 is the reference because at
    scores of std 100 true float32 is itself off by a good part of that);
    L 1e-5·max|L|."""
    cases = [("bf16", torch.bfloat16, (K3_BATCH, n, n, d, c), 1.0, "")
             for n, d, c in K3_LEVELS]
    n, d, c = K3_LEVELS[0]
    n3, d3, c3 = TRAIN_LEVELS[0]
    cases += [("bf16 sharp", torch.bfloat16, (K3_BATCH, n, n, d, c), 10.0, ""),
              ("bf16 stride-0 K/V", torch.bfloat16, (K3_BATCH, n, n, d, c),
               1.0, "kv"),
              ("bf16 slice edge", torch.bfloat16, (2, 200, 330, 520, 264), 1.0,
               "")]
    cases += [("f32", torch.float32, (TRAIN_BATCH, nt, nt, dt, ct), 1.0, "")
              for nt, dt, ct in TRAIN_LEVELS]
    cases += [("f32 serving", torch.float32, (K3_BATCH, n, n, d, c), 1.0, ""),
              ("f32 sharp", torch.float32, (TRAIN_BATCH, n3, n3, d3, c3),
               10.0, ""),
              ("f32 sharper", torch.float32, (TRAIN_BATCH, n3, n3, d3, c3),
               100.0, ""),
              ("f32 ragged", torch.float32, (2, 300, 520, 96, 64), 1.0, ""),
              ("f32 slice edge", torch.float32, (2, 200, 330, 520, 264), 1.0,
               ""),
              ("f32 slice edges", torch.float32, (2, 130, 200, 1480, 512),
               1.0, ""),
              ("f32 stride-0 K/V", torch.float32, (4, 200, 330, 448, 256),
               1.0, "kv"),
              ("f32 stride-0 Q", torch.float32, (4, 200, 330, 448, 256), 1.0,
               "q")]
    errs = {"K3": 0.0, "K3 f32": 0.0}
    for case in cases + K3_EVAL:
        key = "K3" if case[1] == torch.bfloat16 else "K3 f32"
        errs[key] = max(errs[key], _k3_check(g, *case))
    log("  K3 bf16 and f32: a second launch gives the same bits at every shape")
    torch.cuda.synchronize()
    return errs


# AdaAttN training at 256² (relu3_1, relu4_1, relu5_1): (n = m, d, c)
TRAIN_LEVELS = [(4096, 448, 256), (1024, 960, 512), (256, 1472, 512)]
TRAIN_BATCH = 8


def k45_inputs(g, b, n, m, d, c, dtype, score_std=1.0, broadcast=""):
    """K3's inputs, the plain forward's M1, M2, L on them, unit-scale
    cotangents in the inputs' type and the row term D.  ``broadcast``:
    "kv" for one K and V for the batch, "q" for one Q, read through a
    batch stride of 0."""
    q, k, v = _broadcast(*k3_inputs(g, b, n, m, d, c, dtype, score_std),
                         broadcast)
    m1, m2, lse = adaattn_attention.softmax_attention_moments_plain(q, k, v)
    dm1, dm2 = rnd(g, (b, n, c), 1.0, dtype), rnd(g, (b, n, c), 1.0, dtype)
    dd = adaattn_attention.row_term(m1, m2, dm1, dm2)
    return q, k, v, lse, dd, dm1, dm2


def start_parent_build(parent):
    """Starts nvcc on a parent checkout's ``adaattn_bwd.cu`` with the
    package's flags, into ``build/parent_k5/``; returns (library, process)."""
    src = os.path.join(os.path.abspath(parent), "vst_tpu_torch", "kernels",
                       "csrc")
    out = os.path.join(ROOT, "build", "parent_k5")
    os.makedirs(out, exist_ok=True)
    lib = os.path.join(out, "libadaattn_bwd.so")
    return lib, subprocess.Popen(
        [_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", src, "-o", lib,
         os.path.join(src, "adaattn_bwd.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def parent_k5(started):
    """The parent's K5 (``softmax_attention_dkv``'s arguments, f32 only)
    once its build from ``start_parent_build`` is done."""
    lib, proc = started
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on the parent's adaattn_bwd.cu:\n{out}")
    so = ctypes.CDLL(lib)
    fn = so.vst_k5_attention_dkv
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 3 + [ctypes.c_int, ctypes.c_void_p])
    floats = so.vst_k5_scratch_floats
    floats.argtypes = [ctypes.c_int] * 5 + [ctypes.c_longlong] * 3
    floats.restype = ctypes.c_longlong

    def dkv(q, k, v, lse, dd, dm1, dm2):
        b, n, d = q.shape
        m, c = k.shape[1], v.shape[2]
        strides = (q.stride(0), k.stride(0), v.stride(0))
        dk = torch.empty((b, m, d), device=q.device)
        dv = torch.empty((b, m, c), device=q.device)
        scratch = torch.empty(floats(b, n, m, d, c, *strides), device=q.device)
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dm1.data_ptr(),
                dm2.data_ptr(), lse.data_ptr(), dd.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), scratch.data_ptr(), b, n, m, d, c, *strides, 0,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"parent K5 launch failed: CUDA error {rc}")
        return dk, dv
    return dkv


def phase_kernels_k45(g, parent=None):
    """K4 (dQ) and K5 (dK, dV) on the same inputs and cotangents: bf16
    against the plain version at the three AdaAttN training level shapes
    (256², batch 8), at relu3_1's with sharp scores of std 10, at the
    edges of the output slices (d = 520, c = 264, n = 300 ≠ m = 200) and
    with a stride-0 K/V and a stride-0 Q at d = 448; f32 (3xTF32) against
    the same formulas evaluated in float64 (the plain versions on float64
    inputs: at scores of std 100 true float32 is itself over 1e-4 of the
    scale from them) at a ragged shape, the three level shapes (the f32
    image step, the config default, launches both at all three), relu3_1's
    with scores of std 10 and 100, the slice edges (d = 520 and c = 264;
    d = 513 and c = 257, one column past; d = 1030 and c = 515, off the
    16-byte rows) and with a stride-0 Q and a stride-0 K/V.  A second
    launch must give the same bits, every case; with ``parent``
    (``parent_k5``) the f32 K5 must also give the parent checkout's bits
    at the three level shapes.
    Tolerances, of each output's scale: bf16 2^-6 (one bf16 ulp of the
    output rounding plus A and dS rounded to bf16 from f32 values summed in
    another order); f32 1e-4 (3xTF32 products within about 2^-21 of
    float32's, sums over up to 4096 terms in fresh partials)."""
    errs = {"K4": 0.0, "K5": 0.0, "K4 f32": 0.0, "K5 f32": 0.0}
    levels = [(TRAIN_BATCH, n, n, d, c) for n, d, c in TRAIN_LEVELS]
    cases = [("bf16", torch.bfloat16, shape, 1.0, "") for shape in levels]
    cases += [("bf16 sharp", torch.bfloat16, levels[0], 10.0, ""),
              ("bf16 slice edges", torch.bfloat16, (2, 300, 200, 520, 264),
               1.0, ""),
              ("bf16 stride-0 K/V", torch.bfloat16, (4, 200, 330, 448, 256),
               1.0, "kv"),
              ("bf16 stride-0 Q", torch.bfloat16, (4, 200, 330, 448, 256),
               1.0, "q"),
              ("f32", torch.float32, (2, 300, 520, 96, 64), 1.0, "")]
    cases += [("f32", torch.float32, shape, 1.0, "") for shape in levels]
    cases += [("f32 sharp", torch.float32, levels[0], 10.0, ""),
              ("f32 sharper", torch.float32, levels[0], 100.0, ""),
              ("f32 slice edges", torch.float32, (2, 300, 200, 520, 264),
               1.0, ""),
              ("f32 slice edges", torch.float32, (2, 65, 129, 513, 257),
               1.0, ""),
              ("f32 slice edges", torch.float32, (2, 130, 200, 1030, 515),
               1.0, ""),
              ("f32 stride-0 K/V", torch.float32, (4, 200, 330, 448, 256),
               1.0, "kv"),
              ("f32 stride-0 Q", torch.float32, (4, 200, 330, 448, 256),
               1.0, "q")]
    for tag, dtype, shape, score_std, bcast in cases:
        e4, e5 = _k45_check(g, tag, dtype, shape, score_std, bcast,
                            parent if tag == "f32" and shape in levels
                            else None)
        suffix = "" if dtype == torch.bfloat16 else " f32"
        errs["K4" + suffix] = max(errs["K4" + suffix], e4)
        errs["K5" + suffix] = max(errs["K5" + suffix], e5)
    log("  K4 and K5, bf16 and f32: a second launch gives the same bits at "
        "every shape")
    torch.cuda.synchronize()
    return errs


def ring_hop_shapes():
    """The (query shard, key block) shapes of the ring's backward over
    RING_BLOCKS ranks: K3_LEVELS (bf16, batch K3_BATCH) and TRAIN_LEVELS
    (f32, batch TRAIN_BATCH) with n and m cut by RING_BLOCKS."""
    return ([(torch.bfloat16, (K3_BATCH, n // RING_BLOCKS, n // RING_BLOCKS,
                               d, c)) for n, d, c in K3_LEVELS]
            + [(torch.float32, (TRAIN_BATCH, n // RING_BLOCKS,
                                n // RING_BLOCKS, d, c))
               for n, d, c in TRAIN_LEVELS])


def phase_kernels_ring(g):
    """[3]'s K4 and K5 at the ring backward's hop shapes
    (``ring_hop_shapes``), launched twice for the same bits, against the
    plain version (bf16, 2^-6 of each output's scale) and the float64
    evaluation (f32, 1e-4), as ``phase_kernels_k45``."""
    log("[3] K4 and K5 at the ring backward's hop shapes")
    errs = {"K4/K5 ring hop": 0.0, "K4/K5 ring hop f32": 0.0}
    for dtype, shape in ring_hop_shapes():
        key = "K4/K5 ring hop" + ("" if dtype == torch.bfloat16 else " f32")
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        errs[key] = max(errs[key], *_k45_check(g, f"{tag} ring hop", dtype,
                                               shape, 1.0, ""))
    apply_precision(torch.bfloat16)
    torch.cuda.synchronize()
    return errs


def _k45_check(g, tag, dtype, shape, score_std, bcast, parent=None):
    """One K4/K5 case of ``phase_kernels_k45``, both launched twice for
    the same bits; with ``parent``, K5 also against the parent's bits.
    Returns the worst dQ and dK/dV errors."""
    apply_precision(dtype)
    args = k45_inputs(g, *shape, dtype, score_std, bcast)
    CHECKED.update(_k3_key(*args[:3], kid) for kid in ("K4", "K5"))
    dq = adaattn_attention.softmax_attention_dq(*args)
    dk, dv = adaattn_attention.softmax_attention_dkv(*args)
    if not (torch.equal(dq, adaattn_attention.softmax_attention_dq(*args))
            and all(torch.equal(a, b) for a, b in zip(
                (dk, dv), adaattn_attention.softmax_attention_dkv(*args)))):
        raise AssertionError(f"K4/K5 {tag} {shape}: two launches differ")
    ref = args
    if dtype == torch.float32:   # the float64 evaluation
        q, k, v, lse, dd, dm1, dm2 = args
        ref = (q.double(), k.double(), v.double(), lse, dd, dm1.double(),
               dm2.double())
    pq = adaattn_attention.softmax_attention_dq_plain(*ref)
    pk, pv = adaattn_attention.softmax_attention_dkv_plain(*ref)
    tol = 2 * BF16_ULP if dtype == torch.bfloat16 else 1e-4
    name = f"{tag} {shape}"
    e4 = check(f"K4 {name} dQ", dq, pq, tol)
    e5 = max(check(f"K5 {name} dK", dk, pk, tol),
             check(f"K5 {name} dV", dv, pv, tol))
    if parent is not None:
        if not all(torch.equal(a, b) for a, b in zip((dk, dv),
                                                     parent(*args))):
            raise AssertionError(f"K5 f32 {shape}: differs from the "
                                 f"parent's")
        log(f"  K5 f32 {shape}: the same bits as the parent's")
    return e4, e5


def _image_batch(rng, b, size):
    return [torch.from_numpy(rng.integers(0, 256, (b, *size, 3))
                             .astype(np.float32)).cuda() for _ in range(2)]


def phase_model_train():
    """One f32 AdaAttN image step at 1×64² (VGG19 seed 0, AdaAttN seed 1)
    through K3-K5 and through their plain versions: the metrics to 1e-5
    relative, every parameter gradient to 5e-2 of its scale but the g
    (key) conv biases'.  The seeded model's gradients are small
    differences of large float32 terms: JAX's own float32 gradients lie up
    to 4% of their scale from its float64 ones in the decoder's early
    layers, and more in the attention convs, where A·V² − (A·V)² sits at
    the 1e-6 clamp of the variance (tests/test_torch_adaattn_train.py).
    Softmax is invariant to the g bias (it adds one constant to a query's
    scores), so its true gradient is 0 and what either side computes is
    float32 noise: printed, not held."""
    apply_precision(torch.float32)
    cfg = AdaAttNImageConfig(batch_size=1)
    batch = _image_batch(np.random.default_rng(7), 1, (64, 64))
    runs = []
    for plain in (False, True):
        state = create(init_stylizing_network(1, device="cuda"), cfg.lr)
        step = make_adaattn_image_step(
            cfg, init_vgg19_adaattn(0, device="cuda"))
        with plain_kernels() if plain else contextlib.nullcontext():
            _, metrics = step(state, batch)
        runs.append(({k: float(v) for k, v in metrics.items()},
                     {k: p.grad for k, p in state.model.named_parameters()}))
    (mk, gk), (mp, gp) = runs
    for key in mk:
        err = abs(mk[key] - mp[key]) / abs(mp[key])
        log(f"  AdaAttN f32 64² train step {key}: kernels {mk[key]:.8e} "
            f"plain {mp[key]:.8e}, relative {err:.3e} tol 1e-5")
        if not err <= 1e-5:
            raise AssertionError(f"train step {key}: {err}")
    rel = {k: _rel_err(gk[k], gp[k]) for k in gp if gp[k].abs().max() > 0}
    held = {k: v for k, v in rel.items() if not k.endswith(".g.bias")}
    worst = max((v, k) for k, v in held.items())
    att = ", ".join(f"{k} {v:.1e}" for k, v in rel.items()
                    if k.startswith("adaattn."))
    log(f"  gradients of {len(held)} of {len(rel)} parameters held: worst "
        f"relative {worst[0]:.3e} ({worst[1]}) tol 5e-2; attention convs "
        f"(g biases not held): {att}")
    if not worst[0] <= 5e-2 or not all(torch.isfinite(g).all()
                                       for g in gk.values()):
        raise AssertionError(f"gradient {worst[1]}: {worst[0]}")


def phase_model():
    log("[4] model: kernels against plain versions, and the goldens")
    apply_precision(torch.float32)
    model = init_reconet(0, device="cuda")
    x = torch.from_numpy((np.random.default_rng(1).random((1, 256, 256, 3))
                          * 255).astype(np.float32)).cuda()
    with torch.inference_mode():
        ours = model(x)
        with plain_kernels():
            ref = model(x)
    reset_counts()
    graded = model(x)   # grad mode on: K1/K2 as their autograd Functions
    same = all(torch.equal(a.detach(), b) for a, b in zip(graded, ours))
    log(f"  ReCoNet f32 forward with grad mode on: K1, K2 launches "
        f"{counts()[:2]}, outputs bitwise those of inference mode: {same}")
    if not same or counts()[:2] != (10, 2):
        raise AssertionError("ReCoNet forward with grad mode on")
    del graded
    for i, (o, r) in enumerate(zip(ours, ref)):
        err = max_err(o, r)
        log(f"  ReCoNet f32 256² tap {i}: max_abs_err {err:.3e} tol 2e-3")
        if not err <= 2e-3:
            raise AssertionError(f"tap {i}: {err}")
    with np.load(os.path.join(ROOT, "tests", "goldens",
                              "reference_numerics.npz")) as z:
        gold = {k: z[k] for k in z.files}
    xg = torch.from_numpy(gold["input_x"]).cuda()
    for init, key in ((init_reconet, "reconet_styled"),
                      (init_reconet_sd1, "sd1_styled"),
                      (init_reconet_sd2, "sd2_styled")):
        with torch.inference_mode():
            out = init(7, device="cuda")(xg)[-1].cpu().numpy()
        err = float(np.abs(out - gold[key]).max())
        log(f"  golden {key}: max_abs_err {err:.3e} tol 2e-3")
        if not err <= 2e-3:
            raise AssertionError(f"{key}: {err}")
    phase_model_rtnstv(gold)
    phase_model_adaattn(gold)
    phase_model_train()


def _ada_models(seed_vgg, seed_ada, dtype):
    return (init_vgg19_adaattn(seed_vgg, device="cuda", dtype=dtype),
            init_stylizing_network(seed_ada, device="cuda", dtype=dtype))


def _rel_err(a, b):
    return max_err(a, b) / b.float().abs().max().item()


def phase_model_adaattn(gold):
    """The f32 AdaAttN forward at 1×256²: softmax through K3 against the
    plain version (tolerance 2e-3 of the output scale, the JAX package's
    model tolerance), cosine's linear form against the materialized oracle;
    then both goldens (seed-7 inits at 32², 5e-2 as tests/test_goldens.py)
    with K3's launches counted."""
    apply_precision(torch.float32)
    vgg, net = _ada_models(0, 1, torch.float32)
    rng = np.random.default_rng(5)
    c, s = (torch.from_numpy((rng.random((1, 256, 256, 3)) * 255)
                             .astype(np.float32)).cuda() for _ in range(2))
    with torch.inference_mode():
        fc, fs = vgg(c), vgg(s)
        for act, ref_mode in (("softmax", None), ("cosine", "exact")):
            ours = net(fc, fs, act)
            if ref_mode is None:
                with plain_kernels():
                    ref = net(fc, fs, act)
            else:
                ref = net(fc, fs, act, ref_mode)
            err = _rel_err(ours, ref)
            log(f"  AdaAttN f32 256² {act}: max_abs_err {max_err(ours, ref):.3e}"
                f", relative {err:.3e} tol 2e-3")
            if not err <= 2e-3:
                raise AssertionError(f"AdaAttN {act}: {err}")
        xg = torch.from_numpy(gold["input_x"]).cuda()
        sg = torch.from_numpy(gold["input_s"]).cuda()
        vgg7, net7 = _ada_models(7, 7, torch.float32)
        for act in ("softmax", "cosine"):
            reset_counts()
            out = net7(vgg7(xg), vgg7(sg), act).cpu().numpy()
            launches = counts()[2]
            err = float(np.abs(out - gold[f"adaattn_{act}"]).max())
            log(f"  golden adaattn_{act}: max_abs_err {err:.3e} tol 5e-2; "
                f"K3 launches {launches}")
            if not err <= 5e-2 or launches != (3 if act == "softmax" else 0):
                raise AssertionError(f"adaattn_{act}: {err}, K3 {launches}")


def phase_main_path():
    """Full-width ReCoNet, 512² batch 8 bf16, then the streaming loop."""
    log("[5] main path: ReCoNet 48/96/192, bf16")
    model = init_reconet(0, device="cuda", dtype=torch.bfloat16)
    rng = np.random.default_rng(2)
    x = rng.integers(0, 256, (8, 512, 512, 3)).astype(np.uint8)
    clip = list(rng.integers(0, 256, (96, 360, 640, 3)).astype(np.uint8))
    forwards = 0

    reset_counts()
    out = stylize_reconet(model, x, uint8_out=True)
    i420 = stylize_reconet(model, x, wire="i420")
    raw = stylize_reconet(model, x)
    forwards += 3
    if not (torch.isfinite(raw).all() and raw.min() >= 0 and raw.max() <= 255):
        raise AssertionError("styled frames not finite or outside 0..255")
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        stylize_reconet(model, x, uint8_out=True)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        forwards += 1
    stream = StreamingStylizer(
        lambda b: stylize_reconet(model, b, uint8_out=True), iter(clip),
        batch_size=8, pipeline_depth=3)
    t0 = time.perf_counter()
    styled = list(stream)
    stream_s = time.perf_counter() - t0
    forwards += 96 // 8
    k1, k2, k3, k4, k5 = counts()

    log(f"  launches: K1 {k1}, K2 {k2}, K3 {k3}, K4 {k4}, K5 {k5} over "
        f"{forwards} forwards")
    if (k1, k2, k3, k4, k5) != (10 * forwards, 2 * forwards, 0, 0, 0):
        raise AssertionError(f"expected K1 {10 * forwards}, K2 "
                             f"{2 * forwards}, K3-K5 0 launches")
    if out.shape != (8, 512, 512, 3) or out.dtype != torch.uint8:
        raise AssertionError(f"uint8 wire: {tuple(out.shape)} {out.dtype}")
    if i420.shape != (8, 768, 512) or not torch.equal(i420, rgb_to_i420(out)):
        raise AssertionError("i420 wire differs from rgb_to_i420(uint8 out)")
    # Against the float32 forward of the same weights on the first frame:
    # bf16 values between 128 and 256 are 1.0 apart, and the truncating
    # cast may move one more step, so allow 2.
    apply_precision(torch.float32)
    ref32 = stylize_reconet(init_reconet(0, device="cuda"), x[:1],
                            uint8_out=True)
    diff32 = (ref32.int() - out[:1].int()).abs().max().item()
    log(f"  bf16 vs f32 forward, uint8 frame 0: max |diff| {diff32} (tol 2)")
    if diff32 > 2:
        raise AssertionError(f"bf16 output differs from f32 by {diff32}")
    if len(styled) != 96 or any(f.shape != (360, 640, 3) or f.dtype != np.uint8
                                for f in styled):
        raise AssertionError("streamed frames: wrong count, shape or dtype")
    first = stylize_reconet(model, np.stack(clip[:8]), uint8_out=True).cpu()
    diff = np.abs(first.numpy().astype(int)
                  - np.stack(styled[:8]).astype(int)).max()
    if diff > 1:
        raise AssertionError(f"streamed frames differ from a direct batch "
                             f"by {diff}")
    ms = float(np.median(times))
    log(f"  512² b8 bf16 stylize_reconet: {ms:.3f} ms/batch (median of 5) "
        f"→ {8e3 / ms:.1f} frames/s; runs {[round(t, 3) for t in times]}")
    log(f"  StreamingStylizer 96×640×360, batch 8, depth 3: {stream_s:.3f} s "
        f"→ {96 / stream_s:.1f} frames/s")
    return {"K1": k1, "K2": k2}


def reconet_f32_batch():
    """The f32 ReCoNet 512² batch 8 through ``stylize_reconet`` from the
    same seeded ``init_reconet(0)`` weights as the bf16 path (the dtype a
    reference .pth or a JAX .npz loads in): one warmup and 5 timed
    batches, launch counts set to 0 just before and read just after.
    Returns (median ms, the runs, the counts)."""
    apply_precision(torch.float32)
    model = init_reconet(0, device="cuda")
    x = np.random.default_rng(2).integers(0, 256, (8, 512, 512, 3)).astype(
        np.uint8)
    reset_counts()
    out = stylize_reconet(model, x, uint8_out=True)
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        stylize_reconet(model, x, uint8_out=True)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = counts()
    if out.shape != (8, 512, 512, 3) or out.dtype != torch.uint8:
        raise AssertionError(f"f32 uint8 wire: {tuple(out.shape)} {out.dtype}")
    return float(np.median(times)), times, launches


def phase_main_f32():
    """Full-width ReCoNet, 512² batch 8 float32: K1 10 and K2 2 launches
    per forward, nothing else."""
    log("[5] main path: ReCoNet 48/96/192, f32")
    ms, times, launches = reconet_f32_batch()
    log(f"  launches: K1-K5 {launches} over 6 forwards")
    if launches != (60, 12, 0, 0, 0):
        raise AssertionError(f"expected K1 60, K2 12, K3-K5 0 launches, got "
                             f"{launches}")
    log(f"  512² b8 f32 stylize_reconet: {ms:.3f} ms/batch (median of 5) "
        f"→ {8e3 / ms:.1f} frames/s; runs {[round(t, 3) for t in times]}")
    return {"K1": launches[0], "K2": launches[1]}


ADA_SIZE = 512
ADA_FRAMES = (256, 512)   # video frames, H × W
ADA_CLIP = 24


def phase_main_adaattn():
    """Full-width AdaAttN, 512² batch 2 bf16 softmax (direct and cached),
    then AdaAttNVideoStylizer over 24 synthetic 512×256 frames at batch 4,
    softmax and cosine.  K3 must launch exactly 3 times per softmax
    forward and never in cosine."""
    log("[5] main path: AdaAttN (VGG19 to relu5_1 + 3 attention levels + "
        "decoder), 512² b2 bf16")
    dt = torch.bfloat16
    vgg, net = _ada_models(0, 1, dt)
    rng = np.random.default_rng(6)
    content = rng.integers(0, 256, (K3_BATCH, ADA_SIZE, ADA_SIZE, 3)).astype(np.uint8)
    style = rng.integers(0, 256, (1, ADA_SIZE, ADA_SIZE, 3)).astype(np.uint8)
    styles = np.repeat(style, K3_BATCH, axis=0)
    clip = list(rng.integers(0, 256, (ADA_CLIP, *ADA_FRAMES, 3)).astype(np.uint8))

    reset_counts()
    out = stylize_adaattn(vgg, net, content, styles)
    state = adaattn_style_state(vgg, net, style)
    cached = stylize_adaattn_cached(vgg, net, content, state)
    forwards = 2   # the style state alone launches no K3
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stylize_adaattn(vgg, net, content, styles)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        forwards += 1
    stream_fps = {}
    for act in ("softmax", "cosine"):
        stylizer = AdaAttNVideoStylizer(vgg, net, clip[0][None], act,
                                        batch_size=4, pipeline_depth=3)
        t0 = time.perf_counter()
        styled = list(stylizer.stylize_frames(iter(clip)))
        stream_fps[act] = ADA_CLIP / (time.perf_counter() - t0)
        if len(styled) != ADA_CLIP or any(
                f.shape != (*ADA_FRAMES, 3) or f.dtype != np.uint8 for f in styled):
            raise AssertionError(f"AdaAttN {act} stream: count, shape or dtype")
        if act == "softmax":
            forwards += ADA_CLIP // 4
    k1, k2, k3, k4, k5 = counts()

    log(f"  launches: K3 {k3} over {forwards} softmax forwards (+ "
        f"{ADA_CLIP // 4} cosine batches); K1 {k1}, K2 {k2}, K4 {k4}, K5 {k5}")
    if (k1, k2, k3, k4, k5) != (0, 0, 3 * forwards, 0, 0):
        raise AssertionError(f"expected K3 {3 * forwards} launches, K1, K2, "
                             f"K4 and K5 0")
    if any(o.shape != content.shape or not torch.isfinite(o).all()
           or o.min() < 0 or o.max() > 255 for o in (out, cached)):
        raise AssertionError("AdaAttN styled batch not finite, in 0..255, or "
                             "of the content's shape")
    # The seeded decoder's output is small and partly negative, so the
    # comparisons read the unclamped network output.
    with torch.inference_mode():
        cuda = {"device": "cuda"}
        c16 = torch.from_numpy(content).to(**cuda, dtype=dt)
        s16 = torch.from_numpy(style).to(**cuda, dtype=dt)
        fc = vgg(c16)
        raw = net(fc, vgg(s16.expand(K3_BATCH, -1, -1, -1)))
        raw_cached = stylizing_network_cached(net, fc, state, "softmax")
        err = _rel_err(raw_cached, raw)
        log(f"  cached-style against direct, bf16: relative {err:.3e} "
            f"(tol 1e-2)")
        if not err <= 1e-2:
            raise AssertionError(f"cached AdaAttN differs from direct by {err}")
        # Against the float32 forward of the same weights on the first
        # image: bf16 through 16 VGG convs, the attention, 10 decoder convs.
        apply_precision(torch.float32)
        vgg32, net32 = _ada_models(0, 1, torch.float32)
        raw32 = net32(vgg32(c16[:1].float()), vgg32(s16.float()))
        err32 = _rel_err(raw[:1], raw32)
        log(f"  bf16 vs f32 forward, image 0: relative {err32:.3e} (tol 5e-2)")
        if not err32 <= 5e-2:
            raise AssertionError(f"bf16 AdaAttN differs from f32 by {err32}")
    ms = float(np.median(times))
    log(f"  512² b2 bf16 stylize_adaattn softmax: {ms:.3f} ms/batch (median "
        f"of 5) → {2e3 / ms:.2f} frames/s; runs {[round(t, 3) for t in times]}")
    for act, fps in stream_fps.items():
        log(f"  AdaAttNVideoStylizer {act} {ADA_CLIP}×512×256, batch 4, depth "
            f"3: {fps:.2f} frames/s")
    return k3


def _train_run(label, cfg, build, batch, steps, warmup, per_step):
    """``warmup`` + ``steps`` steps of ``build(cfg, vgg)`` on one batch,
    from fresh seeded weights (VGG19 seed 0, AdaAttN seed 1), with the
    launch counts set to 0 just before and read just after.  Asserts
    finite metrics at every step, parameters that moved, and exactly
    ``per_step`` (K3, K4, K5) launches per step; returns the counts and
    the median ms of the timed steps (None without any).
    "Moved" counts parameter tensors: with seeded weights half the
    decoder's ReLUs are dead, so many single weights get no gradient, and
    the g conv biases (softmax is invariant to them) get one below what
    Adam's step can show in float32."""
    state = create(init_stylizing_network(1, device="cuda"), cfg.lr)
    step = build(cfg, init_vgg19_adaattn(0, device="cuda"))
    before = [p.detach().clone() for p in state.model.parameters()]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    times, metrics = [], []
    for i in range(warmup + steps):
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        if i >= warmup:
            times.append((time.perf_counter() - t0) * 1e3)
        metrics.append(m)
    launches = counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    total = warmup + steps
    expect = (0, 0) + tuple(n * total for n in per_step)
    bad = [i for i, m in enumerate(metrics)
           if not all(torch.isfinite(v).item() for v in m.values())]
    moved = sum(not torch.equal(a, p)
                for a, p in zip(before, state.model.parameters()))
    last = {k: round(float(v), 6) for k, v in metrics[-1].items()}
    b = batch[0].shape[0]
    log(f"  {label}: launches K1-K5 {launches} over {total} steps; metrics "
        f"finite at every step, last {last}; {moved} of {len(before)} "
        f"parameter tensors moved; peak {peak:.2f} GiB")
    ms = float(np.median(times)) if times else None
    if times:
        log(f"  {label}: {ms:.3f} ms/step median of {steps} (min "
            f"{min(times):.3f}, max {max(times):.3f}) -> {b * 1e3 / ms:.2f} "
            f"samples/s (min {b * 1e3 / max(times):.2f}, max "
            f"{b * 1e3 / min(times):.2f})")
    if bad or launches != expect or moved < len(before) - 3:
        raise AssertionError(f"{label}: non-finite steps {bad}, launches "
                             f"{launches} (expected {expect}), moved {moved}")
    return launches, ms


def phase_main_train():
    """AdaAttN training at the configs' own settings from synthetic seeded
    0-255 batches: the image trainer (256² crop, batch 8, softmax, lr 1e-4)
    in f32 (the default) and bf16, 2 warmup and 6 timed steps each, K3 6,
    K4 3 and K5 3 launches per step; the video trainer (256×512, batch 4,
    cosine, f32), 3 steps, no K3-K5 launch."""
    log("[5] main path: AdaAttN training (image 256² b8 softmax, video "
        "256×512 b4 cosine)")
    rng = np.random.default_rng(8)
    cfg = AdaAttNImageConfig()
    batch = _image_batch(rng, cfg.batch_size, cfg.crop_size)
    total, ms = [0, 0, 0], {}
    for dtype in ("float32", "bfloat16"):
        c = dataclasses.replace(cfg, dtype=dtype)
        launches, ms[dtype] = _train_run(
            f"image {dtype}", c, make_adaattn_image_step, batch, 6, 2,
            (6, 3, 3))
        total = [a + b for a, b in zip(total, launches[2:])]
    vcfg = AdaAttNVideoConfig()
    vbatch = [torch.from_numpy(rng.integers(0, 256, (vcfg.batch_size,
                                                     *vcfg.frame_size, 3))
                               .astype(np.float32)).cuda() for _ in range(3)]
    _train_run("video float32 cosine", vcfg, make_adaattn_video_step, vbatch,
               3, 0, (0, 0, 0))
    return dict(zip(("K3", "K4", "K5"), total)), ms["float32"]


class SyntheticPairs:
    """The AdaAttN datasets' protocol on synthetic data (the card's machine
    has no PIL): ``count`` HWC float32 0-255 arrays of integers per item,
    drawn from ``default_rng((seed, epoch, idx))`` as ``CocoWikiArt``
    draws its crops, and ``set_epoch``."""

    def __init__(self, n, size, seed, count=2):
        self.n, self.size, self.seed, self.count = n, size, seed, count
        self._epoch = 0

    def set_epoch(self, epoch):
        self._epoch = epoch

    def __len__(self):
        return self.n

    def __getitem__(self, idx):
        rng = np.random.default_rng((self.seed, self._epoch, idx))
        return tuple(rng.integers(0, 256, (*self.size, 3)).astype(np.float32)
                     for _ in range(self.count))


LOOP_OUT = os.path.join(ROOT, "build", "chip_smoke_loop")
LOOP_NAME = "adaattn-image"


def _recording(step, sums, preempt_at=None):
    """``step`` that first records its batch's sums on the card (exact: the
    pixels are integers) and, at global step ``preempt_at``, sends SIGUSR1
    to this process while the step is in flight."""
    def wrapped(state, batch):
        if state.step == preempt_at:
            os.kill(os.getpid(), signal.SIGUSR1)
        sums.append(torch.stack([x.double().sum() for x in batch]))
        return step(state, batch)
    return wrapped


def _jsonl(path):
    with open(path) as f:
        return {r["step"]: r for r in map(json.loads, f)}


def _loop_prefetch(ds, batch_size):
    """BatchLoader + device_prefetch(size=2) over one epoch: each batch
    is read on the card only behind a long matmul and released at once,
    and its copy must equal its host source bit for bit."""
    host, dev = [], []

    def recorded(it):
        for b in it:
            host.append(b)
            yield b

    a = torch.randn(4096, 4096, device="cuda")
    loader = BatchLoader(ds, batch_size, seed=12, num_workers=4)
    for batch in device_prefetch(recorded(iter(loader)), 2, "cuda"):
        busy = a @ a
        dev.append([x.clone() for x in batch])
        del batch, busy
    torch.cuda.synchronize()
    same = [np.array_equal(d.cpu().numpy(), h)
            for dev_b, host_b in zip(dev, host, strict=True)
            for d, h in zip(dev_b, host_b, strict=True)]
    log(f"  prefetch: {len(dev)} batches of {len(host[0])} tensors "
        f"{tuple(host[0][0].shape)}, {sum(same)} of {len(same)} tensors "
        f"bitwise equal to their host source")
    if not (all(same) and len(dev) == len(loader)):
        raise AssertionError("device_prefetch: a batch differs from its source")


def _rel_l2(a, b, keys):
    num = sum(float((a[k].double() - b[k].double()).square().sum())
              for k in keys)
    den = sum(float(b[k].double().square().sum()) for k in keys)
    return (num / den) ** 0.5


def _loop_costs(ds, batch_size, state, extra_ms, steps):
    """What the loop adds to the bare steps, each part timed alone on this
    run's data and state: one batch's host work (decode by the loader's
    threads, stack, pin), the rollback snapshot (model and Adam state to
    the host) and each epoch-end write."""
    it = iter(BatchLoader(ds, batch_size, seed=12, num_workers=4))
    host_ms = []
    for _ in range(len(ds) // batch_size):
        t = time.perf_counter()
        [torch.from_numpy(x).pin_memory() for x in next(it)]
        host_ms.append((time.perf_counter() - t) * 1e3)
    out = os.path.join(LOOP_OUT, "costs")
    os.makedirs(out, exist_ok=True)
    torch.cuda.synchronize()
    ms = {}
    for name, fn in (
            ("snapshot", lambda: ckpt.snapshot(state)),
            ("save_params .npz", lambda: ckpt.save_params(
                snap["model"], os.path.join(out, "p.npz"))),
            ("save_state", lambda: ckpt.save_state(
                snap, os.path.join(out, "state"))),
            ("export_pth", lambda: ckpt.export_pth(
                snap["model"], os.path.join(out, "p.pth")))):
        t = time.perf_counter()
        r = fn()
        ms[name] = (time.perf_counter() - t) * 1e3
        if name == "snapshot":
            snap = r
    mb = sum(v.numel() * v.element_size() for v in snap["model"].values())
    log(f"  loop costs: {extra_ms:.1f} ms over {steps} × the bare step "
        f"between the log points (one drain: the log point's metric fetch "
        f"waits for the card, then the next batch's host work runs before "
        f"the card has work again); one batch's host work "
        f"{float(np.median(host_ms)):.1f} ms median (decode by 4 threads, "
        f"stack, pin; {[round(t, 1) for t in host_ms]}); "
        + "; ".join(f"{k} {v:.1f} ms" for k, v in ms.items())
        + f" (the model {mb / 2**20:.1f} MiB, with Adam's moments "
        f"{3 * mb / 2**20:.1f} MiB)")


def phase_main_loop(bare_ms):
    """The AdaAttN image trainer through ``run_training`` at its config's
    settings (256² b8 softmax f32; VGG19 seed 0, AdaAttN seed 1) on 32
    synthetic pairs (4 batches an epoch): the prefetch, an uninterrupted
    2-epoch run (launch counts, finite metrics, checkpoints reloaded), a
    run preempted at epoch 1 batch 3 and resumed through the CLI's
    ``resume_position`` (same batches, losses within rtol 1e-3,
    parameters within 1e-4 relative L2), the loop's samples/s beside
    [5]'s bare step (one more epoch of the uninterrupted run's state, at
    the CLI's defaults), and the video trainer for 2 steps through the
    loop."""
    log("[5b] main path: AdaAttN trainer through the loop (run_training, "
        "image 256² b8 softmax f32, 32 synthetic pairs)")
    t_phase = time.perf_counter()
    apply_precision(torch.float32)
    cfg = AdaAttNImageConfig()
    ds = SyntheticPairs(32, cfg.crop_size, seed=11)
    n_batches = len(ds) // cfg.batch_size
    _loop_prefetch(ds, cfg.batch_size)
    shutil.rmtree(LOOP_OUT, ignore_errors=True)
    vgg = init_vgg19_adaattn(0, device="cuda")
    step = make_adaattn_image_step(cfg, vgg)
    net = init_stylizing_network(1, device="cuda")

    def fresh():
        return create(copy.deepcopy(net), cfg.lr)

    def indented(msg):
        log(f"    {msg}")

    kw = dict(batch_size=cfg.batch_size, model_name=LOOP_NAME, seed=12,
              num_workers=4, log_fn=indented)
    run = dict(epochs=2, log_every=1, save_every_steps=2, **kw)

    # uninterrupted
    out_a = os.path.join(LOOP_OUT, "full")
    sums_a = []
    state_a = fresh()
    torch.cuda.synchronize()
    reset_counts()
    state_a = run_training(_recording(step, sums_a), state_a, ds,
                           out_dir=out_a, metrics_jsonl=os.path.join(
                               out_a, "metrics.jsonl"), **run)
    torch.cuda.synchronize()
    launches = counts()
    steps = 2 * n_batches
    expect = (0, 0, 6 * steps, 3 * steps, 3 * steps)
    rec_a = _jsonl(os.path.join(out_a, "metrics.jsonl"))
    finite = all(v is not None and math.isfinite(v) for r in rec_a.values()
                 for k, v in r.items() if k.startswith("loss"))
    files = sorted(os.listdir(out_a))
    want = [f"{LOOP_NAME}_epoch_{e}_batchSize_{cfg.batch_size}{x}"
            for e in (1, 2) for x in (".npz", ".pth")] + [
                f"{LOOP_NAME}_last_state"]
    npz = load_weights(os.path.join(out_a, want[2]))
    live = {k: v.cpu() for k, v in state_a.model.state_dict().items()}
    reload_ok = npz.keys() == live.keys() and all(
        torch.equal(npz[k], live[k]) for k in live)
    log(f"  uninterrupted: launches K1-K5 {launches} over {steps} steps "
        f"(expected {expect}); {len(rec_a)} logged steps, losses finite: "
        f"{finite}; files {files}; epoch 2 .npz reloads through "
        f"compat.load_weights to the model's tensors: {reload_ok}")
    if (launches != expect or not finite or sorted(rec_a) != list(
            range(1, steps + 1)) or not set(want) <= set(files)
            or not reload_ok):
        raise AssertionError("uninterrupted loop run")

    # preempted at epoch 1 batch 3, resumed as --resume auto resumes
    out_b = os.path.join(LOOP_OUT, "preempted")
    sums_b = []
    try:
        run_training(_recording(step, sums_b, preempt_at=2), fresh(), ds,
                     out_dir=out_b, metrics_jsonl=os.path.join(
                         out_b, "metrics.jsonl"), **run)
    except TrainingPreempted as e:
        log(f"  preempted: {e}")
    else:
        raise AssertionError("the SIGUSR1 run was not preempted")
    state_b = fresh()
    epoch_start, start_batch = resume_position(
        state_b, "auto", out_b, LOOP_NAME, 1, n_batches, log=indented)
    state_b = run_training(_recording(step, sums_b), state_b, ds,
                           out_dir=out_b, epoch_start=epoch_start,
                           start_batch=start_batch, metrics_jsonl=os.path.join(
                               out_b, "metrics.jsonl"), **run)
    same_data = torch.equal(torch.stack(sums_a).cpu(),
                            torch.stack(sums_b).cpu())
    rec_b = _jsonl(os.path.join(out_b, "metrics.jsonl"))
    loss_err = max(abs(rec_b[s][k] - rec_a[s][k]) / abs(rec_a[s][k])
                   for s in rec_b for k in rec_b[s] if k.startswith("loss"))
    pa = {k: v.cpu() for k, v in state_a.model.state_dict().items()}
    pb = {k: v.cpu() for k, v in state_b.model.state_dict().items()}
    held = [k for k in pa if not k.endswith(".g.bias")]
    rel = _rel_l2(pb, pa, held)
    rel_all = _rel_l2(pb, pa, list(pa))
    log(f"  resumed at epoch {epoch_start} batch {start_batch + 1}: "
        f"{len(sums_b)} batches, the same as the uninterrupted run's: "
        f"{same_data}; logged steps {sorted(rec_b)}, losses max relative "
        f"{loss_err:.3e} tol 1e-3; parameters relative L2 {rel:.3e} tol "
        f"1e-4 (all but the g biases; with them {rel_all:.3e}); step "
        f"{state_b.step}")
    if not (same_data and (epoch_start, start_batch) == (1, 3)
            and sorted(rec_b) == [s for s in rec_a if s != 3]
            and loss_err <= 1e-3 and rel <= 1e-4
            and state_b.step == state_a.step == steps):
        raise AssertionError("preempted and resumed loop run")

    # the loop's rate at the CLI's defaults (no periodic saves), one
    # epoch timed after the runs above warmed the same loop (epoch 3 of
    # the uninterrupted run's state)
    out_t = os.path.join(LOOP_OUT, "timed")
    stamps = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state_t = run_training(
        step, state_a, ds, out_dir=out_t, epochs=3, epoch_start=3,
        **{**kw, "log_every": n_batches - 1,
           "log_fn": lambda m: stamps.append((time.perf_counter(), m))})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    between_ms = (stamps[-1][0] - stamps[0][0]) * 1e3
    steady = (n_batches - 1) * cfg.batch_size * 1e3 / between_ms
    logged = float(stamps[-1][1].split("(")[1].split()[0])
    bare = cfg.batch_size * 1e3 / bare_ms
    log(f"  loop samples/s, f32 256² b8, one epoch of {n_batches} steps "
        f"after the runs above: {steady:.2f} between its first and last "
        f"log point ({100 * (steady / bare - 1):+.1f}% against [5]'s bare "
        f"step {bare:.2f} = {bare_ms:.3f} ms median); {logged:.3g} as the "
        f"loop logs it (from the loader's start); "
        f"{n_batches * cfg.batch_size / wall:.2f} over the whole call "
        f"({wall * 1e3:.1f} ms, epoch-end checkpoints included)")
    _loop_costs(ds, cfg.batch_size, state_t, between_ms
                - (n_batches - 1) * bare_ms, n_batches - 1)

    # the video trainer, 2 steps through the loop: no K3-K5
    vcfg = AdaAttNVideoConfig()
    vds = SyntheticPairs(2 * vcfg.batch_size, vcfg.frame_size, seed=13,
                         count=3)
    vstep = make_adaattn_video_step(vcfg, vgg)
    vlogs = []
    reset_counts()
    vstate = run_training(vstep, create(net, vcfg.lr), vds,
                          batch_size=vcfg.batch_size, epochs=1,
                          out_dir=os.path.join(LOOP_OUT, "video"),
                          model_name="adaattn-video", log_every=1,
                          num_workers=4, log_fn=vlogs.append)
    torch.cuda.synchronize()
    vlaunches = counts()
    log(f"  video 256×512 b4 cosine, 2 steps through the loop: launches "
        f"K1-K5 {vlaunches}; {vlogs[-1]}")
    if vlaunches != (0,) * 5 or vstate.step != 2 or "nan" in " ".join(vlogs):
        raise AssertionError("video loop run")
    shutil.rmtree(LOOP_OUT, ignore_errors=True)
    log(f"  [5b] wall {time.perf_counter() - t_phase:.1f} s")
    return dict(zip(("K3", "K4", "K5"), launches[2:]))


# ------------------------------------------------------- ReCoNet training

RECONET_OUT = os.path.join(ROOT, "build", "chip_smoke_reconet")
# biases of the convs an instance norm follows: their true gradient is 0,
# so both routes hold float32 noise there (and Adam turns it into ±lr steps)
_IN_BIAS = ("conv1.conv2d.bias", "conv2.conv2d.bias", "conv3.conv2d.bias",
            "deconv1.conv2d.bias", "deconv2.conv2d.bias")


def _before_norm(key):
    return key.startswith("res") and key.endswith("conv2d.bias") or (
        key in _IN_BIAS)


def _vjp(fn, args, cot):
    """Every input's gradient of ``fn(*args)`` (a tuple or one tensor)
    under the cotangents ``cot``, in float64."""
    leaves = [a.detach().requires_grad_() for a in args]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    torch.autograd.backward(outs, tuple(c.to(o.dtype)
                                        for c, o in zip(cot, outs)))
    return [leaf.grad.double() for leaf in leaves]


def _k1_plain64(*a):
    return res_block.Conv3x3InStats.apply(
        *a, *([None] * (6 - len(a))), res_block.conv3x3_in_stats_plain)


def _k2_plain64(x, w):
    return head_conv.Conv3x3Valid.apply(x, w, head_conv.conv3x3_valid_plain)


# the f32 flow step's shapes at 360×640, batch 2 (the frame pair in one
# batch of 4): the residual stack at 90×160×192 and the 9×9 stem and head
# on the 92×162 packed input
RC_K1 = (4, 90, 160, 192)
RC_K2 = {"stem": (4, 92, 162, 48, 768), "head": (4, 92, 162, 768, 48)}


def _k1_grad_inputs(g, dtype, prologue):
    n, h, w, c = RC_K1
    args = [rnd(g, RC_K1, 2.0), rnd(g, (3, 3, c, c), 1 / (3 * c ** 0.5)),
            rnd(g, (c,), 0.1)]
    args = [a.to(dtype) for a in args]
    if prologue:
        args += [torch.stack([rnd(g, (n, c)), rnd(g, (n, c), 0.2, shift=1.0)
                              .abs()], 1),
                 rnd(g, (c,), 0.3, shift=1.0), rnd(g, (c,), 0.1)]
    return args, (rnd(g, RC_K1), rnd(g, (n, 2, c)))


def _k2_grad_inputs(g, dtype, shape):
    n, hp, wp, c, co = shape
    return ([rnd(g, (n, hp, wp, c), 50.0, dtype),
             rnd(g, (3, 3, c, co), 1 / (3 * c ** 0.5), dtype)],
            (rnd(g, (n, hp - 2, wp - 2, co)),))


# tolerance on each input's gradient, of its largest element, against the
# float64 plain route on the same (rounded) inputs: f32 3xTF32 forwards and
# f32 library backwards sit near 1e-6 of the scale (the f32 K1/K2
# forward within 1e-6 of float64); bf16 rounds y, the prologue output and
# the gradient of the kernel's input to bf16 (2⁻⁹ relative each)
GRAD_TOLS = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


def _k1_k2_grad_checks(g):
    """K1's and K2's autograd Functions on the card (kernel forward,
    library backward) against the same Functions' plain route in float64
    on the card, at the f32 flow step's block shapes, f32 and bf16."""
    errs = {}
    names = ("x", "w", "b", "stats_in", "gamma", "beta")
    for dtype, tol in GRAD_TOLS.items():
        tag = "f32" if dtype == torch.float32 else "bf16"
        for prologue in (False, True):
            args, cot = _k1_grad_inputs(g, dtype, prologue)
            ours = _vjp(res_block.conv3x3_in_stats, args, cot)
            ref = _vjp(_k1_plain64, [a.double() for a in args], cot)
            e = [max_err(a, r) / r.abs().max().item()
                 for a, r in zip(ours, ref)]
            log(f"  K1 Function {tag} {RC_K1}{' prologue' if prologue else ''}"
                f": gradient errors of the largest against float64 "
                + ", ".join(f"{k} {v:.2e}" for k, v in zip(names, e))
                + f" tol {tol:.0e}")
            errs[f"K1 {tag}{' prologue' if prologue else ''}"] = max(e)
            if not max(e) <= tol:
                raise AssertionError(f"K1 {tag} gradient: {e}")
        for part, shape in RC_K2.items():
            args, cot = _k2_grad_inputs(g, dtype, shape)
            ours = _vjp(head_conv.conv3x3_valid, args, cot)
            ref = _vjp(_k2_plain64, [a.double() for a in args], cot)
            e = [max_err(a, r) / r.abs().max().item()
                 for a, r in zip(ours, ref)]
            log(f"  K2 Function {tag} {part} {shape}: gradient errors x "
                f"{e[0]:.2e}, w {e[1]:.2e} tol {tol:.0e}")
            errs[f"K2 {tag} {part}"] = max(e)
            if not max(e) <= tol:
                raise AssertionError(f"K2 {tag} {part} gradient: {e}")
    return errs


def _k1_k2_step_times(g):
    """Event times per f32 flow step of what K1 and K2 do in it: the
    forwards (kernels; 5 launches without and 5 with the prologue, the stem
    and the head) and their backwards (the VJPs' library convolutions and
    elementwise folds)."""
    apply_precision(torch.float32)
    args, (gy, gs) = _k1_grad_inputs(g, torch.float32, True)
    x, w, b, s, gm, bt = args
    y, st = res_block.conv3x3_in_stats(x, w, b)
    fwd = event_ms(lambda: res_block.conv3x3_in_stats(x, w, b))
    fwd_pro = event_ms(lambda: res_block.conv3x3_in_stats(x, w, b, s, gm, bt))
    bwd = event_ms(lambda: res_block.conv3x3_in_stats_vjp(
        x, w, b, None, None, None, y, st, gy, gs, (True, True, True, False,
                                                   False, False)))
    bwd_pro = event_ms(lambda: res_block.conv3x3_in_stats_vjp(
        x, w, b, s, gm, bt, y, st, gy, gs))
    t = {"K1 forward": 5 * (fwd + fwd_pro), "K1 backward": 5 * (bwd + bwd_pro),
         "K2 forward": 0.0, "K2 backward": 0.0}
    for part, shape in RC_K2.items():
        (xk, wk), (gk,) = _k2_grad_inputs(g, torch.float32, shape)
        t["K2 forward"] += event_ms(lambda: head_conv.conv3x3_valid(xk, wk))
        t["K2 backward"] += event_ms(
            lambda: head_conv.conv3x3_valid_vjp(xk, wk, gk))
    log("  K1/K2 per f32 flow step (event times at its shapes): "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in t.items())
        + f"; K1 per launch forward {fwd:.4f} / {fwd_pro:.4f}, backward "
        f"{bwd:.4f} / {bwd_pro:.4f} (without / with the prologue)")
    return t


def _flow_batch(rng, cfg, b=None):
    """A synthetic flow batch at ``cfg``'s size: two 0-255 integer frames
    (stacks of input_frame_num, one where the config has none), a flow of std 2 pixels, a mask of ones at
    80% of the pixels."""
    b = b or cfg.batch_size
    h, w = cfg.img_size
    c = 3 * getattr(cfg, "input_frame_num", 1)
    img = [torch.from_numpy(rng.integers(0, 256, (b, h, w, c))
                            .astype(np.float32)).cuda() for _ in range(2)]
    flow = torch.from_numpy((rng.standard_normal((b, h, w, 2)) * 2)
                            .astype(np.float32)).cuda()
    mask = torch.from_numpy((rng.random((b, h, w)) > 0.2)
                            .astype(np.float32)).cuda()
    return (*img, flow, mask)


def _style_grams(vgg, cfg, rng):
    h, w = cfg.img_size
    style = rng.integers(0, 256, (1, h, w, 3)).astype(np.float32)
    return reconet_style_grams(vgg, style)


@contextlib.contextmanager
def _float64_steps():
    """Let a step builder take ``dtype="float64"`` (the exact evaluation
    of this check; the package offers float32 and bfloat16)."""
    steps_m.DTYPES["float64"] = torch.float64
    try:
        yield
    finally:
        del steps_m.DTYPES["float64"]


def _flow_step_against_plain(vgg, grams, batch):
    """One flow step (RECONET_CANDY, 360×640 b2) from the same state three
    ways: f32 through K1/K2 (kernel forwards, library backwards), f32 and
    float64 through their plain versions (cuDNN, autograd).  Against the
    float64 step: the kernel route's metrics within 1e-4 relative, and each
    parameter gradient within max(1e-3, 2 × the plain f32 route's own
    distance) of the key's scale — the calibration of
    tests/test_train_parity.py: float32 alone puts this step's gradients
    up to 1% of their scale apart (the FTL's weight of 1e12 makes them
    differences of large terms).  The biases before an instance norm,
    whose true gradient is 0, are measured against the model's largest
    gradient."""
    return _step_against_float64(
        "flow step 360×640 b2", RECONET_CANDY,
        lambda: init_reconet(1, device="cuda"),
        lambda c: make_reconet_flow_step(c, vgg, grams), batch, _before_norm)


def _step_against_float64(label, cfg, new_model, build, batch, before_norm):
    """One step of ``build(cfg)`` from ``new_model()`` three ways (f32
    through the kernels, f32 and float64 through their plain versions),
    held as ``_flow_step_against_plain`` says; ``before_norm(key)`` names
    the biases whose true gradient is 0.  Returns the worst metric and
    gradient errors of the kernel route."""
    runs = {}
    for name, dtype, plain in (("kernels", "float32", False),
                               ("plain", "float32", True),
                               ("float64", "float64", True)):
        state = create(new_model(), cfg.lr)
        with _float64_steps(), (plain_kernels() if plain
                                else contextlib.nullcontext()):
            step = build(dataclasses.replace(cfg, dtype=dtype))
            _, m = step(state, batch)
        runs[name] = ({k: float(v) for k, v in m.items()},
                      {k: p.grad for k, p in state.model.named_parameters()})
    (mk, gk), (mp, gp), (m64, g64) = (runs[k] for k in ("kernels", "plain",
                                                        "float64"))
    merr = {k: abs(mk[k] - m64[k]) / abs(m64[k]) for k in m64}
    log(f"  {label}, f32 through the kernels against float64: "
        "metrics " + ", ".join(f"{k} {mk[k]:.6e} ({merr[k]:.1e}; plain f32 "
                               f"{abs(mp[k] - m64[k]) / abs(m64[k]):.1e})"
                               for k in m64) + " tol 1e-4")
    top = max(g.abs().max().item() for g in g64.values())
    bad, worst = [], (0.0, "", 0.0)
    for k, g in g64.items():
        scale = top if before_norm(k) else g.abs().max().item()
        ek, ep = max_err(gk[k], g) / scale, max_err(gp[k], g) / scale
        if ek > max(1e-3, 2 * ep):
            bad.append((k, ek, ep))
        worst = max(worst, (ek, k, ep))
    log(f"  gradients of {len(g64)} parameters against float64: worst "
        f"kernels {worst[0]:.3e} ({worst[1]}; plain f32 {worst[2]:.3e}), "
        f"tol max(1e-3, 2 × plain f32's) of each key's scale; the biases "
        f"before an instance norm against the largest gradient {top:.3e}")
    if bad or max(merr.values()) > 1e-4 or not all(
            torch.isfinite(g).all() for g in gk.values()):
        raise AssertionError(f"{label} against float64: {merr}, {bad}")
    return max(merr.values()), worst[0]


def _reconet_run(label, state, step, batch, steps, warmup, per_step,
                 nan_sdl=False):
    """``warmup`` + ``steps`` steps on one batch with the launch counts set
    to 0 just before and read just after: finite metrics at every step (the
    SD loss NaN at every step where ``nan_sdl``), parameters that moved,
    exactly ``per_step`` (K1, K2) launches a step; returns the counts, the
    median ms of the timed steps (None without any), and the peak GiB."""
    before = [p.detach().clone() for p in state.model.parameters()]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    times, metrics = [], []
    for i in range(warmup + steps):
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        if i >= warmup:
            times.append((time.perf_counter() - t0) * 1e3)
        metrics.append({k: float(v) for k, v in m.items()})
    launches = counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    total = warmup + steps
    expect = tuple(n * total for n in per_step) + (0, 0, 0)
    bad = [i for i, m in enumerate(metrics)
           if not all(math.isfinite(v) for k, v in m.items() if k != "SDL")
           or ("SDL" in m and math.isnan(m["SDL"]) != nan_sdl)]
    moved = sum(not torch.equal(a, p)
                for a, p in zip(before, state.model.parameters()))
    last = {k: float(f"{v:.6g}") for k, v in metrics[-1].items()}
    b = (batch if torch.is_tensor(batch) else batch[0]).shape[0]
    log(f"  {label}: launches K1-K5 {launches} over {total} steps; metrics "
        f"finite at every step{' (SDL NaN)' if nan_sdl else ''}, last {last}; "
        f"{moved} of {len(before)} parameter tensors moved; peak {peak:.2f} "
        f"GiB")
    ms = float(np.median(times)) if times else None
    if times:
        log(f"  {label}: {ms:.3f} ms/step median of {steps} (min "
            f"{min(times):.3f}, max {max(times):.3f}) -> {b * 1e3 / ms:.2f} "
            f"samples/s (min {b * 1e3 / max(times):.2f}, max "
            f"{b * 1e3 / min(times):.2f})")
    if bad or launches != expect or moved < len(before) - 3:
        raise AssertionError(f"{label}: bad steps {bad}, launches {launches} "
                             f"(expected {expect}), moved {moved}")
    return launches, ms, peak


class SyntheticFlowPairs:
    """The SceneFlow datasets' protocol on synthetic data (the card's
    machine has no PIL): (img1, img2, flow, mask) per item as
    ``_flow_batch`` draws them, from ``default_rng((seed, idx))``."""

    def __init__(self, n, size, seed):
        self.n, self.size, self.seed = n, size, seed

    def __len__(self):
        return self.n

    def __getitem__(self, idx):
        rng = np.random.default_rng((self.seed, idx))
        h, w = self.size
        return (rng.integers(0, 256, (h, w, 3)).astype(np.float32),
                rng.integers(0, 256, (h, w, 3)).astype(np.float32),
                (rng.standard_normal((h, w, 2)) * 2).astype(np.float32),
                (rng.random((h, w)) > 0.2).astype(np.float32))


def _train_tensors(state):
    """The model's and Adam's tensors of a train state, by name."""
    out = dict(state.model.state_dict())
    for i, st in state.optimizer.state_dict()["state"].items():
        out.update({f"adam.{i}.{k}": v for k, v in st.items()})
    return out


def _flow_loop(vgg, grams):
    """The flow trainer (RECONET_CANDY, 360×640 b2 f32) through
    ``run_training`` on 8 synthetic items (4 steps an epoch): an
    uninterrupted 2-epoch run (K1 80 and K2 16 launches, finite losses,
    the epoch checkpoints), and a run preempted by SIGUSR1 at epoch 1
    batch 3 and resumed through the CLI's ``resume_position``: the model
    and Adam state restored bitwise as the preempted run left them, the
    same batches, then losses within 5e-2 relative and parameters within
    5e-2 relative L2 (all but the biases before an instance norm) of the
    uninterrupted run.  The two runs are not bitwise alike before the
    preemption already: the backward sums in no fixed order (cuDNN's
    weight gradients, grid_sample's, the stem's packed weights; on the
    CPU the stem's alone), and Adam's first steps, about ±lr whatever a
    gradient's size, carry that float32 noise into the parameters: on the
    CPU at 24×32 the same check gave 1.9e-3 (losses) and 3.0e-3
    (parameters) after 8 steps."""
    cfg = RECONET_CANDY
    ds = SyntheticFlowPairs(8, cfg.img_size, seed=21)
    n_batches = len(ds) // cfg.batch_size
    shutil.rmtree(RECONET_OUT, ignore_errors=True)
    step = make_reconet_flow_step(cfg, vgg, grams)
    net = init_reconet(1, device="cuda")
    name = "reconet-candy"

    def indented(msg):
        log(f"    {msg}")

    run = dict(batch_size=cfg.batch_size, model_name=name, seed=22,
               num_workers=4, log_fn=indented, epochs=2, log_every=1,
               save_every_steps=2)
    out_a = os.path.join(RECONET_OUT, "full")
    sums_a = []
    torch.cuda.synchronize()
    reset_counts()
    state_a = run_training(_recording(step, sums_a),
                           create(copy.deepcopy(net), cfg.lr), ds,
                           out_dir=out_a, metrics_jsonl=os.path.join(
                               out_a, "metrics.jsonl"), **run)
    torch.cuda.synchronize()
    launches = counts()
    steps = 2 * n_batches
    rec_a = _jsonl(os.path.join(out_a, "metrics.jsonl"))
    finite = all(v is not None and math.isfinite(v) for r in rec_a.values()
                 for v in r.values())
    files = sorted(os.listdir(out_a))
    want = [f"{name}_epoch_{e}_batchSize_{cfg.batch_size}{x}"
            for e in (1, 2) for x in (".npz", ".pth")] + [f"{name}_last_state"]
    log(f"  loop, uninterrupted: launches K1-K5 {launches} over {steps} "
        f"steps; {len(rec_a)} logged steps, losses finite: {finite}; files "
        f"{files}")
    if (launches != (10 * steps, 2 * steps, 0, 0, 0) or not finite
            or sorted(rec_a) != list(range(1, steps + 1))
            or not set(want) <= set(files)):
        raise AssertionError("ReCoNet loop run")
    out_b = os.path.join(RECONET_OUT, "preempted")
    sums_b = []
    try:
        run_training(_recording(step, sums_b, preempt_at=2),
                     create(copy.deepcopy(net), cfg.lr), ds, out_dir=out_b,
                     metrics_jsonl=os.path.join(out_b, "metrics.jsonl"), **run)
    except TrainingPreempted as e:
        log(f"  loop, preempted: {e}")
        preempted = {k: v.detach().cpu().clone() for k, v in
                     _train_tensors(e.state).items()}
    else:
        raise AssertionError("the SIGUSR1 run was not preempted")
    state_b = create(copy.deepcopy(net), cfg.lr)
    epoch_start, start_batch = resume_position(
        state_b, "auto", out_b, name, 1, n_batches, log=indented)
    restored = _train_tensors(state_b)
    exact = restored.keys() == preempted.keys() and all(
        torch.equal(restored[k].cpu(), preempted[k]) for k in preempted)
    state_b = run_training(_recording(step, sums_b), state_b, ds,
                           out_dir=out_b, epoch_start=epoch_start,
                           start_batch=start_batch, metrics_jsonl=os.path.join(
                               out_b, "metrics.jsonl"), **run)
    same_data = torch.equal(torch.stack(sums_a).cpu(),
                            torch.stack(sums_b).cpu())
    rec_b = _jsonl(os.path.join(out_b, "metrics.jsonl"))
    keys = [k for k in rec_a[1] if k not in ("epoch", "batch", "step",
                                             "samples_per_s")]
    loss_err = max(abs(rec_b[s][k] - rec_a[s][k]) / abs(rec_a[s][k])
                   for s in rec_b for k in keys)
    pa = {k: v.cpu() for k, v in state_a.model.state_dict().items()}
    pb = {k: v.cpu() for k, v in state_b.model.state_dict().items()}
    held = [k for k in pa if not _before_norm(k)]
    rel = _rel_l2(pb, pa, held)
    log(f"  loop, resumed at epoch {epoch_start} batch {start_batch + 1}: "
        f"the model and Adam state bitwise the preempted run's: {exact}; "
        f"the same {len(sums_b)} batches: {same_data}; logged steps "
        f"{sorted(rec_b)}, losses max relative {loss_err:.3e} tol 5e-2; "
        f"parameters relative L2 {rel:.3e} tol 5e-2 (all but the biases "
        f"before an instance norm; with them {_rel_l2(pb, pa, list(pa)):.3e})"
        f"; step {state_b.step}")
    if not (exact and same_data and (epoch_start, start_batch) == (1, 3)
            and sorted(rec_b) == [s for s in rec_a if s != 3]
            and loss_err <= 5e-2 and rel <= 5e-2
            and state_b.step == state_a.step == steps):
        raise AssertionError("preempted and resumed ReCoNet loop run")
    shutil.rmtree(RECONET_OUT, ignore_errors=True)
    return launches


def phase_main_reconet_train(g):
    """ReCoNet training: K1's and K2's gradients at the flow step's shapes;
    the full-width flow step (RECONET_CANDY: ReCoNet 48/96/192, 5 blocks,
    seed 1; VGG16 seed 0; 360×640 frame pairs, batch 2, f32) against the
    plain route, then timed (2 warmup, 6 timed steps; K1 10, K2 2 a step),
    under remat (K1 20, K2 4: the checkpointed forward runs again in the
    backward); the coco step (256² b4) and the SD1 → SD2 distillation
    (teacher forward included: K1 20, K2 4 a step; SD1's SD loss NaN);
    what K1/K2 cost per step, forward and backward; the flow trainer
    through the loop with a resume."""
    log("[5c] main path: ReCoNet training (flow step 360×640 b2 f32, coco "
        "256² b4, SD1 and SD2 distillation, the flow trainer's loop)")
    t_phase = time.perf_counter()
    errs = _k1_k2_grad_checks(g)
    apply_precision(torch.float32)
    rng = np.random.default_rng(20)
    cfg = RECONET_CANDY
    vgg = init_vgg16_reconet(0, device="cuda")
    grams = _style_grams(vgg, cfg, rng)
    batch = _flow_batch(rng, cfg)
    m_err, g_err = _flow_step_against_plain(vgg, grams, batch)
    total = [0, 0]
    out = {"errs": errs, "metric_err": m_err, "grad_err": g_err}

    def add(launches):
        total[0] += launches[0]
        total[1] += launches[1]

    for remat, (steps, warmup) in ((False, (6, 2)), (True, (2, 1))):
        c = dataclasses.replace(cfg, remat=remat)
        launches, ms, peak = _reconet_run(
            f"flow f32{' remat' if remat else ''}",
            create(init_reconet(1, device="cuda"), c.lr),
            make_reconet_flow_step(c, vgg, grams), batch, steps, warmup,
            (20, 4) if remat else (10, 2))
        add(launches)
        out["remat_ms" if remat else "ms"] = ms
        out["remat_peak_gib" if remat else "peak_gib"] = peak
    ccfg = ReCoNetCocoConfig()
    cbatch = torch.from_numpy(rng.integers(0, 256, (ccfg.batch_size,
                                                    *ccfg.img_size, 3))
                              .astype(np.float32)).cuda()
    launches, out["coco_ms"], _ = _reconet_run(
        "coco 256² b4 f32", create(init_reconet(1, device="cuda"), ccfg.lr),
        make_reconet_coco_step(ccfg, vgg, _style_grams(vgg, ccfg, rng)),
        cbatch, 3, 1, (10, 2))
    add(launches)
    student = None
    for dcfg, teacher, init in ((DISTILL_SD1, init_reconet(0, device="cuda"),
                                 init_reconet_sd1),
                                (DISTILL_SD2, None, init_reconet_sd2)):
        teacher = teacher if teacher is not None else student
        state = create(init(1, device="cuda"), dcfg.lr)
        launches, ms, _ = _reconet_run(
            f"distill {dcfg.teacher}->{dcfg.student} 360×640 b2 f32", state,
            make_reconet_distill_step(dcfg, vgg, grams, teacher), batch, 3, 1,
            (20, 4), nan_sdl=dcfg.student == "sd1")
        add(launches)
        out[f"{dcfg.student}_ms"] = ms
        student = state.model
    out["times"] = _k1_k2_step_times(g)
    add(_flow_loop(vgg, grams))
    out["K1"], out["K2"] = total
    log(f"  [5c] launches over the phase's main-path runs: K1 {total[0]}, "
        f"K2 {total[1]}; wall {time.perf_counter() - t_phase:.1f} s")
    return out


# ------------------------------------------------------------------ RTNSTV

RTNSTV_OUT = os.path.join(ROOT, "build", "chip_smoke_rtnstv")
RTNSTV_SIZE = (360, 640)   # serving and training frames, H × W


def _rtnstv_before_norm(key):
    """Every RTNSTV conv and transposed conv feeds an instance norm, so
    their biases' true gradient is 0."""
    return key.endswith("conv.bias")


def _k1_f64_check(g, shape):
    """The f32 (3xTF32) K1 without and with its prologue against the
    float64 evaluation of the same inputs (``conv3x3_in_stats_plain`` on
    float64), the card reference of the f32 kernels: y and the stats
    within 1e-4 of their scale (3xTF32 products and float32 sums over 432
    terms sit near 1e-6).  Returns the worst y error."""
    apply_precision(torch.float32)
    x, wt, b, gamma, beta = k1_inputs(g, torch.float32, shape)
    errs = []
    for pro in (False, True):
        y, s = res_block.conv3x3_in_stats(x, wt, b)
        args = (x, wt, b) if not pro else (y, wt, b, s, gamma, beta)
        yk, sk = res_block.conv3x3_in_stats(*args)
        y64, s64 = res_block.conv3x3_in_stats_plain(
            *(a.double() for a in args))
        tag = f"K1 f32 RTNSTV {shape}{' prologue' if pro else ''} "
        errs.append(check(tag + "y against float64", yk, y64, 1e-4))
        check(tag + "stats against float64", sk, s64, 1e-4)
    return max(errs)


def phase_kernels_rtnstv(g):
    """``--rtnstv``: [3] at the narrow widths alone: K1 (8, 90, 160, 48) →
    48 in f32 and bf16 against the plain version (and f32 against
    float64); in bf16 also SD1/SD2's (8, 128, 128, 64) and
    K1_NARROW_EDGES in the reflect mode, and in the halo-rows mode
    K1_NARROW_EDGES and RTNSTV's step at the uneven blocks (24, 22, 22,
    22), stitched y one reflect launch's bits; two launches the same
    bits."""
    log("[3] K1 at the narrow residual widths")
    apply_precision(torch.float32)
    errs = {"K1 f32": _k1_check(g, torch.float32, "f32 RTNSTV", K1_RTNSTV,
                                1e-4)}
    errs["K1 f32 vs f64"] = _k1_f64_check(g, K1_RTNSTV)
    apply_precision(torch.bfloat16)
    errs["K1"] = max(
        _k1_check(g, torch.bfloat16, f"bf16 {label}", shape, BF16_ULP)
        for label, shape in {"RTNSTV": K1_RTNSTV,
                             "SD1/SD2": K1_BF16["SD1/SD2"],
                             **K1_NARROW_EDGES}.items())
    errs["K1 halo"], same = 0.0, {}
    _k1_narrow_halo_edges(g, torch.bfloat16, "K1 halo", BF16_ULP, errs, same)
    shape, splits = K1_UNEVEN["RTNSTV step"]
    e, same["RTNSTV step uneven"] = _k1_halo_check(
        g, torch.bfloat16, "RTNSTV step", shape, BF16_ULP, splits)
    if not same["RTNSTV step uneven"]:
        raise AssertionError("K1 halo RTNSTV step: the stitched blocks "
                             "differ from one reflect launch")
    errs["K1 halo"] = max(errs["K1 halo"], e)
    log(f"  K1 halo mode: y equals one reflect-mode launch bit for bit: "
        f"{json.dumps(same)}")
    torch.cuda.synchronize()
    return errs


def phase_model_rtnstv(gold):
    """[4] RTNSTV: the f32 forward at 1×256² through K1 against the same
    forward through K1's plain version (2e-3 of the 0–255 output, the
    model tolerance), 10 launches, and with grad mode on (K1 as its
    autograd Function) the same bits; cuDNN runs deterministic for that
    comparison, since its transposed convolution (a data-gradient
    algorithm) may sum in another order from call to call.  Then the
    golden ``rtnstv_styled`` (``init_stylizing_network(7)`` on
    ``input_x``, 2e-3 as tests/test_goldens.py)."""
    apply_precision(torch.float32)
    model = rtnstv_m.init_stylizing_network(0, device="cuda")
    x = torch.from_numpy((np.random.default_rng(1).random((1, 256, 256, 3))
                          * 255).astype(np.float32)).cuda()
    torch.backends.cudnn.deterministic = True
    try:
        with torch.inference_mode():
            reset_counts()
            ours = model(x)
            launches = counts()
            with plain_kernels():
                ref = model(x)
        graded = model(x)
    finally:
        torch.backends.cudnn.deterministic = False
    same = torch.equal(graded.detach(), ours)
    err = max_err(ours, ref)
    log(f"  RTNSTV f32 256²: K1-K5 launches {launches}; max_abs_err against "
        f"the plain route {err:.3e} tol 2e-3; grad mode on: the same bits "
        f"{same} (max |diff| {max_err(graded.detach(), ours):.3e})")
    if launches != (10, 0, 0, 0, 0) or not err <= 2e-3 or not same:
        raise AssertionError(f"RTNSTV forward: {launches}, {err}, {same}")
    with torch.inference_mode():
        out = rtnstv_m.init_stylizing_network(7, device="cuda")(
            torch.from_numpy(gold["input_x"]).cuda()).cpu().numpy()
    gerr = float(np.abs(out - gold["rtnstv_styled"]).max())
    log(f"  golden rtnstv_styled: max_abs_err {gerr:.3e} tol 2e-3")
    if not gerr <= 2e-3:
        raise AssertionError(f"rtnstv_styled: {gerr}")
    return err


def _rtnstv_batch(model, x, wire="rgb"):
    return stylize_rtnstv(model, x, uint8_out=True, wire=wire)


def phase_main_rtnstv():
    """[5] RTNSTV serving from the port's seeded ``init_stylizing_network
    (0)``: 640×360 batch 8 through ``stylize_rtnstv`` in bf16 and f32
    (the uint8 and I420 wires, 5 timed batches after one), then
    ``StreamingStylizer`` over 96 synthetic 640×360 uint8 frames (batch 8,
    depth 3) in each dtype; K1 10 launches a forward, nothing else.
    Returns the K1 launches per dtype and the ms."""
    log("[5] main path: RTNSTV 16/32/48, 640×360 b8, bf16 and f32")
    rng = np.random.default_rng(9)
    h, w = RTNSTV_SIZE
    x = rng.integers(0, 256, (8, h, w, 3)).astype(np.uint8)
    clip = list(rng.integers(0, 256, (96, h, w, 3)).astype(np.uint8))
    out, outs = {}, {}
    for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        apply_precision(dtype)
        model = rtnstv_m.init_stylizing_network(0, device="cuda", dtype=dtype)
        reset_counts()
        outs[tag] = _rtnstv_batch(model, x)
        i420 = _rtnstv_batch(model, x, "i420")
        raw = stylize_rtnstv(model, x)
        forwards = 3
        if not (torch.isfinite(raw).all() and raw.min() >= 0
                and raw.max() <= 255):
            raise AssertionError(f"RTNSTV {tag}: frames not finite or "
                                 f"outside 0..255")
        # two forwards: cuDNN's transposed convolution may sum in another
        # order from call to call, and the truncating cast then moves a
        # value by one step
        wire_diff = (i420.int() - rgb_to_i420(outs[tag]).int()).abs()
        log(f"  {tag}: the I420 wire against rgb_to_i420 of the uint8 wire's"
            f" frames: {int((wire_diff > 0).sum())} of {wire_diff.numel()} "
            f"bytes differ, by at most {int(wire_diff.max())} (tol 1)")
        if (outs[tag].shape != (8, h, w, 3) or outs[tag].dtype != torch.uint8
                or wire_diff.max() > 1):
            raise AssertionError(f"RTNSTV {tag}: uint8 / I420 wire")
        torch.cuda.synchronize()
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            _rtnstv_batch(model, x)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            forwards += 1
        stream = StreamingStylizer(lambda b: _rtnstv_batch(model, b),
                                   iter(clip), batch_size=8,
                                   pipeline_depth=3)
        t0 = time.perf_counter()
        styled = list(stream)
        stream_s = time.perf_counter() - t0
        forwards += 96 // 8
        launches = counts()
        first = _rtnstv_batch(model, np.stack(clip[:8])).cpu().numpy()
        diff = np.abs(first.astype(int) - np.stack(styled[:8]).astype(int))
        log(f"  {tag}: launches K1-K5 {launches} over {forwards} forwards "
            f"({launches[0] / forwards:g} K1 a forward)")
        if launches != (10 * forwards, 0, 0, 0, 0):
            raise AssertionError(f"RTNSTV {tag}: expected K1 "
                                 f"{10 * forwards}, K2-K5 0, got {launches}")
        if len(styled) != 96 or diff.max() > 1:
            raise AssertionError(f"RTNSTV {tag}: streamed frames")
        ms = float(np.median(times))
        log(f"  640×360 b8 {tag} stylize_rtnstv: {ms:.3f} ms/batch (median "
            f"of 5) → {8e3 / ms:.1f} frames/s; runs "
            f"{[round(t, 3) for t in times]}")
        log(f"  StreamingStylizer 96×640×360 {tag}, batch 8, depth 3: "
            f"{stream_s:.3f} s → {96 / stream_s:.1f} frames/s")
        out[tag] = {"K1": launches[0], "ms": ms, "stream_fps": 96 / stream_s}
        del model
    diff = (outs["bf16"].int() - outs["f32"].int()).abs().float()
    log(f"  bf16 against f32, uint8 frames: max |diff| {diff.max().item():g}"
        f", mean {diff.mean().item():.3f} (bf16 through ten instance norms; "
        f"not held)")
    apply_precision(torch.bfloat16)
    return out


def _rtnstv_grams(vgg, rng):
    h, w = RTNSTV_SIZE
    style = rng.integers(0, 256, (1, h, w, 3)).astype(np.float32)
    return rtnstv_style_grams(vgg, style)


def _rtnstv_loop(vgg, grams):
    """The RTNSTV trainer (``RTNSTVConfig()``) through ``run_training`` on
    8 synthetic flow pairs (one epoch of 4 steps): K1 40 launches, finite
    losses at every step, the epoch ``.npz`` / ``.pth`` and
    ``rtnstv_last_state`` written, and the ``.npz`` (JAX layout, the
    decoders' weights flipped) reloading to the model's tensors."""
    cfg = RTNSTVConfig()
    ds = SyntheticFlowPairs(8, cfg.img_size, seed=31)
    steps = len(ds) // cfg.batch_size
    shutil.rmtree(RTNSTV_OUT, ignore_errors=True)
    torch.cuda.synchronize()
    reset_counts()
    state = run_training(
        make_rtnstv_step(cfg, vgg, grams),
        create(rtnstv_m.init_stylizing_network(1, device="cuda"), cfg.lr),
        ds, batch_size=cfg.batch_size, epochs=1, out_dir=RTNSTV_OUT,
        model_name="rtnstv", seed=32, num_workers=4, log_every=1,
        log_fn=lambda msg: log(f"    {msg}"), metrics_jsonl=os.path.join(
            RTNSTV_OUT, "metrics.jsonl"))
    torch.cuda.synchronize()
    launches = counts()
    rec = _jsonl(os.path.join(RTNSTV_OUT, "metrics.jsonl"))
    finite = all(v is not None and math.isfinite(v) for r in rec.values()
                 for v in r.values())
    files = sorted(os.listdir(RTNSTV_OUT))
    name = f"rtnstv_epoch_1_batchSize_{cfg.batch_size}"
    saved = ckpt.load_params(os.path.join(RTNSTV_OUT, f"{name}.npz"))
    live = state.model.state_dict()
    same = saved.keys() == live.keys() and all(
        torch.equal(saved[k], live[k].cpu()) for k in live)
    log(f"  RTNSTV trainer through the loop: launches K1-K5 {launches} over "
        f"{steps} steps; {len(rec)} logged steps, losses finite: {finite}; "
        f"files {files}; the .npz reloads to the model's tensors: {same}")
    want = {f"{name}.npz", f"{name}.pth", "rtnstv_last_state"}
    if (launches != (10 * steps, 0, 0, 0, 0) or not finite or not same
            or sorted(rec) != list(range(1, steps + 1))
            or not want <= set(files)):
        raise AssertionError("RTNSTV loop run")
    shutil.rmtree(RTNSTV_OUT, ignore_errors=True)
    return launches[0]


def phase_main_rtnstv_train():
    """[5d] RTNSTV training at ``RTNSTVConfig()``, nothing cut (360×640
    frame pairs, batch 2, f32; RTNSTV seed 1, VGG19 seed 0; synthetic
    frames, flow of std 2 px, mask): one step through K1 and one through
    the plain versions against the plain float64 step (metrics 1e-4
    relative; gradients within max(1e-3, 2 × the plain f32 route's
    distance) of their scale, the biases before an instance norm against
    the largest gradient); the step timed (2 warmup, 6 timed; K1 10 a
    step) and under remat (K1 20); the trainer through the loop."""
    log("[5d] main path: RTNSTV training (360×640 b2 f32, RTNSTVConfig)")
    t_phase = time.perf_counter()
    apply_precision(torch.float32)
    rng = np.random.default_rng(30)
    cfg = RTNSTVConfig()
    vgg = init_vgg19_rtnstv(0, device="cuda")
    grams = _rtnstv_grams(vgg, rng)
    batch = _flow_batch(rng, cfg)
    m_err, g_err = _step_against_float64(
        "RTNSTV step 360×640 b2", cfg,
        lambda: rtnstv_m.init_stylizing_network(1, device="cuda"),
        lambda c: make_rtnstv_step(c, vgg, grams), batch,
        _rtnstv_before_norm)
    out = {"metric_err": m_err, "grad_err": g_err, "K1": 0}
    for remat, (steps, warmup) in ((False, (6, 2)), (True, (2, 1))):
        c = dataclasses.replace(cfg, remat=remat)
        launches, ms, peak = _reconet_run(
            f"RTNSTV step f32{' remat' if remat else ''}",
            create(rtnstv_m.init_stylizing_network(1, device="cuda"), c.lr),
            make_rtnstv_step(c, vgg, grams), batch, steps, warmup,
            (20, 0) if remat else (10, 0))
        out["K1"] += launches[0]
        out["remat_ms" if remat else "ms"] = ms
        out["remat_peak_gib" if remat else "peak_gib"] = peak
    out["K1"] += _rtnstv_loop(vgg, grams)
    log(f"  [5d] K1 launches over the phase's main-path runs: {out['K1']}; "
        f"wall {time.perf_counter() - t_phase:.1f} s")
    return out


def _profile_rtnstv_forward(rng):
    """Device time by kernel of the RTNSTV 640×360 b8 bf16 forward
    (``stylize_rtnstv``, uint8 wire) and K1's share of it."""
    apply_precision(torch.bfloat16)
    model = rtnstv_m.init_stylizing_network(0, device="cuda",
                                            dtype=torch.bfloat16)
    h, w = RTNSTV_SIZE
    x = rng.integers(0, 256, (8, h, w, 3)).astype(np.uint8)
    _profile("RTNSTV 640×360 b8 bf16", lambda: _rtnstv_batch(model, x),
             top=16, share=("K1", ("conv3x3_wgmma", "finalize_stats",
                                   "prologue_params")))


def _profile_rtnstv_step(rng):
    """Device time by kernel of the f32 RTNSTV step (``RTNSTVConfig()``)."""
    apply_precision(torch.float32)
    cfg = RTNSTVConfig()
    vgg = init_vgg19_rtnstv(0, device="cuda")
    state = create(rtnstv_m.init_stylizing_network(1, device="cuda"), cfg.lr)
    step = make_rtnstv_step(cfg, vgg, _rtnstv_grams(vgg, rng))
    batch = _flow_batch(rng, cfg)
    _profile("RTNSTV train 360×640 b2 f32 step", lambda: step(state, batch),
             top=24)


def device_ms_per_call(fn, reps=20):
    """(device ms a call: CUDA events around ``reps`` calls queued behind a
    sleep kernel of about 10 ms, so that the card runs them back to back
    whatever the host's pace; {kernel: [launches a call, ms a launch]}
    from torch.profiler over ``reps`` more calls)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = {}
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA") and e.count:
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
            kernels[e.key[:60]] = [e.count / reps, us / e.count / 1e3]
    return a.elapsed_time(b) / reps, kernels


def host_ms_per_call(fn, reps=200):
    """Host ms a call: ``reps`` calls with no synchronization between them
    (what the host needs to keep the card fed)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / reps


# K1's narrow widths timed in [6]: RTNSTV's 640×360 b8 serving and the
# SD1/SD2 students' 512² b8 residual stacks
K1_NARROW_TIMED = {"rtnstv": (K1_RTNSTV, "RTNSTV 640x360 b8 serving"),
                   "sd": ((8, 128, 128, 64), "SD1/SD2 512x512 b8 serving")}


def timing_k1_narrow(g, shape, what):
    """K1 at a narrow width, (N, H, W, C) → C, per call without and with
    its prologue, in bf16 and f32 (3xTF32): the call's time (CUDA events
    around back-to-back calls), its device time and launches
    (torch.profiler) and its host time (``host_ms_per_call``), beside its
    plain version and cuDNN's ``F.conv2d`` of the same conv in benchmark
    mode (f32 with TF32 off), the faster of NCHW and channels_last; bound
    in the convention of the other K1 rows.  Per forward: 5 calls without
    and 5 with the prologue.  The device time a call is the calls' time
    queued behind a sleep kernel (``device_ms_per_call``), with each
    kernel's launches and ms from torch.profiler beside it."""
    n, h, w, c = shape
    flops = 2 * 9 * c * c * n * h * w
    row = {"shape": f"({n},{h},{w},{c})->{c}, {what}",
           "per": f"one {what.split(' ', 1)[1]} forward: 5 calls without "
                  f"and 5 with the prologue"}
    for dt, tag, peak, nb in ((torch.bfloat16, "", torch.bfloat16, 2),
                              (torch.float32, "_f32", "tf32x3", 4)):
        apply_precision(dt)
        x, wt, b, gamma, beta = k1_inputs(g, dt, shape)
        y, s = res_block.conv3x3_in_stats(x, wt, b)
        calls = [lambda: res_block.conv3x3_in_stats(x, wt, b),
                 lambda: res_block.conv3x3_in_stats(y, wt, b, s, gamma, beta)]
        t = [event_ms(f, 20, 3) for f in calls]
        dev = [device_ms_per_call(f) for f in calls]
        host = [host_ms_per_call(f) for f in calls]
        tp = [event_ms(lambda: res_block.conv3x3_in_stats_plain(x, wt, b),
                       5, 1),
              event_ms(lambda: res_block.conv3x3_in_stats_plain(
                  y, wt, b, s, gamma, beta), 5, 1)]
        xp = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
        tl, layout, both = cudnn_ms(xp, wt.permute(3, 2, 0, 1), b)
        nbytes = (2 * n * h * w * c + 9 * c * c + c) * nb + n * 2 * c * 4
        b1, by = bound(flops, nbytes, peak)
        b1_pro, _ = bound(flops, nbytes + (n * 2 * c + 2 * c) * 4, peak)
        row.update({f"ms{tag}": 5 * (t[0] + t[1]),
                    f"ms{tag}_per_launch": t,
                    f"device_ms{tag}_per_call": [d[0] for d in dev],
                    f"device_kernels{tag}_per_call": [d[1] for d in dev],
                    f"host_ms{tag}_per_call": host,
                    f"plain_ms{tag}": 5 * (tp[0] + tp[1]),
                    f"bound_ms{tag}": 5 * (b1 + b1_pro),
                    f"bound_ms{tag}_per_launch": [b1, b1_pro],
                    f"bound_by{tag}": by,
                    f"library_ms{tag}": 10 * tl,
                    f"library_ms{tag}_per_launch": tl,
                    f"library{tag}": f"F.conv2d (cuDNN, benchmark mode, "
                                     f"{layout}; NCHW {both['NCHW']:.4f}, "
                                     f"channels_last "
                                     f"{both['channels_last']:.4f} ms)"})
        log(f"  K1{tag or ' bf16'} {shape}->{c} ms a call: {t[0]:.4f}, with "
            f"prologue {t[1]:.4f} ({flops / t[0] / 1e9:.1f} / "
            f"{flops / t[1] / 1e9:.1f} TFLOP/s); device {dev[0][0]:.4f} / "
            f"{dev[1][0]:.4f} (launches a call, ms a launch: "
            f"{json.dumps(dev[0][1])} / {json.dumps(dev[1][1])}); "
            f"host {host[0]:.4f} / {host[1]:.4f}; bound {b1:.4f} / "
            f"{b1_pro:.4f} ({by}), share of the device time "
            f"{b1 / dev[0][0]:.3f} / {b1_pro / dev[1][0]:.3f}; plain "
            f"{tp[0]:.4f} / {tp[1]:.4f}; cuDNN {tl:.4f} ({layout}; NCHW "
            f"{both['NCHW']:.4f}, channels_last {both['channels_last']:.4f})")
        del x, y, xp
    apply_precision(torch.bfloat16)
    return row


# ------------------------------------------------------------- evaluation

EVAL_SIZE = 512           # the image sweep's and the metrics' 512² pairs
SINTEL_HW = (360, 640)    # RTNSTV's Et and ReCoNet's MSE frames
ADA_SINTEL_HW = (256, 512)


def _eval_count(label, expect):
    """Read the launch counts of one [5e] item and hold them to
    ``expect`` (K1, K2, K3; K4 and K5 must be 0)."""
    got = counts()
    log(f"  {label}: launches K1-K5 {got}")
    if got != (*expect, 0, 0):
        raise AssertionError(f"{label}: expected K1-K3 {expect}, K4/K5 0, "
                             f"got {got}")
    return got


def _eval_image_sweep(rng):
    """The ``image`` loop (``cli/experiments.py::image_rows``): 2 contents
    × 2 styles at 512² (smooth synthetic images), AdaAttN softmax bf16
    (VGG19 seed 0, AdaAttN seed 1), metrics SSIM, histograms, Gram (f32
    VGG19) and LPIPS-vgg; K3 3 a stylize.  The seeded decoder's output is
    small and partly negative, so the clamped styled images are near
    black and SSIM near 0.  SIFID columns are left out: their 2048²
    ``sqrtm`` is host work of tens of seconds a pair (the metrics item
    holds SIFID)."""
    vgg, net = _ada_models(0, 1, torch.bfloat16)
    metric_vgg = init_vgg19_adaattn(0, device="cuda")
    lpips_fn = lpips_metric({k: v.cuda() for k, v in params_from_jax(
        random_lpips_params(0)).items()})
    # smooth synthetic images (bicubic from 8×8 noise), so SSIM and the
    # histograms read structure rather than white noise
    coarse = torch.from_numpy(rng.random((4, 3, 8, 8)).astype(np.float32))
    smooth = (F.interpolate(coarse, size=(EVAL_SIZE, EVAL_SIZE),
                            mode="bicubic", align_corners=False)
              .clamp(0, 1) * 255).permute(0, 2, 3, 1).numpy()
    imgs = [(f"{t}{i}", smooth[2 * j + i]) for j, t in enumerate("cs")
            for i in range(2)]

    def stylize(c, s):
        return stylize_adaattn(vgg, net, c, s, "softmax")

    image_rows(stylize, imgs[:1], imgs[2:3], metric_vgg, lpips_fn)  # warm
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    rows = image_rows(stylize, imgs[:2], imgs[2:], metric_vgg, lpips_fn)
    ms = (time.perf_counter() - t0) * 1e3 / 4
    got = _eval_count("image sweep 2×2 512² bf16 softmax", (0, 0, 12))
    values = [v for r in rows for v in r.values() if isinstance(v, float)]
    if (len(rows) != 5 or not {"style_gram", "lpips_style"} <= set(rows[0])
            or not np.isfinite(values).all()):
        raise AssertionError("image sweep: rows, columns or finite values")
    log(f"  image sweep: {ms:.3f} ms a pair (stylize + 2 × (SSIM, "
        f"histograms, Gram) + 2 × LPIPS-vgg); average style_ssim "
        f"{rows[-1]['style_ssim']:.6f}, lpips_style "
        f"{rows[-1]['lpips_style']:.6f}")
    return {"ms_per_pair": ms, "launches": got[:3]}


def _eval_sintel_et(rng):
    """RTNSTV's Et (``temporal_error_sintel``) with ``stylize_rtnstv`` in
    f32 (seed 0) over 17 synthetic 640×360 frames, flows of std 2 px and
    masks (90% visible): 3 batches of 8 (the last padded), K1 10 a
    forward."""
    apply_precision(torch.float32)
    model = rtnstv_m.init_stylizing_network(0, device="cuda")
    h, w = SINTEL_HW
    frames = list(rng.integers(0, 256, (17, h, w, 3)).astype(np.float32))
    flows = list((rng.standard_normal((16, h, w, 2)) * 2).astype(np.float32))
    masks = list((rng.random((16, h, w)) > 0.1).astype(np.float32))
    model_fn = functools.partial(stylize_rtnstv, model)
    temporal_error_sintel(model_fn, frames[:9], flows[:8], masks[:8])  # warm
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    et = temporal_error_sintel(model_fn, frames, flows, masks)
    ms = (time.perf_counter() - t0) * 1e3
    got = _eval_count("Sintel Et, RTNSTV f32, 17 frames", (30, 0, 0))
    if not (np.isfinite(et) and et > 0):
        raise AssertionError(f"Et {et}")
    log(f"  Et {et:.6f}; {ms:.3f} ms for 17 frames ({ms / 16:.3f} ms a "
        f"pair)")
    return {"Et": et, "ms": ms, "ms_per_pair": ms / 16, "launches": got[:3]}


def _eval_temporal_mse(rng):
    """ReCoNet's ``temporal_mse`` with ``stylize_reconet`` in f32 (seed 0)
    over 9 synthetic 640×360 frames: 9 forwards, K1 10 and K2 2 each."""
    apply_precision(torch.float32)
    model = init_reconet(0, device="cuda")
    frames = list(rng.integers(0, 256, (9, *SINTEL_HW, 3)).astype(np.float32))
    model_fn = functools.partial(stylize_reconet, model)
    temporal_mse(model_fn, iter(frames[:2]))  # warm
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    mse = temporal_mse(model_fn, iter(frames))
    ms = (time.perf_counter() - t0) * 1e3
    got = _eval_count("temporal MSE, ReCoNet f32, 9 frames", (90, 18, 0))
    if not (np.isfinite(mse) and mse > 0):
        raise AssertionError(f"temporal MSE {mse}")
    log(f"  temporal MSE {mse:.4f}; {ms:.3f} ms for 9 frames ({ms / 8:.3f} "
        f"ms a pair)")
    return {"mse": mse, "ms": ms, "ms_per_pair": ms / 8, "launches": got[:3]}


def _eval_sintel_ada(rng, raft):
    """The ``sintel-ada`` loop (``sintel_ada_loss``) at 256×512, batch 8,
    over 9 synthetic frames, AdaAttN f32 (VGG19 seed 0, AdaAttN seed 1),
    RAFT (12 iterations) as the flow engine, MAE: cosine (no launches)
    and softmax (2 stylize calls, K3 6), each after an untimed run on 3
    frames (one padded batch, 4 RAFT flows)."""
    apply_precision(torch.float32)
    vgg, net = _ada_models(0, 1, torch.float32)
    h, w = ADA_SINTEL_HW
    frames = list(rng.integers(0, 256, (9, h, w, 3)).astype(np.float32))
    style = rng.integers(0, 256, (1, h, w, 3)).astype(np.float32)
    pair = estimated_pairs(raft_flow_fn(raft))
    out = {}
    for act, k3 in (("cosine", 0), ("softmax", 6)):
        stylize_batch = sintel_ada_stylizer(vgg, net, style, act)
        sintel_ada_loss(stylize_batch, frames[:3], pair)  # warm
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        loss = sintel_ada_loss(stylize_batch, frames, pair)
        ms = (time.perf_counter() - t0) * 1e3
        got = _eval_count(f"sintel-ada {act}, 9 frames 256×512 + RAFT",
                          (0, 0, k3))
        if not (np.isfinite(loss) and loss > 0):
            raise AssertionError(f"sintel-ada {act}: loss {loss}")
        log(f"  sintel-ada {act}: loss {loss:.6f}; {ms:.3f} ms for 9 frames "
            f"and 16 RAFT flows ({ms / 8:.3f} ms a pair)")
        out[act] = {"loss": loss, "ms": ms, "ms_per_pair": ms / 8,
                    "launches": got[:3]}
    return out


def _eval_raft(rng, raft):
    """RAFT at 1×256×512, 12 iterations, on the card against the port's
    own RAFT on the CPU on the same inputs and seeded parameters (rtol
    1e-3, atol 2e-4, tests/test_raft.py's tolerance); ms a pair by CUDA
    events."""
    a, b = (rng.random((2, 1, *ADA_SINTEL_HW, 3)) * 2 - 1).astype(np.float32)
    ours = raft_flow(raft, a, b).cpu()
    ref = raft_flow(init_raft(0, device="cpu"), a, b)
    err = (ours - ref).abs()
    lim = 2e-4 + 1e-3 * ref.abs()
    worst = float((err / lim).max())
    log(f"  RAFT 1×256×512 ×12: card against CPU max |diff| "
        f"{float(err.max()):.3e} (|flow| ≤ {float(ref.abs().max()):.3f}); "
        f"largest share of the rtol 1e-3 + atol 2e-4 bound {worst:.3f}")
    if not (ours.shape == (1, *ADA_SINTEL_HW, 2) and worst <= 1.0):
        raise AssertionError(f"RAFT card vs CPU: {worst} of the tolerance")
    ta, tb = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
    ms = event_ms(lambda: raft_flow(raft, ta, tb), reps=5, warmup=2)
    log(f"  RAFT 1×256×512 ×12 f32 (TF32 off): {ms:.3f} ms a pair")
    _profile("RAFT 1×256×512 ×12 (per pair)", lambda: raft_flow(raft, ta, tb),
             top=12)
    return {"ms_per_pair": ms, "max_abs_err": float(err.max()),
            "share_of_tol": worst}


def _eval_metrics(rng):
    """The metrics on the card against the same metrics on the CPU on one
    512² pair: SSIM, Gram (f32 VGG19 seed 0), LPIPS vgg/alex/squeeze
    (seeded) at 1e-4 relative; SIFID's Inception statistics (seed 0) at
    dims 64/192/768/2048 at 1e-4 of each one's scale and the Fréchet
    distance from either side's statistics at 1e-3 relative, on the same
    sqrtm branch.  Where both distances lie within 1e-5 of the traces
    (sqrtm's round-off on a singular product: the seeded trunk's deep
    blocks barely depend on the input, so the true distance is about 0)
    they are held to that floor and stated.  ms by CUDA events for the
    card side."""
    shape = (1, EVAL_SIZE, EVAL_SIZE, 3)
    a = (rng.random(shape) * 255).astype(np.float32)
    b = (rng.random(shape) ** 2 * 255).astype(np.float32)
    ta, tb = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
    ca, cb = torch.from_numpy(a), torch.from_numpy(b)
    out = {}

    def hold(name, card, cpu, rel, fn):
        err = abs(card - cpu)
        ms = event_ms(fn, reps=3, warmup=1)
        ok = err <= rel * abs(cpu)
        log(f"  {name}: card {card:.8g} CPU {cpu:.8g} |diff| {err:.3e} "
            f"tol {rel * abs(cpu):.3e} {'ok' if ok else 'FAIL'}; "
            f"{ms:.3f} ms on the card")
        if not ok:
            raise AssertionError(f"{name}: card {card} CPU {cpu}")
        out[name] = {"card": card, "cpu": cpu, "ms": ms}

    hold("SSIM", float(ssim(ta, tb)), float(ssim(ca, cb)), 1e-4,
         lambda: ssim(ta, tb))
    vgg_card = init_vgg19_adaattn(0, device="cuda")
    vgg_cpu = init_vgg19_adaattn(0, device="cpu")
    hold("Gram 5-tap", float(gram_loss_5tap(vgg_card, ta, tb)),
         float(gram_loss_5tap(vgg_cpu, ca, cb)), 1e-4,
         lambda: gram_loss_5tap(vgg_card, ta, tb))
    xa, xb = ta / 127.5 - 1.0, tb / 127.5 - 1.0
    for net in ("vgg", "alex", "squeeze"):
        cpu_p = params_from_jax(random_lpips_params(0, net))
        card_p = {k: v.cuda() for k, v in cpu_p.items()}
        hold(f"LPIPS-{net}", float(lpips_distance(card_p, xa, xb, net)[0]),
             float(lpips_distance(cpu_p, xa.cpu(), xb.cpu(), net)[0]), 1e-4,
             lambda: lpips_distance(card_p, xa, xb, net))
    inc_card, inc_cpu = init_inception(0, "cuda"), init_inception(0, "cpu")
    for dims in (64, 192, 768, 2048):
        stats = {}
        for side, params in (("card", inc_card), ("cpu", inc_cpu)):
            stats[side] = [activation_statistics(params, x / 255.0, dims)
                           for x in (a, b)]
        errs = [float(np.abs(c - p).max() / np.abs(p).max())
                for (cm, cs), (pm, ps) in zip(stats["card"], stats["cpu"])
                for c, p in ((cm, pm), (cs, ps))]
        dist, jitter = {}, {}
        for side in ("card", "cpu"):
            (m1, s1), (m2, s2) = stats[side]
            dist[side], jitter[side] = frechet_distance_branch(m1, s1, m2, s2)
        traces = float(np.trace(stats["cpu"][0][1])
                       + np.trace(stats["cpu"][1][1]))
        derr = abs(dist["card"] - dist["cpu"])
        # a distance within sqrtm's round-off of its traces (a singular
        # product) is 0 on both sides: held to that floor, not 1e-3
        floor = 1e-5 * traces
        zero = max(abs(dist["card"]), abs(dist["cpu"])) <= floor
        dtol = floor if zero else 1e-3 * abs(dist["cpu"])
        block = BLOCK_INDEX_BY_DIM[dims]
        ms = event_ms(lambda: inception_blocks(inc_card, ta / 255.0,
                                               block), reps=3, warmup=1)
        ok = (max(errs) <= 1e-4 and derr <= dtol
              and jitter["card"] == jitter["cpu"])
        log(f"  SIFID {dims}: statistics card vs CPU {max(errs):.3e} of "
            f"their scale (tol 1e-4); distance card {dist['card']:.8g} "
            f"CPU {dist['cpu']:.8g} |diff| {derr:.3e} tol {dtol:.3e}"
            f"{' (both round-off of the traces: 0)' if zero else ''} "
            f"(traces {traces:.6g}; sqrtm's jitter branch, card / CPU: "
            f"{jitter['card']} / {jitter['cpu']}) "
            f"{'ok' if ok else 'FAIL'}; Inception to block {block} "
            f"{ms:.3f} ms on the card")
        if not ok:
            raise AssertionError(f"SIFID {dims}: {errs}, {derr}")
        out[f"SIFID-{dims}"] = {"card": dist["card"], "cpu": dist["cpu"],
                                "stats_err": max(errs), "zero": zero,
                                "jitter": jitter["cpu"], "ms": ms}
    return out


def phase_eval():
    """[5e] evaluation (slice 6) from seeded weights on synthetic data, the
    launch counts reset before each item and read after it: the image
    sweep, Sintel Et, temporal MSE, the ``sintel-ada`` loop with RAFT,
    RAFT against the CPU, and the metrics against the CPU.  Every K1, K2
    and K3 launch must be at a shape [3] held against the plain version
    (CHECKED).  Returns the K1/K2/K3 launches and the items' numbers."""
    log("[5e] evaluation: the experiment loops and metrics from seeded "
        "weights")
    t0 = time.perf_counter()
    rng = np.random.default_rng(21)
    raft = init_raft(0, device="cuda")
    res, walls = {}, {}
    with recording_launches() as seen:
        for name, item, *args in (
                ("image", _eval_image_sweep), ("sintel_et", _eval_sintel_et),
                ("temporal_mse", _eval_temporal_mse),
                ("sintel_ada", _eval_sintel_ada, raft),
                ("raft", _eval_raft, raft), ("metrics", _eval_metrics)):
            t = time.perf_counter()
            res[name] = item(rng, *args)
            walls[name] = time.perf_counter() - t
    log(f"  [5e] items' wall (s, warm-ups, CPU references and host work "
        f"included): {json.dumps(walls)}")
    unchecked = sorted(map(str, seen - CHECKED))
    log(f"  [5e] launched K1-K3 at {len(seen)} shapes, all held against "
        f"the plain versions in [3]" if not unchecked else
        f"  [5e] launched at shapes [3] did not check: {unchecked}")
    if unchecked:
        raise AssertionError(f"[5e] shapes not checked: {unchecked}")
    launches = [res["image"]["launches"], res["sintel_et"]["launches"],
                res["temporal_mse"]["launches"],
                res["sintel_ada"]["softmax"]["launches"]]
    totals = {k: sum(n[i] for n in launches)
              for i, k in enumerate(("K1", "K2", "K3"))}
    res["wall_s"], res["item_wall_s"] = time.perf_counter() - t0, walls
    log(f"  [5e] launches {totals}; wall {res['wall_s']:.1f} s")
    log(json.dumps({"evaluation": res}))
    apply_precision(torch.bfloat16)
    return totals, res


def phase_eval_alone():
    """``--eval``: the kernels' build ([2]), K1, K2 and K3 at [5e]'s shapes
    ([3]: Sintel Et's RTNSTV batch-8 K1, temporal MSE's batch-1 K1/K2 in
    f32, K3_EVAL) and [5e]."""
    phase_build()
    g = torch.Generator(device="cuda").manual_seed(0)
    log("[3] kernels against their plain versions at [5e]'s shapes")
    apply_precision(torch.float32)
    for label, shape in {"RTNSTV": K1_RTNSTV, **K1_EVAL_F32}.items():
        _k1_check(g, torch.float32, f"f32 {label}", shape, 1e-4)
    for label, shape in K2_EVAL_F32.items():
        _k2_check(g, torch.float32, f"f32 {label}", shape, 1e-4)
    for case in K3_EVAL:
        _k3_check(g, *case)
    apply_precision(torch.bfloat16)
    phase_eval()


def phase_rtnstv_alone():
    """``--rtnstv``: the kernels' build ([2]), K1 at RTNSTV's shape ([3]),
    the RTNSTV forward and golden ([4]), serving ([5]), training ([5d]),
    K1's times at its serving shape ([6]) and the f32 step's profile."""
    phase_build()
    g = torch.Generator(device="cuda").manual_seed(0)
    errs = phase_kernels_rtnstv(g)
    log("[4] model: RTNSTV")
    with np.load(os.path.join(ROOT, "tests", "goldens",
                              "reference_numerics.npz")) as z:
        phase_model_rtnstv({k: z[k] for k in z.files})
    serving = phase_main_rtnstv()
    train = phase_main_rtnstv_train()
    log("[6] timing: K1 at its narrow widths")
    rows = {key: timing_k1_narrow(g, *K1_NARROW_TIMED[key])
            for key in K1_NARROW_TIMED}
    rows["rtnstv"].update(errs=errs, serving=serving, train=train)
    log(json.dumps({"K1 narrow": rows}))
    log("[7] profile")
    _profile_rtnstv_forward(np.random.default_rng(4))
    _profile_rtnstv_step(np.random.default_rng(4))


# -------------------------------------------------------------- scale-out

SCALE_OUT_CLIP = 48            # 640×360 frames through cli.infer_video
RING_BLOCKS = 4                # key blocks of the ring fold


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cli_video_frames(argv, clip):
    """``cli.infer_video.main(argv)`` with the decoder replaced by ``clip``
    and the frame dump by a list (the card's machine has no cv2 and no
    PIL); returns the frames it wrote, in order."""
    from vst_tpu_torch.cli import infer_video as cli_video

    out = []
    saved = cli_video.frames_from_source, cli_video.save_image_255
    cli_video.frames_from_source = lambda *a, **k: iter(clip)
    cli_video.save_image_255 = lambda f, path: out.append(np.asarray(f).copy())
    try:
        cli_video.main(argv)
    finally:
        cli_video.frames_from_source, cli_video.save_image_255 = saved
    return out


def _frames_match(label, ours, ref):
    """Same count and order, within one uint8 step; returns the largest
    difference."""
    if len(ours) != len(ref) or any(a.shape != b.shape
                                    for a, b in zip(ours, ref)):
        raise AssertionError(f"{label}: {len(ours)} frames against "
                             f"{len(ref)}, or of another shape")
    diff = max(np.abs(a.astype(int) - b.astype(int)).max()
               for a, b in zip(ours, ref))
    same = all(np.array_equal(a, b) for a, b in zip(ours, ref))
    log(f"  {label}: {len(ours)} frames, max |diff| {diff} (tol 1)"
        f"{', bit for bit' if same else ''}")
    if diff > 1:
        raise AssertionError(f"{label}: frames differ by {diff}")
    return int(diff)


def _scale_out_serving():
    """``infer_video --data-parallel 1`` (a world-1 NCCL group of its own,
    rank 0 scattering and gathering each batch) on the 640×360 ReCoNet
    stream against the same command without it; K1 10 and K2 2 launches
    a forward in the data-parallel run."""
    rng = np.random.default_rng(31)
    clip = list(rng.integers(0, 256, (SCALE_OUT_CLIP, 360, 640, 3))
                .astype(np.uint8))
    out_dir = os.path.join(ROOT, "build", "chip_smoke_scale_out")
    weights = os.path.join(out_dir, "reconet.npz")
    ckpt.save_params(init_reconet(0, device="cuda"), weights)
    argv = ["--model", "reconet", "--weights", weights, "--video", "clip",
            "--size", "640", "360", "--batch-size", "8", "--frames-dir",
            out_dir]
    ref = _cli_video_frames(argv, clip)
    reset_counts()
    t0 = time.perf_counter()
    ours = _cli_video_frames(argv + ["--data-parallel", "1"], clip)
    wall = time.perf_counter() - t0
    launches = counts()
    forwards = SCALE_OUT_CLIP // 8
    log(f"  infer_video --data-parallel 1, {SCALE_OUT_CLIP}×640×360 f32 "
        f"batch 8: launches K1-K5 {launches}; {wall:.2f} s with the group's "
        f"set-up")
    if launches != (10 * forwards, 2 * forwards, 0, 0, 0):
        raise AssertionError(f"expected K1 {10 * forwards}, K2 "
                             f"{2 * forwards} launches")
    diff = _frames_match("infer_video --data-parallel 1 against without",
                         ours, ref)
    shutil.rmtree(out_dir, ignore_errors=True)
    return {"K1": launches[0], "K2": launches[1], "max_diff": diff,
            "wall_s": wall}


def _grads(state):
    return {k: p.grad.detach().clone()
            for k, p in state.model.named_parameters() if p.grad is not None}


def _dp_step(label, new_state, make_step, batch, mesh, per_step, keys):
    """One step with the world-1 mesh and two without, each from a fresh
    state: the metrics within rtol 1e-6 (the forward is the same; the
    world-1 all-reduce adds nothing), the gradients of ``keys(name)``
    within max(1e-3, 4 × the two bare runs' own distance) of each key's
    largest (library backwards that accumulate with atomics differ from
    run to run by rounding, in bf16 by whole steps of it), the same
    (K1-K5) launches per step.  Then 2 + 7 steps alternating with and
    without the mesh, timed on the host clock after a synchronize: the
    all-reduces' cost over the bare step, median of 7, and the gradient
    all-reduce alone (CUDA events, median of 10), and ``replicate`` of the
    stepped state (its Adam step counts on the CPU) leaves it as it was.
    Every step's launches are counted and must be ``per_step``;
    ``launches`` is the sum over the ten steps run with the mesh, as
    counted."""
    from vst_tpu_torch.parallel.mesh import (_state_tensors,
                                             all_reduce_mean, replicate)

    res = {}
    for tag, m in (("bare", None), ("again", None), ("mesh", mesh)):
        state = new_state()
        step = make_step(m)
        reset_counts()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        res[tag] = ({k: float(v) for k, v in metrics.items()},
                    _grads(state), counts(), state, step)
    (m0, g0, n0, s0, f0), (_, ga, _, _, _) = res["bare"], res["again"]
    m1, g1, n1, s1, f1 = res["mesh"]
    del res
    if n0 != n1 or n1 != per_step:
        raise AssertionError(f"{label}: launches {n1} with the mesh, {n0} "
                             f"without, expected {per_step}")
    bad = [k for k in m0 if not math.isclose(m1[k], m0[k], rel_tol=1e-6)]

    def dist_(a):
        return max((a[k] - g0[k]).abs().max().item()
                   / max(g0[k].abs().max().item(), 1e-30)
                   for k in g0 if keys(k))

    g_err, calib = dist_(g1), dist_(ga)
    tol = max(1e-3, 4 * calib)
    bitwise = all(torch.equal(g1[k], g0[k]) for k in g0)
    log(f"  {label}: launches K1-K5 {n1} a step with and without the mesh; "
        f"metrics {'equal' if m0 == m1 else 'within rtol 1e-6'}; "
        f"gradients {'bit for bit' if bitwise else f'max rel {g_err:.2e}'} "
        f"(two bare runs {calib:.2e}; tol {tol:.2e})")
    if bad or g_err > tol:
        raise AssertionError(f"{label}: metrics {bad} or gradients "
                             f"({g_err}) differ with the mesh")
    del ga, g1
    times = {"bare": [], "mesh": []}
    mesh_launches = list(n1)
    for i in range(9):
        for tag, state, step in (("bare", s0, f0), ("mesh", s1, f1)):
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(state, batch)
            torch.cuda.synchronize()
            if i >= 2:
                times[tag].append((time.perf_counter() - t0) * 1e3)
            n = counts()
            if n != per_step:
                raise AssertionError(f"{label}: timed {tag} step {i} "
                                     f"launched {n}, expected {per_step}")
            if tag == "mesh":
                mesh_launches = [a + b for a, b in zip(mesh_launches, n)]
    grads = [p.grad for p in s1.model.parameters() if p.grad is not None]
    ar_ms = event_ms(lambda: all_reduce_mean(mesh, grads), 10, 2)
    # replicate of a stepped state, as cli.train runs it after a resume
    # (torch's Adam keeps its step counts on the CPU)
    held = [t.clone() for t in _state_tensors(s1)]
    cpu = sum(t.device.type == "cpu" for t in held)
    replicate(mesh, s1)
    if not all(torch.equal(a, b) for a, b in zip(held, _state_tensors(s1))):
        raise AssertionError(f"{label}: replicate changed the state")
    log(f"  {label}: replicate of the stepped state ({len(held)} tensors, "
        f"{cpu} on the CPU) leaves it bit for bit")
    del held
    ms = {t: float(np.median(v)) for t, v in times.items()}
    mb = sum(g.numel() * g.element_size() for g in grads) / 2**20
    extra = ms["mesh"] - ms["bare"]
    log(f"  {label}: {ms['bare']:.3f} ms/step bare, {ms['mesh']:.3f} with "
        f"the world-1 mesh (median of 7, alternating): {extra:+.3f} ms "
        f"({extra / ms['bare'] * 100:+.2f}%); the gradient all-reduce alone "
        f"({mb:.1f} MiB f32) {ar_ms:.4f} ms = {ar_ms / ms['bare'] * 100:.2f}% "
        f"of the bare step")
    return {"bare_ms": ms["bare"], "mesh_ms": ms["mesh"],
            "allreduce_ms": ar_ms, "allreduce_mib": mb,
            "grad_max_rel_diff": g_err, "bare_runs_rel_diff": calib,
            "bitwise": bitwise, "launches_per_step": n1,
            "launches": mesh_launches}


def _ring_fold(g, tag, dtype, b, levels, tol):
    """Each level's keys split into RING_BLOCKS blocks, each block through
    K3 and the blocks merged by ``fold_block``, against one K3 call over
    all keys: M1, M2 within ``tol`` of their largest, L within 1e-5;
    RING_BLOCKS K3 launches a level.  Times the fold beside the one call."""
    from vst_tpu_torch.parallel.attention import fold_block

    apply_precision(dtype)
    errs, rows = [], []
    for n, d, c in levels:
        q, k, v = k3_inputs(g, b, n, n, d, c, dtype)
        m1, m2, lse = adaattn_attention.softmax_attention_moments(q, k, v)
        blocks = [(kb.contiguous(), vb.contiguous()) for kb, vb in
                  zip(k.chunk(RING_BLOCKS, 1), v.chunk(RING_BLOCKS, 1))]

        def fold():
            acc = None
            for kb, vb in blocks:
                acc = fold_block(acc, *adaattn_attention
                                 .softmax_attention_moments(q, kb, vb))
            return acc

        reset_counts()
        f1, f2, fl = fold()
        if counts()[2] != RING_BLOCKS:
            raise AssertionError(f"ring fold {tag}: K3 launched "
                                 f"{counts()[2]} times, not {RING_BLOCKS}")
        name = f"ring fold {tag} ({b},{n},{n},{d},{c}) / {RING_BLOCKS}"
        errs.append(max(check(f"{name} M1", f1, m1, tol),
                        check(f"{name} M2", f2, m2, tol)))
        check(f"{name} L", fl, lse, 1e-5)
        t_fold = event_ms(fold, 3, 1)
        t_one = event_ms(
            lambda: adaattn_attention.softmax_attention_moments(q, k, v),
            3, 1)
        log(f"  {name}: fold {t_fold:.3f} ms, one call {t_one:.3f} ms")
        rows.append({"shape": [b, n, n, d, c], "fold_ms": t_fold,
                     "one_call_ms": t_one})
        del q, k, v, blocks
    return max(errs), rows


def _ring_backward(g, tag, dtype, b, levels, tol):
    """The ring's backward over RING_BLOCKS × RING_BLOCKS (query shard,
    key block) pairs in one process: each level's q split into
    RING_BLOCKS shards and k, v into RING_BLOCKS blocks, every pair
    through ``block_grads`` (K4 and K5) with the global L and D of one K3
    call over all keys, the dQ parts summed over the blocks and the dK,
    dV parts over the shards in float32, against one K4 + K5 call over
    all keys: each gradient within ``tol`` of its largest (f32 1e-4;
    bf16 4 × BF16_ULP, four bf16 parts summed); RING_BLOCKS² K4 and K5
    launches a level.  Times the 4 × 4 backward beside the one call."""
    from vst_tpu_torch.parallel.attention import block_grads

    att = adaattn_attention
    apply_precision(dtype)
    errs, rows = [], []
    for n, d, c in levels:
        q, k, v = k3_inputs(g, b, n, n, d, c, dtype)
        m1, m2, lse = att.softmax_attention_moments(q, k, v)
        dm1, dm2 = rnd(g, (b, n, c), 1.0, dtype), rnd(g, (b, n, c), 1.0, dtype)
        dd = att.row_term(m1, m2, dm1, dm2)
        shards = [[t.contiguous() for t in ts] for ts in zip(
            *(x.chunk(RING_BLOCKS, 1) for x in (q, lse, dd, dm1, dm2)))]
        blocks = [(kb.contiguous(), vb.contiguous()) for kb, vb in
                  zip(k.chunk(RING_BLOCKS, 1), v.chunk(RING_BLOCKS, 1))]

        def one_call():
            return (att.softmax_attention_dq(q, k, v, lse, dd, dm1, dm2),
                    *att.softmax_attention_dkv(q, k, v, lse, dd, dm1, dm2))

        def ring():
            dq = [None] * RING_BLOCKS
            dk, dv = [None] * RING_BLOCKS, [None] * RING_BLOCKS
            for i, (qs, ls, ds, d1, d2) in enumerate(shards):
                for j, (kb, vb) in enumerate(blocks):
                    pq, pk, pv = block_grads(qs, kb, vb, ls, ds, d1, d2)
                    for acc, idx, part in ((dq, i, pq), (dk, j, pk),
                                           (dv, j, pv)):
                        acc[idx] = (part.float() if acc[idx] is None
                                    else acc[idx] + part.float())
            return (torch.cat(dq, 1).to(dtype), torch.cat(dk, 1).to(dtype),
                    torch.cat(dv, 1).to(dtype))

        ref = one_call()
        reset_counts()
        ours = ring()
        n_ring = counts()
        pairs = RING_BLOCKS * RING_BLOCKS
        if n_ring != (0, 0, 0, pairs, pairs):
            raise AssertionError(f"ring backward {tag}: launches {n_ring}, "
                                 f"not K4 {pairs} and K5 {pairs}")
        name = (f"ring backward {tag} ({b},{n},{n},{d},{c}) / "
                f"{RING_BLOCKS}×{RING_BLOCKS}")
        errs.append(max(check(f"{name} {w}", a, r, tol)
                        for w, a, r in zip(("dQ", "dK", "dV"), ours, ref)))
        t_ring = event_ms(ring, 3, 1)
        t_one = event_ms(one_call, 3, 1)
        log(f"  {name}: {pairs} K4 + {pairs} K5 {t_ring:.3f} ms, one K4 + K5 "
            f"call {t_one:.3f} ms")
        rows.append({"shape": [b, n, n, d, c], "ring_bwd_ms": t_ring,
                     "one_call_ms": t_one})
        del q, k, v, shards, blocks, ours, ref
    return max(errs), rows


def _moment_grads(fn, q, k, v, cot):
    """(M1, M2) of ``fn`` on fresh leaves of q, k, v and their gradients
    for the cotangents ``cot``."""
    ins = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out = fn(*ins)
    return [t.detach() for t in out] + list(torch.autograd.grad(
        out, ins, [c.to(out[0].dtype) for c in cot]))


def _world1_moment_grads(g, mesh):
    """``sharded_softmax_attention_moments`` and
    ``sharded_cosine_attention_moments`` in the world-1 group on
    ``requires_grad`` inputs at the 512² b2 bf16 levels: M1, M2 and dQ,
    dK, dV bit for bit those of ``attention_moments`` without a mesh;
    the sharded runs' launches (K3 1, K4 1, K5 1 a softmax level, none for
    cosine) returned."""
    from vst_tpu_torch.models.adaattn import attention_moments
    from vst_tpu_torch.parallel.attention import (
        sharded_cosine_attention_moments, sharded_softmax_attention_moments)

    apply_precision(torch.bfloat16)
    total = [0] * 5
    for n, d, c in K3_LEVELS:
        q, k, v = k3_inputs(g, K3_BATCH, n, n, d, c, torch.bfloat16)
        cot = [rnd(g, (K3_BATCH, n, c), 1.0, torch.bfloat16)
               for _ in range(2)]
        for act, fn in (("softmax", sharded_softmax_attention_moments),
                        ("cosine", sharded_cosine_attention_moments)):
            reset_counts()
            ours = _moment_grads(lambda *t: fn(mesh, *t), q, k, v, cot)
            total = [a + b for a, b in zip(total, counts())]
            ref = _moment_grads(lambda *t: attention_moments(*t, act),
                                q, k, v, cot)
            if not all(a.dtype == b.dtype and torch.equal(a, b)
                       for a, b in zip(ours, ref)):
                raise AssertionError(f"world-1 sharded {act} moments or "
                                     f"gradients at {(n, d, c)} differ from "
                                     f"single-device")
        del q, k, v, cot, ours, ref
    total = tuple(total)
    levels = len(K3_LEVELS)
    log(f"  world-1 sharded softmax and cosine moments and their dQ, dK, dV "
        f"at the 512² b2 bf16 levels: bit for bit the single-device ones; "
        f"launches K1-K5 {total}")
    if total != (0, 0, levels, levels, levels):
        raise AssertionError(f"sharded moments' gradients: launches {total}")
    return total


STYLIZER_GRAD_RUNS = 3   # full backwards of the bare route: its spread


def _stylizer_param_grads(mesh):
    """One f32 gradient of a fixed loss (the mean square of the output
    times a seeded cotangent) through ``stylizing_network(...,
    mesh=make_mesh(1))`` of the seeded AdaAttN (VGG19 seed 0, AdaAttN
    seed 1) at the training shapes (256² b8, softmax) against
    ``mesh=None`` on the same inputs, cuDNN deterministic.  The output
    and the three attention outputs the decoder reads must be bit for
    bit the bare ones.  torch's bilinear ×2 and reflect-pad backwards in
    the decoder accumulate with atomics, so two backwards of one graph
    differ in the last bits; the attention parameters' (f, g, h)
    gradients are therefore taken from both graphs for one cotangent of
    the decoder's inputs (one decoder backward) and must be bit for bit,
    with K3 3, K4 3 and K5 3 launches in the mesh route (forward and
    backward).  A whole ``backward()`` with the mesh launches the same,
    and its decoder gradients (the attention convs' true gradients at
    the seeded variance clamp are float32 noise, up to 0.23 of their
    scale between two bare runs) must lie within 4 × the spread of
    STYLIZER_GRAD_RUNS bare ones (bit for bit where they are), each
    relative to its key's largest.  Returns those launches and the
    numbers."""
    from vst_tpu_torch.models import adaattn as ada_m

    apply_precision(torch.float32)
    vgg, net = _ada_models(0, 1, torch.float32)
    rng = np.random.default_rng(35)
    c, s = _image_batch(rng, TRAIN_BATCH, (256, 256))
    with torch.no_grad():
        fc, fs = vgg(c), vgg(s)
    cot = torch.from_numpy(rng.standard_normal((TRAIN_BATCH, 256, 256, 3))
                           .astype(np.float32)).cuda()
    names = [k for k, _ in net.named_parameters()]
    attn = [p for k, p in net.named_parameters() if k.startswith("adaattn.")]
    taps, decoder = [], ada_m.decoder

    def recording(params, x5, x4, x3, spatial=None):
        taps.append((x5, x4, x3))
        return decoder(params, x5, x4, x3, spatial)

    def forward(m):
        out = ada_m.stylizing_network(net, fc, fs, "softmax", mesh=m)
        return out, (out * cot).square().mean()

    def full(m):
        net.zero_grad()
        forward(m)[1].backward()
        torch.cuda.synchronize()
        return {k: p.grad.detach().clone()
                for k, p in net.named_parameters()}

    def dist_(a, b):
        return max((a[k] - b[k]).abs().max().item()
                   / max(b[k].abs().max().item(), 1e-30)
                   for k in b if k.startswith("decoder."))

    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    ada_m.decoder = recording
    try:
        out_b, loss_b = forward(None)
        reset_counts()
        out_m, _ = forward(mesh)
        (taps_b, taps_m), taps[:] = taps, []
        same_fwd = torch.equal(out_m, out_b) and all(
            torch.equal(a, b) for a, b in zip(taps_m, taps_b))
        g_taps = torch.autograd.grad(loss_b, taps_b, retain_graph=True)
        g_m = torch.autograd.grad(taps_m, attn, g_taps)
        launches = counts()
        g_b = torch.autograd.grad(taps_b, attn, g_taps)
        del out_b, loss_b, out_m, taps_b, taps_m, g_taps
        bare = [full(None) for _ in range(STYLIZER_GRAD_RUNS)]
        reset_counts()
        ours = full(mesh)
        if counts() != launches:
            raise AssertionError(f"stylizer backward(): launches "
                                 f"{counts()}, not {launches}")
    finally:
        ada_m.decoder = decoder
        torch.backends.cudnn.deterministic = saved
    attn_bitwise = all(torch.equal(a, b) for a, b in zip(g_m, g_b))
    ref = bare[0]
    bare_bitwise = all(torch.equal(b[k], ref[k]) for b in bare[1:]
                       for k in ref if k.startswith("decoder."))
    spread = max(dist_(b, ref) for b in bare[1:])
    err = dist_(ours, ref)
    log(f"  stylizing_network(mesh=make_mesh(1)) f32 256² b8 softmax: "
        f"output and attention outputs {'bit for bit' if same_fwd else 'DIFFER'}"
        f"; the {len(attn)} attention-parameter gradients for one decoder "
        f"cotangent {'bit for bit' if attn_bitwise else 'DIFFER'}; the "
        f"{len(names) - len(attn)} decoder gradients through backward() max "
        f"rel {err:.3e} against mesh=None "
        f"({STYLIZER_GRAD_RUNS} bare runs "
        f"{'bit for bit' if bare_bitwise else f'within {spread:.3e}'}); "
        f"launches K1-K5 {launches}")
    if launches != (0, 0, 3, 3, 3):
        raise AssertionError(f"stylizer gradients: launches {launches}")
    if not (same_fwd and attn_bitwise) or (
            bare_bitwise and err > 0) or err > 4 * spread:
        raise AssertionError(f"stylizer gradients with the mesh: forward "
                             f"equal {same_fwd}, attention gradients equal "
                             f"{attn_bitwise}, max rel {err} (bare runs "
                             f"{spread})")
    del vgg, net, fc, fs, bare, ours
    return launches, {"attention_grads_bitwise": attn_bitwise,
                      "forward_bitwise": same_fwd,
                      "bare_runs_bitwise": bare_bitwise,
                      "max_rel_diff": err, "bare_runs_max_rel_diff": spread}


def _profile_names(log_dir):
    """The Chrome trace of one 512² bf16 ReCoNet forward under
    ``utils.profiling.trace_context``: the kernel events must name K1's
    (``conv3x3_wgmma<true, …>``, reflect padding, with its
    ``finalize_stats``) and K2's (``conv3x3_wgmma<false, …>``) bodies, 10
    and 2 of them."""
    from vst_tpu_torch.utils.profiling import trace_context

    model = init_reconet(0, device="cuda", dtype=torch.bfloat16)
    x = np.random.default_rng(33).integers(0, 256, (1, 512, 512, 3)).astype(
        np.uint8)
    stylize_reconet(model, x, uint8_out=True)
    torch.cuda.synchronize()
    shutil.rmtree(log_dir, ignore_errors=True)
    with trace_context(log_dir):
        stylize_reconet(model, x, uint8_out=True)
        torch.cuda.synchronize()
    (path,) = [os.path.join(log_dir, f) for f in os.listdir(log_dir)]
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    k1 = sum(("conv3x3_wgmma<true" in n or "conv3x3_wgmmaILb1" in n)
             for n in names)
    k2 = sum(("conv3x3_wgmma<false" in n or "conv3x3_wgmmaILb0" in n)
             for n in names)
    stats = sum("finalize_stats" in n for n in names)
    log(f"  trace_context: {os.path.basename(path)}, {len(events)} events, "
        f"{len(names)} kernels: K1 conv3x3_wgmma<true,…> {k1}, "
        f"finalize_stats {stats}, K2 conv3x3_wgmma<false,…> {k2}")
    shutil.rmtree(log_dir, ignore_errors=True)
    if (k1, k2) != (10, 2) or stats < 10:
        raise AssertionError(f"trace: K1 {k1}, K2 {k2}, finalize_stats "
                             f"{stats} kernel events (expected 10, 2, >= 10)")
    return {"events": len(events), "kernels": len(names), "K1": k1, "K2": k2}


# ---------------------------------------------------- spatial (H-sharded)

# The 4K frame of the spatial part of [8] and its style, and what it
# launches: K1 at the residual level (1, 540, 960, C), in its halo-rows
# mode over a world-1 rank's whole frame (1, 542, 962, C) and, in [3], a
# 4-way split's interior shards (1, 137, 962, C); K2 on the packed
# (1, 542, 962, ·); K3 at the content's level token counts against the
# 512² style's.
SPATIAL_FRAME = (2160, 3840)
SPATIAL_STYLE = 512
SPATIAL_SPLIT = 4
K1_SPATIAL = {"ReCoNet 4K": (1, 540, 960, 192), "SD 4K": (1, 540, 960, 64),
              "RTNSTV 4K": (1, 540, 960, 48)}
K2_SPATIAL = {"4K ReCoNet stem": (1, 542, 962, 48, 768),
              "4K ReCoNet head": (1, 542, 962, 768, 48),
              "4K SD2 stem": (1, 542, 962, 48, 256),
              "4K SD2 head": (1, 542, 962, 256, 48)}
K3_SPATIAL = [("bf16 4K content", torch.bfloat16, (1, n, m, d, c), 1.0, "")
              for n, m, d, c in ((518400, 16384, 448, 256),
                                 (129600, 4096, 960, 512),
                                 (32400, 1024, 1472, 512))]
# The data × space part of [8]: every step builder at its config's size on
# a world-1 ("data", "space") mesh.  K1 runs its halo-rows mode on the
# rank's whole frame with its border, held in [3] also split in 2: the flow
# step's and the SD1 stage's teacher's (4, 92, 162, 192) (the frame pair
# as one batch of 4), the coco step's (4, 66, 66, 192), the SD students'
# and the SD2 stage's teacher's (4, 92, 162, 64), RTNSTV's
# (4, 92, 162, 48); K2 the packed stems and heads of [5c] (RC_K2) and
# those below; K3-K5 the f32 AdaAttN image step's training levels.
K1_FLOW = {"flow step": (4, 90, 160, 192), "coco step": (4, 64, 64, 192),
           "SD steps": (4, 90, 160, 64), "RTNSTV step": (4, 90, 160, 48)}
K2_TRAIN = {"coco stem": (4, 66, 66, 48, 768),
            "coco head": (4, 66, 66, 768, 48),
            "SD1 stem": (4, 92, 162, 48, 512),
            "SD1 head": (4, 92, 162, 512, 48),
            "SD2 stem": (4, 92, 162, 48, 256),
            "SD2 head": (4, 92, 162, 256, 48)}
FLOW_SPLITS = (2, 1)
# Uneven row blocks (``parallel/spatial.py::row_layout``) as 4 ranks hold
# them: a 1080×1920 ReCoNet frame in 4-row units (272, 272, 268, 268 rows;
# 68, 68, 67, 67 at the residual level) and the 360×640 b2 flow step's
# frame pair in 8-row units (96, 88, 88, 88; 24, 22, 22, 22), K1's halo
# mode at both residual levels (RTNSTV's 48 channels at the flow split)
# and whole, and at the whole residual level of a 356×640 flow step (89
# rows); K2 on the blocks' packed stems and heads (⌈R/4⌉ + 2 rows) and on
# the whole 1078×1920 frame's and the 356×640 step's, which [8] serves and
# trains at world 1; K3-K5 at the query shards of a 272×256 b8 AdaAttN
# image step over 2 ranks (17 units of 16 rows: 144 and 128) at its three
# attention levels against the whole 272×256 style's keys.
RECONET_1080 = (68, 68, 67, 67)
FLOW_UNEVEN = (24, 22, 22, 22)
K1_UNEVEN = {"ReCoNet 1080p": ((1, 270, 480, 192), (RECONET_1080, (270,))),
             "flow step": ((4, 90, 160, 192), (FLOW_UNEVEN,)),
             "RTNSTV step": ((4, 90, 160, 48), (FLOW_UNEVEN,)),
             "flow step 356": ((4, 89, 160, 192), ((89,),))}
K2_UNEVEN = {f"{what} {rows} rows {kind}": (n, -(-rows // 4) + 2, wp, *ch)
             for what, n, wp, all_rows in (
                 ("1080p block", 1, 482, (272, 268)),
                 ("1078p whole", 1, 482, (1080,)),
                 ("flow block", 4, 162, (96, 88)),
                 ("356 flow whole", 4, 162, (356,)))
             for rows in all_rows
             for kind, ch in (("stem", (48, 768)), ("head", (768, 48)))}
UNEVEN_FRAME = (1078, 1920)
FLOW_356 = (356, 640)
ATTN_UNEVEN = [(TRAIN_BATCH, (rows >> lv) * (256 >> lv),
                (272 >> lv) * (256 >> lv), d, c)
               for rows in (144, 128)
               for lv, (_, d, c) in zip((2, 3, 4), TRAIN_LEVELS)]


def _k1_halo_check(g, dtype, label, shape, tol,
                   splits=(SPATIAL_SPLIT, 1)):
    """K1's halo-rows mode at ``shape`` (N, H, W, C), without and with its
    prologue: the tensor reflect-padded and cut into each of ``splits``
    row shards that carry their neighbours' rows (what the exchange hands
    over; 1: a world-1 rank's; a tuple: blocks of those rows, an uneven
    layout's); every shard launched twice for the same bits.
    The stitched y and the summed statistics are held against the halo
    mode's plain version and against one reflect-mode launch on the whole
    tensor (itself held against the plain version).  Returns (the worst
    y error, whether y equals the reflect launch's bits)."""
    x, wt, b, gamma, beta = k1_inputs(g, dtype, shape)
    n, h, wd, _ = x.shape
    co = wt.shape[3]
    y0, s0 = res_block.conv3x3_in_stats(x, wt, b)
    worst, same = 0.0, True
    for pro in (False, True):
        xin = y0 if pro else x
        kw = dict(stats_in=s0, gamma=gamma, beta=beta) if pro else {}
        yr, sr = res_block.conv3x3_in_stats(xin, wt, b, **kw)
        xp = ops_conv.reflection_pad2d(xin, 1)
        for parts in splits:
            rows = ((h // parts,) * parts if isinstance(parts, int)
                    else parts)
            ys, yps, sums, psums = [], [], 0, 0
            for start, r in zip(np.cumsum((0,) + rows[:-1]), rows):
                xh = xp[:, start:start + r + 2].contiguous()
                CHECKED.add(("K1h", dtype, tuple(xh.shape), co))
                y, sm = res_block.conv3x3_in_stats_halo(xh, wt, b, **kw)
                again = res_block.conv3x3_in_stats_halo(xh, wt, b, **kw)
                if not (torch.equal(y, again[0])
                        and torch.equal(sm, again[1])):
                    raise AssertionError(f"K1 halo {label}: two launches "
                                         f"differ")
                yp, sp = res_block.conv3x3_in_stats_halo_plain(xh, wt, b,
                                                               **kw)
                ys.append(y)
                yps.append(yp)
                sums, psums = sums + sm, psums + sp
            y, yp = torch.cat(ys, 1), torch.cat(yps, 1)
            tag = (f"K1 halo {label} {tuple(x.shape)} in {parts}"
                   f"{' prologue' if pro else ''}")
            worst = max(worst, check(f"{tag} y", y, yp, tol))
            check(f"{tag} y against the reflect launch", y, yr, tol)
            check(f"{tag} reflect launch against plain", yr, yp, tol)
            check(f"{tag} sums", sums, psums, 1e-4)
            mean = sums[:, 0] / (h * wd)
            check(f"{tag} stats against the reflect launch",
                  torch.stack([mean, sums[:, 1] / (h * wd) - mean * mean], 1),
                  sr, 1e-4)
            same = same and torch.equal(y, yr)
    CHECKED.add(("K1", dtype, tuple(x.shape), co))
    return worst, same


def _k1_narrow_halo_edges(g, dtype, key, tol, errs, same):
    """K1's halo-rows mode at K1_NARROW_EDGES (whole, and the 90-row case
    also in 2 shards): the stitched y must be one reflect launch's bits."""
    for label, shape in K1_NARROW_EDGES.items():
        splits = (2, 1) if shape[1] >= 4 else (1,)
        e, exact = _k1_halo_check(g, dtype, label, shape, tol, splits)
        same[f"{key} {label}"] = exact
        errs[key] = max(errs[key], e)
        if not exact:
            raise AssertionError(f"K1 halo {label} {splits}: the stitched "
                                 f"shards differ from one reflect launch")


def phase_kernels_spatial(g):
    """[3]'s cases of the spatial and data × space parts of [8]: K1's
    halo-rows mode at K1_SPATIAL, K1_FLOW and the uneven blocks of
    K1_UNEVEN in bf16 and f32 (``_k1_halo_check``; the uneven blocks'
    stitched y must be one reflect launch's bits), K2 at K2_SPATIAL,
    RC_K2, K2_TRAIN and K2_UNEVEN, K3, K4 and K5 at ATTN_UNEVEN's query
    shards in bf16 and f32, and K3 at K3_SPATIAL against their plain
    versions, each launched twice for the same bits; and the f32 K3, K4
    and K5 at the AdaAttN image step's training levels against float64,
    where [3]'s K3-K5 phases have not held them yet (``--spatial`` runs
    this phase alone).  Tolerances as
    [3]'s: bf16 one bf16 ulp of the output's scale, f32 1e-4 of it, the
    statistics 1e-4."""
    log("[3] K1's halo-rows mode, K2 and K3 at the spatial part's 4K shapes "
        "and the data × space steps', and K1-K5 at uneven row blocks")
    errs, same = {}, {}
    for dtype, key, tol in ((torch.float32, "K1 halo f32", 1e-4),
                            (torch.bfloat16, "K1 halo", BF16_ULP)):
        apply_precision(dtype)
        errs[key] = 0.0
        for label, shape in K1_SPATIAL.items():
            e, same[f"{key} {label}"] = _k1_halo_check(g, dtype, label,
                                                       shape, tol)
            errs[key] = max(errs[key], e)
        for label, shape in K1_FLOW.items():
            e, same[f"{key} {label}"] = _k1_halo_check(
                g, dtype, label, shape, tol, FLOW_SPLITS)
            errs[key] = max(errs[key], e)
        for label, shape in {**K2_SPATIAL, **RC_K2, **K2_TRAIN}.items():
            _k2_check(g, dtype, label, shape, tol)
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        for label, (shape, splits) in K1_UNEVEN.items():
            e, exact = _k1_halo_check(g, dtype, label, shape, tol, splits)
            same[f"{key} {label} uneven"] = exact
            errs[key] = max(errs[key], e)
            if not exact:
                raise AssertionError(f"K1 halo {label} {splits}: the "
                                     f"stitched blocks differ from one "
                                     f"reflect launch")
        _k1_narrow_halo_edges(g, dtype, key, tol, errs, same)
        errs[f"K2 uneven {tag}"] = max(
            _k2_check(g, dtype, label, shape, tol)
            for label, shape in K2_UNEVEN.items())
        k3, k45 = [], []
        for shape in ATTN_UNEVEN:
            k3.append(_k3_check(g, f"{tag} uneven query shard", dtype, shape,
                                1.0, ""))
            k45 += _k45_check(g, f"{tag} uneven query shard", dtype, shape,
                              1.0, "")
        errs[f"K3 uneven {tag}"], errs[f"K4/K5 uneven {tag}"] = (max(k3),
                                                                 max(k45))
        apply_precision(dtype)
    for case in K3_SPATIAL:
        _k3_check(g, *case)
    for n, d, c in TRAIN_LEVELS:
        shape = (TRAIN_BATCH, n, n, d, c)
        if ("K3", torch.float32, shape, "") not in CHECKED:
            _k3_check(g, "f32", torch.float32, shape, 1.0, "")
        if ("K4", torch.float32, shape, "") not in CHECKED:
            _k45_check(g, "f32", torch.float32, shape, 1.0, "")
    log(f"  K1 halo mode: a second launch gives the same bits; y equals one "
        f"reflect-mode launch bit for bit: {json.dumps(same)}")
    apply_precision(torch.bfloat16)
    torch.cuda.synchronize()
    errs["K1 halo same bits as reflect"] = same
    return errs


def _host_ms(fn, runs):
    """Host-clock ms of each synchronized call of ``fn``."""
    out = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


PAD_RANGES = ("vst::exchange_rows", "vst::reflection_pad2d")


def _copy_share(forward, top=0, ranges=PAD_RANGES):
    """Device time of one forward (torch.profiler) and the share of it in
    the padded copies: the kernels launched inside the profiler ranges of
    ``parallel/spatial.py``'s ``exchange_rows`` (the sharded layers' halo
    rows and W border, written in one copy) and ``ops/pad.py``'s
    ``reflection_pad2d`` (the unsharded layers' pad), and the ranges'
    spans on the device's timeline.  The ranges' own device-side rows are
    left out of the total (they would count their kernels twice).
    ``top``: log that many of the largest kernels.  ``ranges``: the
    profiler ranges counted as copies (each one's device ms also comes
    back in "by_range")."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        forward()
        torch.cuda.synchronize()
    events = prof.events()

    def ranged(e):
        return e.name.startswith("vst::") or getattr(
            e, "is_user_annotation", False)

    kernels = [e for e in events
               if e.device_type == DeviceType.CUDA and not ranged(e)]
    total = sum(e.self_device_time_total for e in kernels) / 1e3
    by_range = {r: sum(e.device_time_total for e in events
                       if e.device_type == DeviceType.CPU and e.name == r)
                / 1e3 for r in ranges}
    copies = sum(by_range.values())
    span = sum(e.self_device_time_total for e in events
               if e.device_type == DeviceType.CUDA
               and e.name in ranges) / 1e3
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.self_device_time_total
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        log(f"    {us / 1e3:9.3f} ms  {name[:96]}")
    return {"device_ms": total, "copies_ms": copies, "copies_span_ms": span,
            "copies_share": copies / total if total else None,
            "by_range": by_range}


def _spatial_case(label, mesh, sharded, unsharded, network, expect, tol,
                  network32=None, timed=5):
    """One model of the spatial part: the sharded entry point against the
    unsharded one (the network's unclamped outputs through ``network``
    (ctx or None), the max error and whether the bits are the same), ms
    per frame of both (median of ``timed``, alternating, after a warm-up
    of each), the launches per sharded frame (every K1 launch in the
    halo-rows mode; ``expect`` K1, K2, K3), and each forward's share of
    device time in padded copies.

    f32 (``network32`` None): sharded within ``tol`` of the unsharded
    output's scale.  bf16: both against ``network32()``, the same weights
    unsharded in f32 through the plain versions; the sharded output may
    lie no further from it than 1.5 × the unsharded bf16 output's own
    distance plus ``tol`` of the scale (bf16 rounding moves outputs whole
    steps, and the two paths round in different places)."""
    from vst_tpu_torch.parallel.spatial import SpatialContext

    ctx = SpatialContext(mesh)
    with torch.inference_mode():
        ref = network(None)
        out = network(ctx)
    same = torch.equal(out, ref)
    if network32 is None:
        err = check(f"{label}: sharded network output against unsharded",
                    out, ref, tol)
        dist32 = None
    else:
        with torch.inference_mode(), plain_kernels():
            r32 = network32()
        err = max_err(out, ref)
        dist32 = {"unsharded": max_err(ref, r32), "sharded": max_err(out, r32)}
        limit = 1.5 * dist32["unsharded"] + tol * r32.abs().max().item()
        ok = dist32["sharded"] <= limit
        log(f"  {label}: against the f32 plain unsharded output: sharded "
            f"{dist32['sharded']:.3e}, unsharded {dist32['unsharded']:.3e} "
            f"(limit {limit:.3e}) {'ok' if ok else 'FAIL'}; sharded against "
            f"unsharded {err:.3e}, "
            f"{(out != ref).float().mean().item():.2e} of the values differ")
        if not ok:
            raise AssertionError(f"{label}: sharded output {dist32} from f32")
        del r32
    del out, ref
    n, halo = [0] * 5, 0

    def counted():
        # the counts set to 0 just before each sharded frame, read after
        nonlocal halo
        reset_counts()
        sharded()
        n[:] = [t + k for t, k in zip(n, counts())]
        halo += res_block.conv3x3_in_stats_halo.launches

    counted()     # the sharded warm-up (``network`` warmed the unsharded)
    ms_u, ms_s = [], []
    for _ in range(timed):
        ms_s += _host_ms(counted, 1)
        ms_u += _host_ms(unsharded, 1)
    n = tuple(n)
    runs = timed + 1
    per = tuple(k // runs for k in n[:3])
    if per != expect or halo != n[0] or any(k % runs for k in n):
        raise AssertionError(f"{label}: launches {n} over {runs} frames "
                             f"(halo mode {halo}); expected {expect} a frame, "
                             f"all K1 in the halo-rows mode")
    res = {"max_abs_err": err, "bits_equal": same, "err_vs_f32": dist32,
           "ms_sharded": float(np.median(ms_s)),
           "ms_unsharded": float(np.median(ms_u)),
           "ms_sharded_runs": ms_s, "ms_unsharded_runs": ms_u,
           "launches_per_frame": dict(zip(("K1", "K2", "K3"), per)),
           "launches": dict(zip(("K1", "K2", "K3", "K4", "K5"), n)),
           "profile_sharded": _copy_share(
               sharded, top=6, ranges=PAD_RANGES + ("vst::relayout_rows",)),
           "profile_unsharded": _copy_share(unsharded, top=4)}
    log(f"  {label}: max_abs_err {err:.3e} (bits {'equal' if same else 'differ'}"
        f"); ms per frame sharded {res['ms_sharded']:.3f}, unsharded "
        f"{res['ms_unsharded']:.3f}; launches per frame {per} (K1 all in the "
        f"halo mode); relayout_rows "
        f"{res['profile_sharded']['by_range']['vst::relayout_rows']:.3f} "
        f"device ms; padded copies {100 * res['profile_sharded']['copies_share']:.1f}% "
        f"of {res['profile_sharded']['device_ms']:.3f} device ms sharded, "
        f"{100 * res['profile_unsharded']['copies_share']:.1f}% of "
        f"{res['profile_unsharded']['device_ms']:.3f} unsharded")
    return res


def _spatial_serving(mesh_space):
    """The spatial part of [8] at world 1 (``mesh_space``, a 1-rank
    "space" mesh on cuda:0): one 2160×3840 uint8 frame (batch 1, on the
    card) through ``stylize_spatial_sharded`` (ReCoNet bf16 and f32, SD2
    bf16, RTNSTV bf16; and ReCoNet bf16 on its top-left 1078×1920, an H
    that is not a multiple of 4) and ``stylize_adaattn_sharded`` (softmax bf16,
    cosine f32, against a 512² style), each against its unsharded
    ``stylize_*`` (``_spatial_case``).  Every K1, K2 and K3 launch must
    fall on a shape [3] held (CHECKED).  Returns its launches (K1-K5, the
    sharded runs) and numbers."""
    from vst_tpu_torch.infer.image import (stylize_adaattn_sharded,
                                           stylize_spatial_sharded)
    from vst_tpu_torch.models.adaattn import stylizing_network
    from vst_tpu_torch.parallel import shard_spatial

    h, w = SPATIAL_FRAME
    rng = np.random.default_rng(35)
    frame = torch.from_numpy(rng.integers(0, 256, (1, h, w, 3)).astype(
        np.uint8)).cuda()
    style = torch.from_numpy(rng.integers(
        0, 256, (1, SPATIAL_STYLE, SPATIAL_STYLE, 3)).astype(np.uint8)).cuda()
    res, total = {}, [0] * 5
    t0 = time.perf_counter()
    with recording_launches() as seen:
        for label, make, dtype, plain, expect in (
                ("ReCoNet bf16", init_reconet, torch.bfloat16,
                 stylize_reconet, (10, 2, 0)),
                ("ReCoNet f32", init_reconet, torch.float32, stylize_reconet,
                 (10, 2, 0)),
                ("SD2 bf16", init_reconet_sd2, torch.bfloat16,
                 stylize_reconet, (10, 2, 0)),
                ("RTNSTV bf16", rtnstv_m.init_stylizing_network,
                 torch.bfloat16, stylize_rtnstv, (10, 0, 0))):
            apply_precision(dtype)
            model = make(0, device="cuda", dtype=dtype)
            xin = frame.to(dtype)

            def network(ctx, model=model, xin=xin):
                y = model(xin if ctx is None else shard_spatial(
                    ctx.mesh, xin, ctx.axis), spatial=ctx)
                return y[-1] if isinstance(y, tuple) else y

            def network32(make=make):
                apply_precision(torch.float32)
                y = make(0, device="cuda")(frame.float())
                apply_precision(dtype)
                return y[-1] if isinstance(y, tuple) else y

            res[label] = _spatial_case(
                label, mesh_space,
                lambda model=model: stylize_spatial_sharded(model, frame,
                                                            mesh_space),
                lambda model=model, plain=plain: plain(model, frame),
                network, expect,
                1e-5 if dtype == torch.float32 else 2 * BF16_ULP,
                None if dtype == torch.float32 else network32)
            total = [t + k for t, k in zip(total, res[label]["launches"].values())]
            del model, xin
        # 1078 rows: not a multiple of 4, which the even rule refused at
        # world 1; the model's output has 1080, as the unsharded model's
        apply_precision(torch.bfloat16)
        model = init_reconet(0, device="cuda", dtype=torch.bfloat16)
        small = frame[:, :UNEVEN_FRAME[0], :UNEVEN_FRAME[1]].contiguous()
        x16 = small.to(torch.bfloat16)

        def network(ctx, model=model, xin=x16):
            return model(xin if ctx is None else shard_spatial(
                ctx.mesh, xin, ctx.axis), spatial=ctx)[-1]

        def network32():
            apply_precision(torch.float32)
            y = init_reconet(0, device="cuda")(small.float())[-1]
            apply_precision(torch.bfloat16)
            return y

        label = "ReCoNet bf16 1078×1920"
        res[label] = _spatial_case(
            label, mesh_space,
            lambda: stylize_spatial_sharded(model, small, mesh_space),
            lambda: stylize_reconet(model, small), network, (10, 2, 0),
            2 * BF16_ULP, network32)
        total = [t + k for t, k in zip(total, res[label]["launches"].values())]
        del model, small, x16
        for act, dtype in (("softmax", torch.bfloat16),
                           ("cosine", torch.float32)):
            apply_precision(dtype)
            vgg, net = _ada_models(0, 1, dtype)
            label = f"AdaAttN {act} {'bf16' if dtype == torch.bfloat16 else 'f32'}"
            c_in, s_in = frame.to(dtype), style.to(dtype)

            def network(ctx, vgg=vgg, net=net, act=act, c_in=c_in,
                        s_in=s_in):
                fc = vgg(c_in if ctx is None else shard_spatial(
                    ctx.mesh, c_in, ctx.axis), spatial=ctx)
                return stylizing_network(net, fc, vgg(s_in), act,
                                         spatial=ctx)

            def network32(act=act):
                apply_precision(torch.float32)
                v32, n32 = _ada_models(0, 1, torch.float32)
                y = stylizing_network(n32, v32(frame.float()),
                                      v32(style.float()), act)
                apply_precision(dtype)
                return y

            res[label] = _spatial_case(
                label, mesh_space,
                lambda vgg=vgg, net=net, act=act: stylize_adaattn_sharded(
                    vgg, net, frame, style, mesh_space, act),
                lambda vgg=vgg, net=net, act=act: stylize_adaattn(
                    vgg, net, frame, style, act),
                network, (0, 0, 3 if act == "softmax" else 0),
                1e-4 if dtype == torch.float32 else 2 * BF16_ULP,
                None if dtype == torch.float32 else network32)
            total = [t + k for t, k in zip(total, res[label]["launches"].values())]
            del vgg, net, c_in, s_in
    unchecked = sorted(map(str, seen - CHECKED))
    log(f"  spatial: launched K1-K3 at {len(seen)} shapes, all held against "
        f"the plain versions in [3]" if not unchecked else
        f"  spatial: launched at shapes [3] did not check: {unchecked}")
    if unchecked:
        raise AssertionError(f"spatial: shapes not checked: {unchecked}")
    res["wall_s"] = time.perf_counter() - t0
    launches = dict(zip(("K1", "K2", "K3", "K4", "K5"), total))
    log(f"  spatial: launches over its sharded runs {launches}; wall "
        f"{res['wall_s']:.1f} s")
    apply_precision(torch.bfloat16)
    return launches, res


def _k1h_plain64(*a):
    return res_block.Conv3x3InStatsHalo.apply(
        *a, *([None] * (6 - len(a))), res_block.conv3x3_in_stats_halo_plain)


def _k1_halo_grad_checks(g):
    """K1's halo-rows Function on the card (kernel forward, library VJP)
    against the same Function's plain route in float64 on the card, at the
    sharded flow step's shape (xh (4, 92, 162, 192): a world-1 rank's
    frame with its border), without and with the prologue, f32 and bf16,
    at [5c]'s tolerances (GRAD_TOLS).  Returns the worst error of each."""
    errs = {}
    names = ("xh", "w", "b", "stats_in", "gamma", "beta")
    for dtype, tol in GRAD_TOLS.items():
        tag = "f32" if dtype == torch.float32 else "bf16"
        apply_precision(dtype)
        for prologue in (False, True):
            args, cot = _k1_grad_inputs(g, dtype, prologue)
            args[0] = ops_conv.reflection_pad2d(args[0], 1)
            ours = _vjp(res_block.conv3x3_in_stats_halo, args, cot)
            ref = _vjp(_k1h_plain64, [a.double() for a in args], cot)
            e = [max_err(a, r) / r.abs().max().item()
                 for a, r in zip(ours, ref)]
            label = (f"K1 halo Function {tag} {tuple(args[0].shape)}"
                     f"{' prologue' if prologue else ''}")
            log(f"  {label}: gradient errors of the largest against float64 "
                + ", ".join(f"{k} {v:.2e}" for k, v in zip(names, e))
                + f" tol {tol:.0e}")
            errs[f"{tag}{' prologue' if prologue else ''}"] = max(e)
            if not max(e) <= tol:
                raise AssertionError(f"{label} gradient: {e}")
    return errs


# The data × space steps' checks hold the sharded and the bare step to the
# plain float64 bare step, as [5c] holds the kernel route: the sharded
# step's distance from it within the larger of a floor and 2 × the bare
# step's own (floors: metrics 1e-4 relative, gradients 1e-3 of each key's
# largest, [5c]'s).  Two bare f32 runs agree to 1.7e-5 (NVIDIA H100 80GB
# HBM3 at 700 W), but the sharded step sums in another order (the padded
# VGG convs, the sharded statistics and loss shares), and the flow step's
# f32 gradients are differences of large terms (the FTL's weight 1e12):
# the two routes' distance (3.7e-3 there) is float32's conditioning here,
# which the float64 step measures.  The AdaAttN steps have no float64
# step here: their sharded gradients are held to the bare step's within
# the larger of the gradient floor and 4 × two bare runs' distance.
SPACE_FLOORS = (1e-4, 1e-3)
# The metrics come from the forward, which two bare runs repeat bit for
# bit: the sharded step's are held to the bare step's directly, within
# the larger of 4 × two bare runs' distance and a floor: f32 1e-5 (its
# statistics and loss shares are summed in another order; 2.0e-7
# measured on the flow step), bf16 2⁻⁸ (two bf16 roundings of some
# intermediates; 1.2e-4 measured; its distance from float64 is the bf16
# route's, 1.27 relative on both routes; NVIDIA H100 80GB HBM3 at 700 W).
SPACE_METRIC_FLOORS = {"float32": 1e-5, "bfloat16": 2.0 ** -8}
# Adam's first step moves a weight by lr·g/(|g| + eps): where |g| is near
# eps (1e-8) the update's slope eps/(|g| + eps)² turns a gradient
# difference δg ≤ |g| into up to eps/|g|·lr, so the sharded update is held
# to the bare one only where |g| > 1e3·eps as well (1e-3·lr at most).
ADAM_FIRM = 1e3 * 1e-8


def _rel_metric(a, b):
    return max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-30) for k in b
               if not math.isnan(b[k]))


@dataclasses.dataclass
class SpaceCase:
    """One step of [8]'s data × space part: ``build(cfg, mesh)`` → the
    step, from ``new_model()``; ``per_step`` its K1-K5 launches, K1's all
    in the halo-rows mode when sharded; ``keys(name)``: the parameters
    whose gradients are compared; ``ref64``: the float64 bare step's
    (metrics, gradients), or None (AdaAttN: held to two bare runs)."""
    label: str
    cfg: object
    new_model: object
    build: object
    batch: object
    per_step: tuple
    keys: object
    ref64: object = None


def _step64(cfg, new_model, build, batch):
    """The bare step of ``build`` in float64 through the plain versions:
    (metrics, gradients)."""
    state = create(new_model(), cfg.lr)
    with _float64_steps(), plain_kernels():
        step = build(dataclasses.replace(cfg, dtype="float64"), None)
        _, m = step(state, batch)
    return ({k: float(v) for k, v in m.items()}, _grads(state))


def _space_step(case, mesh, timed=6):
    """One step of ``case`` on the world-1 ("data", "space") ``mesh`` (the
    batch placed by ``shard_batch_spatial``) against two bare steps, each
    from the same seeded state.  With ``case.ref64``, all three against it:
    the sharded step's metrics and gradients within SPACE_FLOORS or 2 × the
    bare step's own distance from float64 (the keys ``case.keys`` names);
    without, the sharded step's gradients within the gradient floor or 4 ×
    two bare runs' distance of the bare step's.  Its metrics within
    SPACE_METRIC_FLOORS or 4 × two bare runs' distance of the bare step's
    (NaN where the bare step's is).  Adam's update: the sharded step's is
    Adam's first step on its own gradient within 1e-3·lr everywhere, the
    bare step's within 1e-3·lr wherever the reference gradient (float64,
    else the bare step's) lies above the gradient tolerance and ADAM_FIRM,
    and within 2.1·lr everywhere (float32 rounding decides the sign of a
    ±lr step below it); launches ``case.per_step`` a step, the sharded
    step's K1 all in the halo-rows mode.  Then 2 + ``timed`` steps
    alternating bare and sharded (host clock after a synchronize;
    median), each step's launches counted; the peak memory of one step
    each; and one step of each profiled: the sharded step's device time
    in "vst::exchange_rows" and "vst::exchange_rows_bwd", the bare step's
    in "vst::reflection_pad2d".  Returns the sharded runs' launches
    (K1-K5) and the numbers."""
    from vst_tpu_torch.parallel import shard_batch_spatial

    label, cfg, per_step = case.label, case.cfg, case.per_step
    sharded_batch = shard_batch_spatial(mesh, case.batch)
    runs = {}
    p0 = {k: v.detach().clone()
          for k, v in case.new_model().named_parameters()}
    for tag, m, b in (("bare", None, case.batch), ("again", None, case.batch),
                      ("sharded", mesh, sharded_batch)):
        state = create(case.new_model(), cfg.lr)
        step = case.build(cfg, m)
        reset_counts()
        state, metrics = step(state, b)
        torch.cuda.synchronize()
        runs[tag] = ({k: float(v) for k, v in metrics.items()},
                     _grads(state), counts(),
                     res_block.conv3x3_in_stats_halo.launches,
                     {k: p.detach().clone()
                      for k, p in state.model.named_parameters()},
                     state, step, b)
    (m0, g0, n0, h0, q0, s0, f0, b0), (ma, ga, _, _, _, _, _, _) = (
        runs["bare"], runs["again"])
    m1, g1, n1, h1, q1, s1, f1, b1 = runs["sharded"]
    if (n0 != per_step or n1 != per_step or h0 != 0
            or h1 != per_step[0]):
        raise AssertionError(f"{label}: launches bare {n0} (halo {h0}), "
                             f"sharded {n1} (halo {h1}); expected {per_step}"
                             f", the sharded K1 all in the halo-rows mode")
    keys = [k for k in g0 if case.keys(k)]

    def gdist(a, ref):
        return max(((a[k] - ref[k].to(a[k].dtype)).abs().max().item()
                    / max(ref[k].abs().max().item(), 1e-30), k)
                   for k in keys)

    pairs = {"sharded-bare": (1, 0), "bare-bare": (2, 0)}
    if case.ref64 is not None:
        pairs.update({"sharded-f64": (1, 3), "bare-f64": (0, 3)})
    ms_, gs_ = [m0, m1, ma], [g0, g1, ga]
    if case.ref64 is not None:
        ms_.append(case.ref64[0])
        gs_.append(case.ref64[1])
    dist = {"metrics": {t: _rel_metric(ms_[a], ms_[b])
                        for t, (a, b) in pairs.items()},
            "grads": {t: gdist(gs_[a], gs_[b])
                      for t, (a, b) in pairs.items()}}
    tol_mb = max(SPACE_METRIC_FLOORS[cfg.dtype],
                 4 * dist["metrics"]["bare-bare"])
    err_mb = dist["metrics"]["sharded-bare"]
    nan_ok = all(math.isnan(m1[k]) == math.isnan(m0[k]) for k in m0)
    if case.ref64 is not None:
        tol_m = max(SPACE_FLOORS[0], 2 * dist["metrics"]["bare-f64"])
        err_m = dist["metrics"]["sharded-f64"]
        tol_g = max(SPACE_FLOORS[1], 2 * dist["grads"]["bare-f64"][0])
        err_g, worst = dist["grads"]["sharded-f64"]
        gref = case.ref64[1]
    else:
        tol_m, err_m = tol_mb, err_mb
        tol_g = max(SPACE_FLOORS[1], 4 * dist["grads"]["bare-bare"][0])
        err_g, worst = dist["grads"]["sharded-bare"]
        gref = g0
    lr = cfg.lr
    own = max(((q1[k] - (p0[k] - lr * g1[k] / (g1[k].abs() + 1e-8)))
               .abs().max().item() for k in q1))
    firm, loose = 0.0, 0.0
    for k in q1:
        loose = max(loose, (q1[k] - q0[k]).abs().max().item())
        if k in keys:
            r = gref[k].abs()
            sure = r > max(tol_g * r.max().item(), ADAM_FIRM)
            if sure.any():
                firm = max(firm, (q1[k] - q0[k])[sure].abs().max().item())
    log(f"  {label}: launches K1-K5 {n1} a step, K1 all {h1} in the "
        f"halo-rows mode (bare {n0}); metrics' max rel distance "
        + ", ".join(f"{t} {v:.2e}" for t, v in dist["metrics"].items())
        + f" (tol {tol_m:.2e}, on sharded-bare {tol_mb:.2e}); gradients' "
        + ", ".join(f"{t} {v:.2e} ({k})" for t, (v, k)
                    in dist["grads"].items())
        + f" (tol {tol_g:.2e}); Adam's update: on its own gradient "
        f"{own / lr:.2e}·lr (tol 1e-3·lr), against the bare step's where "
        f"the reference gradient is above the tolerance {firm / lr:.2e}·lr "
        f"(tol 1e-3·lr), everywhere {loose / lr:.2f}·lr (tol 2.1·lr)")
    if (err_m > tol_m or err_mb > tol_mb or err_g > tol_g or not nan_ok
            or own > 1e-3 * lr or firm > 1e-3 * lr or loose > 2.1 * lr):
        raise AssertionError(f"{label}: sharded step: metrics {err_m}, "
                             f"{err_mb}, NaN alike {nan_ok}, "
                             f"gradients {err_g} ({worst}), update {own}, "
                             f"{firm}, {loose}")
    del runs, ga, g1, q0, q1
    launches = list(n1)
    times = {"bare": [], "sharded": []}
    for i in range(2 + timed):
        for tag, state, step, b in (("bare", s0, f0, b0),
                                    ("sharded", s1, f1, b1)):
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(state, b)
            torch.cuda.synchronize()
            if i >= 2:
                times[tag].append((time.perf_counter() - t0) * 1e3)
            n = counts()
            if n != per_step:
                raise AssertionError(f"{label}: timed {tag} step {i} "
                                     f"launched {n}")
            if tag == "sharded":
                launches = [a + c for a, c in zip(launches, n)]
    peak = {}
    for tag, state, step, b in (("bare", s0, f0, b0),
                                ("sharded", s1, f1, b1)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        step(state, b)
        torch.cuda.synchronize()
        top = torch.cuda.max_memory_allocated()
        peak[tag] = {"peak_gib": top / 2**30,
                     "step_gib": (top - base) / 2**30}
        if tag == "sharded":
            launches = [a + c for a, c in zip(launches, counts())]
    reset_counts()
    prof_s = _copy_share(lambda: f1(s1, b1), top=6,
                         ranges=("vst::exchange_rows",
                                 "vst::exchange_rows_bwd",
                                 "vst::relayout_rows"))
    launches = [a + c for a, c in zip(launches, counts())]
    prof_b = _copy_share(lambda: f0(s0, b0), top=4,
                         ranges=("vst::reflection_pad2d",))
    ms = {t: float(np.median(v)) for t, v in times.items()}
    share = {r: v / prof_s["device_ms"] for r, v in prof_s["by_range"].items()}
    log(f"  {label}: {ms['bare']:.3f} ms/step bare, {ms['sharded']:.3f} "
        f"sharded (median of {timed}, alternating; "
        f"{ms['sharded'] / ms['bare'] - 1:+.2%}); "
        f"peak {peak['bare']['peak_gib']:.2f} / "
        f"{peak['sharded']['peak_gib']:.2f} GiB (the step's own "
        f"{peak['bare']['step_gib']:.2f} / {peak['sharded']['step_gib']:.2f}"
        f"); sharded device time {prof_s['device_ms']:.3f} ms, in "
        + ", ".join(f"{r} {v:.3f} ms ({share[r]:.2%})"
                    for r, v in prof_s["by_range"].items())
        + f"; bare device time {prof_b['device_ms']:.3f} ms, in "
        f"vst::reflection_pad2d {prof_b['copies_ms']:.3f} ms "
        f"({prof_b['copies_share']:.2%})")
    res = {"metrics_max_rel": dist["metrics"],
           "grad_max_rel": {t: v for t, (v, _) in dist["grads"].items()},
           "tol_metrics": tol_m, "tol_metrics_bare": tol_mb,
           "tol_grad": tol_g,
           "update_own_lr": own / lr, "update_firm_lr": firm / lr,
           "update_max_lr": loose / lr, "ms_bare": ms["bare"],
           "ms_sharded": ms["sharded"], "ms_bare_runs": times["bare"],
           "ms_sharded_runs": times["sharded"], "memory": peak,
           "device_ms_sharded": prof_s["device_ms"],
           "device_ms_bare": prof_b["device_ms"],
           "exchange_ms": prof_s["by_range"], "exchange_share": share,
           "bare_pad_share": prof_b["copies_share"],
           "launches_per_step": dict(zip(("K1", "K2", "K3", "K4", "K5"),
                                         per_step))}
    del s0, s1, f0, f1
    return launches, res


def _space_cases():
    """[8]'s data × space steps, each at its config's own size, f32 (the
    configs' default) but the flow step's bf16 run: RECONET_CANDY's flow
    step (360×640 b2, [5c]'s seeded state, grams and batch) in f32 and
    bf16; the coco step (ReCoNetCocoConfig 256² b4); the SD1 and SD2
    distillation stages (360×640 b2, the flow batch; teachers ReCoNet seed
    0 and SD1 seed 2); RTNSTV (RTNSTVConfig 360×640 b2, RTNSTV seed 1,
    VGG19 seed 0); the AdaAttN image step (256² b8 softmax) and video step
    (256×512 b4 cosine; VGG19 seed 0, AdaAttN seed 1).  The ReCoNet and
    RTNSTV cases carry their float64 bare step.  Yields one case at a
    time, so that each one's models and batch are freed before the next."""
    rng = np.random.default_rng(20)
    vgg = init_vgg16_reconet(0, device="cuda")
    grams = _style_grams(vgg, RECONET_CANDY, rng)
    batch = _flow_batch(rng, RECONET_CANDY)

    def flow(cfg, m):
        return make_reconet_flow_step(cfg, vgg, grams, m)

    def reconet1():
        return init_reconet(1, device="cuda")

    ref = _step64(RECONET_CANDY, reconet1, flow, batch)
    for dtype in ("float32", "bfloat16"):
        tag = "f32" if dtype == "float32" else "bf16"
        yield SpaceCase(f"flow step 360×640 b2 {tag}",
                        dataclasses.replace(RECONET_CANDY, dtype=dtype),
                        reconet1, flow, batch, (10, 2, 0, 0, 0),
                        lambda k: not _before_norm(k), ref)
    # 356 rows: not a multiple of 8, which the even rule refused at world 1
    cfg356 = dataclasses.replace(RECONET_CANDY, img_size=FLOW_356)
    batch356 = tuple(t[:, :FLOW_356[0]].contiguous() for t in batch)
    yield SpaceCase("flow step 356×640 b2 f32", cfg356, reconet1, flow,
                    batch356, (10, 2, 0, 0, 0), lambda k: not _before_norm(k),
                    _step64(cfg356, reconet1, flow, batch356))
    del batch356
    ccfg = ReCoNetCocoConfig()
    cgrams = _style_grams(vgg, ccfg, rng)
    cbatch = torch.from_numpy(rng.integers(0, 256, (
        ccfg.batch_size, *ccfg.img_size, 3)).astype(np.float32)).cuda()

    def coco(cfg, m):
        return make_reconet_coco_step(cfg, vgg, cgrams, m)

    yield SpaceCase("coco step 256² b4 f32", ccfg, reconet1, coco, cbatch,
                    (10, 2, 0, 0, 0), lambda k: not _coco_zero_grad(k),
                    _step64(ccfg, reconet1, coco, cbatch))
    del cgrams, cbatch
    for dcfg, teacher, init in (
            (DISTILL_SD1, init_reconet(0, device="cuda"), init_reconet_sd1),
            (DISTILL_SD2, init_reconet_sd1(2, device="cuda"),
             init_reconet_sd2)):

        def distill(cfg, m, teacher=teacher):
            return make_reconet_distill_step(cfg, vgg, grams, teacher, m)

        def student(init=init):
            return init(1, device="cuda")

        yield SpaceCase(f"distill {dcfg.teacher}->{dcfg.student} 360×640 "
                        f"b2 f32", dcfg, student, distill, batch,
                        (20, 4, 0, 0, 0), lambda k: not _sd_before_norm(k),
                        _step64(dcfg, student, distill, batch))
    del vgg, grams, teacher
    apply_precision(torch.float32)
    rcfg = RTNSTVConfig()
    vgg19 = init_vgg19_rtnstv(0, device="cuda")
    rgrams = _rtnstv_grams(vgg19, rng)

    def rtnstv(cfg, m):
        return make_rtnstv_step(cfg, vgg19, rgrams, m)

    def rtnstv1():
        return rtnstv_m.init_stylizing_network(1, device="cuda")

    yield SpaceCase("RTNSTV step 360×640 b2 f32", rcfg, rtnstv1, rtnstv,
                    batch, (10, 0, 0, 0, 0),
                    lambda k: not _rtnstv_before_norm(k),
                    _step64(rcfg, rtnstv1, rtnstv, batch))
    del vgg19, rgrams, batch
    apply_precision(torch.float32)
    vgg19 = init_vgg19_adaattn(0, device="cuda")

    def ada1():
        return init_stylizing_network(1, device="cuda")

    icfg, vcfg = AdaAttNImageConfig(), AdaAttNVideoConfig()
    yield SpaceCase(
        "AdaAttN image step 256² b8 softmax f32", icfg, ada1,
        lambda cfg, m: make_adaattn_image_step(cfg, vgg19, m),
        _image_batch(rng, icfg.batch_size, icfg.crop_size), (0, 0, 6, 3, 3),
        lambda k: k.startswith("decoder."))
    h, w = vcfg.frame_size
    vbatch = tuple(torch.from_numpy(rng.integers(
        0, 256, (vcfg.batch_size, h, w, 3)).astype(np.float32)).cuda()
        for _ in range(3))
    yield SpaceCase(
        "AdaAttN video step 256×512 b4 cosine f32", vcfg, ada1,
        lambda cfg, m: make_adaattn_video_step(cfg, vgg19, m), vbatch,
        (0, 0, 0, 0, 0), lambda k: k.startswith("decoder."))


def _coco_zero_grad(key):
    """The coco step's parameters whose true gradient is 0: the biases an
    instance norm follows, and the residual blocks' second instance-norm
    biases. Each block adds its output to its input, and every path from
    there meets an instance norm (the next block's first, deconv1's) that
    removes a per-channel constant; the coco loss reads no tap in between
    (the flow step's FTL reads res5's output). Their float64 gradients are
    about 1e-18 of the largest."""
    return _before_norm(key) or (key.startswith("res")
                                 and key.endswith("in2.bias"))


def _sd_before_norm(key):
    """Every ReCoNet-family conv but the last (the tanh head) feeds an
    instance norm (ReCoNet's, SD1's and SD2's names alike)."""
    return key.endswith("conv2d.bias") and not key.startswith("deconv3")


SPACE_KEYS = {"flow step 360×640 b2 f32": "flow_f32",
              "flow step 360×640 b2 bf16": "flow_bf16",
              "flow step 356×640 b2 f32": "flow_356_f32",
              "coco step 256² b4 f32": "coco",
              "distill reconet->sd1 360×640 b2 f32": "sd1",
              "distill sd1->sd2 360×640 b2 f32": "sd2",
              "RTNSTV step 360×640 b2 f32": "rtnstv",
              "AdaAttN image step 256² b8 softmax f32": "adaattn_image",
              "AdaAttN video step 256×512 b4 cosine f32": "adaattn_video"}


def _spatial_training(mesh):
    """The data × space part of [8] at world 1 (``mesh``: a (1, 1) ("data",
    "space") mesh on cuda:0): K1's halo-rows Function against float64 at
    the flow step's shape (``_k1_halo_grad_checks``), then every step
    builder's step sharded against bare (``_space_cases``,
    ``_space_step``).  Every K1, K2, K3, K4 and K5 launch must fall on a
    shape [3] held (CHECKED).  Returns the launches (K1-K5) of its sharded
    runs and its numbers."""
    t0 = time.perf_counter()
    res = {"k1_halo_vjp": _k1_halo_grad_checks(
        torch.Generator(device="cuda").manual_seed(36))}
    apply_precision(torch.float32)
    total = [0] * 5
    with recording_launches() as seen:
        t_case = time.perf_counter()
        for case in _space_cases():
            n, res[SPACE_KEYS[case.label]] = _space_step(case, mesh)
            total = [a + b for a, b in zip(total, n)]
            log(f"  {case.label}: wall {time.perf_counter() - t_case:.1f} s "
                f"(its float64 step included)")
            del case
            t_case = time.perf_counter()
    unchecked = sorted(map(str, seen - CHECKED))
    log(f"  data × space: launched K1-K5 at {len(seen)} shapes, all held "
        f"against the plain versions in [3]" if not unchecked else
        f"  data × space: launched at shapes [3] did not check: {unchecked}")
    if unchecked:
        raise AssertionError(f"data × space: shapes not checked: {unchecked}")
    res["wall_s"] = time.perf_counter() - t0
    launches = dict(zip(("K1", "K2", "K3", "K4", "K5"), total))
    log(f"  data × space: launches over its sharded runs {launches}; wall "
        f"{res['wall_s']:.1f} s")
    apply_precision(torch.bfloat16)
    return launches, res


def phase_scale_out():
    """[8] scale-out over ``torch.distributed`` on the one card: the data-
    parallel ReCoNet CLI serving at world 1 (its own group), then a world-1
    NCCL group on cuda:0 (``multihost.initialize`` over
    ``tcp://127.0.0.1:<port>``) with ``make_mesh(1)``: the f32 ReCoNet
    flow step and the bf16 AdaAttN image step with and without the mesh,
    ``AdaAttNVideoStylizer(mesh=)`` against ``mesh=None``, the ring's
    ``fold_block`` through K3 and its backward (``block_grads``, K4 and
    K5, over 4 × 4 pairs) at the 512² b2 bf16 and 256² b8 f32 levels,
    the world-1 sharded softmax and cosine moments and their gradients
    against the single-device ones, the full stylizer's parameter
    gradients with ``mesh=make_mesh(1)`` against ``mesh=None``, and a
    Chrome trace from ``trace_context``.
    Returns the launches (K1-K5) of its main-path runs and its numbers."""
    from vst_tpu_torch.parallel import make_mesh, multihost

    log("[8] scale-out: torch.distributed at world 1 (NCCL on cuda:0)")
    t_phase = time.perf_counter()
    res = {"serving_cli": _scale_out_serving()}
    total = [res["serving_cli"]["K1"], res["serving_cli"]["K2"], 0, 0, 0]
    multihost.initialize(f"127.0.0.1:{_free_port()}", 1, 0, device="cuda")
    try:
        mesh = make_mesh(1)
        log(f"  world-1 group: backend {torch.distributed.get_backend()}, "
            f"{mesh}")
        rng = np.random.default_rng(32)
        apply_precision(torch.float32)
        vgg16 = init_vgg16_reconet(0, device="cuda")
        grams = _style_grams(vgg16, RECONET_CANDY, rng)
        res["reconet_flow_f32"] = _dp_step(
            "ReCoNet flow step 360×640 b2 f32", lambda: create(
                init_reconet(1, device="cuda"), RECONET_CANDY.lr),
            lambda m: make_reconet_flow_step(RECONET_CANDY, vgg16, grams, m),
            _flow_batch(rng, RECONET_CANDY), mesh, (10, 2, 0, 0, 0),
            lambda k: not _before_norm(k))
        del vgg16, grams
        cfg = dataclasses.replace(AdaAttNImageConfig(), dtype="bfloat16")
        vgg19 = init_vgg19_adaattn(0, device="cuda")
        res["adaattn_image_bf16"] = _dp_step(
            "AdaAttN image step 256² b8 bf16", lambda: create(
                init_stylizing_network(1, device="cuda"), cfg.lr),
            lambda m: make_adaattn_image_step(cfg, vgg19, m),
            _image_batch(rng, cfg.batch_size, cfg.crop_size), mesh,
            (0, 0, 6, 3, 3), lambda k: k.startswith("decoder."))
        del vgg19
        for key in ("reconet_flow_f32", "adaattn_image_bf16"):
            total = [t + n for t, n in zip(total, res[key]["launches"])]

        apply_precision(torch.bfloat16)
        vgg, net = _ada_models(0, 1, torch.bfloat16)
        clip = list(rng.integers(0, 256, (ADA_CLIP, *ADA_FRAMES, 3))
                    .astype(np.uint8))
        ref = list(AdaAttNVideoStylizer(vgg, net, clip[0][None], "softmax",
                                        batch_size=4).stylize_frames(
                                            iter(clip)))
        reset_counts()
        ours = list(AdaAttNVideoStylizer(
            vgg, net, clip[0][None], "softmax", batch_size=4,
            mesh=mesh).stylize_frames(iter(clip)))
        n_video = counts()
        if n_video != (0, 0, 3 * ADA_CLIP // 4, 0, 0):
            raise AssertionError(f"AdaAttNVideoStylizer(mesh=): launches "
                                 f"{n_video}")
        res["adaattn_video_max_diff"] = _frames_match(
            "AdaAttNVideoStylizer(mesh=) softmax 512×256 b4 against "
            "mesh=None", ours, ref)
        total = [t + n for t, n in zip(total, n_video)]

        g = torch.Generator(device="cuda").manual_seed(34)
        res["ring_err_bf16"], res["ring_bf16"] = _ring_fold(
            g, "bf16", torch.bfloat16, K3_BATCH, K3_LEVELS, 2 * BF16_ULP)
        res["ring_err_f32"], res["ring_f32"] = _ring_fold(
            g, "f32", torch.float32, TRAIN_BATCH, TRAIN_LEVELS, 1e-4)
        res["ring_bwd_err_bf16"], res["ring_bwd_bf16"] = _ring_backward(
            g, "bf16", torch.bfloat16, K3_BATCH, K3_LEVELS, 4 * BF16_ULP)
        res["ring_bwd_err_f32"], res["ring_bwd_f32"] = _ring_backward(
            g, "f32", torch.float32, TRAIN_BATCH, TRAIN_LEVELS, 1e-4)
        n_sharded = _world1_moment_grads(g, mesh)
        n_stylizer, res["stylizer_grads"] = _stylizer_param_grads(mesh)
        total = [t + a + b for t, a, b in zip(total, n_sharded, n_stylizer)]
        res["trace"] = _profile_names(
            os.path.join(ROOT, "build", "chip_smoke_trace"))
        log("  [8] spatial: H-sharded serving at world 1, a 2160×3840 frame")
        res["spatial_launches"], res["spatial"] = _spatial_serving(
            make_mesh(None, ("space",)))
        log("  [8] data × space: every step builder on a world-1 "
            "(data, space) mesh")
        res["space_train_launches"], res["space_train"] = _spatial_training(
            make_mesh(1, ("data", "space")))
    finally:
        multihost.shutdown()
    res["wall_s"] = time.perf_counter() - t_phase
    launches = dict(zip(("K1", "K2", "K3", "K4", "K5"), total))
    log(f"  [8] launches over the phase's main-path runs: {launches} (the "
        f"spatial part's apart: {res['spatial_launches']}; the data × space "
        f"part's: {res['space_train_launches']}); wall "
        f"{res['wall_s']:.1f} s")
    log(json.dumps({"scale_out": res}))
    return launches, res


def phase_scale_out_alone():
    """``--scale-out``: the kernels' build ([2]), [3]'s spatial cases and
    its K4/K5 at the ring backward's hop shapes, and [8]."""
    log(f"  build: {_build.build_all():.2f} s")
    g = torch.Generator(device="cuda").manual_seed(0)
    phase_kernels_spatial(g)
    phase_kernels_ring(g)
    phase_scale_out()


def phase_spatial_alone():
    """``--spatial``: the kernels' build ([2]), [3]'s spatial cases and
    the spatial and data × space parts of [8] in a world-1 NCCL group of
    their own."""
    from vst_tpu_torch.parallel import make_mesh, multihost

    log(f"  build: {_build.build_all():.2f} s")
    errs = phase_kernels_spatial(torch.Generator(device="cuda").manual_seed(0))
    log("[8] spatial: H-sharded serving at world 1, a 2160×3840 frame")
    multihost.initialize(f"127.0.0.1:{_free_port()}", 1, 0, device="cuda")
    try:
        launches, res = _spatial_serving(make_mesh(None, ("space",)))
        log("[8] data × space: every step builder on a world-1 (data, "
            "space) mesh")
        t_launches, t_res = _spatial_training(make_mesh(1, ("data",
                                                            "space")))
    finally:
        multihost.shutdown()
    log(json.dumps({"spatial": {"launches": launches, "errs": errs, **res},
                    "space_train": {"launches": t_launches, **t_res}}))


def phase_timing(launches, errs, slice_v):
    """Kernel, plain-version and cuDNN times at the main path's shapes, per
    forward: K1 five launches without and five with its prologue; K2 the
    stem and the head."""
    log("[6] timing at the main path's shapes (bf16)")
    g = torch.Generator(device="cuda").manual_seed(3)
    dt = torch.bfloat16
    apply_precision(dt)
    x, wt, b, gamma, beta = k1_inputs(g, dt)
    n, h, w, c = K1_SHAPE
    y, s = res_block.conv3x3_in_stats(x, wt, b)
    t = {
        "k": event_ms(lambda: res_block.conv3x3_in_stats(x, wt, b)),
        "k_pro": event_ms(lambda: res_block.conv3x3_in_stats(
            y, wt, b, s, gamma, beta)),
        "p": event_ms(lambda: res_block.conv3x3_in_stats_plain(x, wt, b)),
        "p_pro": event_ms(lambda: res_block.conv3x3_in_stats_plain(
            y, wt, b, s, gamma, beta)),
    }
    xp = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
    t["lib"], layout, both = cudnn_ms(xp, wt.permute(3, 2, 0, 1), b)
    del xp
    log(f"  K1 ms: kernel {t['k']:.4f}, with prologue {t['k_pro']:.4f}; "
        f"plain {t['p']:.4f} / {t['p_pro']:.4f}; cuDNN conv {t['lib']:.4f} "
        f"(benchmark mode, {layout}; NCHW {both['NCHW']:.4f}, channels_last "
        f"{both['channels_last']:.4f})")
    flops = 2 * 9 * c * c * n * h * w
    nbytes_k1 = (2 * n * h * w * c * 2 + 9 * c * c * 2 + c * 2
                 + n * 2 * c * 4)
    b1, _ = bound(flops, nbytes_k1, dt)
    b1_pro, by1 = bound(flops, nbytes_k1 + n * 2 * c * 4 + 2 * c * 4, dt)
    k1 = {"name": "K1 conv3x3_in_stats", "route": "cuda",
          "source": "vst_tpu_torch/kernels/csrc/res_block.cu",
          "replaces": "vst_tpu/kernels/res_block.py:38",
          "launches": launches["K1"], "max_abs_err": errs["K1"],
          "max_abs_err_f32": errs["K1 f32"],
          "launches_by_path": launches["K1 by path"],
          "ms": 5 * (t["k"] + t["k_pro"]),
          "plain_ms": 5 * (t["p"] + t["p_pro"]),
          "bound_ms": 5 * (b1 + b1_pro), "bound_by": by1,
          "library_ms": 10 * t["lib"],
          "library": f"F.conv2d bf16 (cuDNN, benchmark mode, {layout}; "
                     f"NCHW {both['NCHW']:.4f}, channels_last "
                     f"{both['channels_last']:.4f} ms)",
          "per": "one 512x512 batch-8 bf16 forward: 5 launches without and "
                 "5 with the prologue at (8,128,128,192)->192",
          "ms_per_launch": [t["k"], t["k_pro"]],
          "tflops_per_launch": [flops / t["k"] / 1e9,
                                flops / t["k_pro"] / 1e9],
          "bound_share_per_launch": [b1 / t["k"], b1_pro / t["k_pro"]],
          "library_ms_per_launch": t["lib"]}
    log(f"  K1 per launch: {flops / t['k'] / 1e9:.1f} / "
        f"{flops / t['k_pro'] / 1e9:.1f} TFLOP/s (without / with prologue), "
        f"bound {b1:.4f} / {b1_pro:.4f} ms ({by1}) = "
        f"{b1 / t['k']:.3f} / {b1_pro / t['k_pro']:.3f} of the kernel's time")

    k2 = {"name": "K2 conv3x3_valid", "route": "cuda",
          "source": "vst_tpu_torch/kernels/csrc/head_conv.cu",
          "replaces": "vst_tpu/kernels/head_conv.py:33",
          "launches": launches["K2"], "max_abs_err": errs["K2"],
          "max_abs_err_f32": errs["K2 f32"],
          "launches_by_path": launches["K2 by path"],
          "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
          "library_ms": 0.0,
          "per": "one 512x512 batch-8 bf16 forward: the packed stem "
                 "(8,130,130,48)->768 and head (8,130,130,768)->48",
          "ms_per_launch": [], "tflops_per_launch": [],
          "bound_share_per_launch": [], "library_ms_per_launch": [],
          "library": []}
    by2 = set()
    for part, (c2, co) in K2_SHAPES.items():
        xk, wk = k2_inputs(g, (8, 130, 130, c2, co), dt)
        tk = event_ms(lambda: head_conv.conv3x3_valid(xk, wk))
        tp = event_ms(lambda: head_conv.conv3x3_valid_plain(xk, wk))
        tl, layout, both = cudnn_ms(xk.permute(0, 3, 1, 2),
                                    wk.permute(3, 2, 0, 1))
        flops2 = 2 * 9 * c2 * co * 8 * 128 * 128
        bb, by = bound(flops2, (8 * 130 * 130 * c2 + 9 * c2 * co
                                + 8 * 128 * 128 * co) * 2, dt)
        log(f"  K2 {part} ms: kernel {tk:.4f} ({flops2 / tk / 1e9:.1f} "
            f"TFLOP/s, bound share {bb / tk:.3f}), plain {tp:.4f}, cuDNN conv "
            f"{tl:.4f} (benchmark mode, {layout}; NCHW {both['NCHW']:.4f}, "
            f"channels_last {both['channels_last']:.4f}), bound {bb:.4f} "
            f"({by})")
        k2["library"].append(f"{part}: F.conv2d bf16 (cuDNN, benchmark "
                             f"mode, {layout})")
        k2["tflops_per_launch"].append(flops2 / tk / 1e9)
        k2["bound_share_per_launch"].append(bb / tk)
        k2["library_ms_per_launch"].append(tl)
        k2["ms"] += tk
        k2["plain_ms"] += tp
        k2["library_ms"] += tl
        k2["bound_ms"] += bb
        k2["ms_per_launch"].append(tk)
        by2.add(by)
    k2["bound_by"] = "operations" if "operations" in by2 else "bytes"
    timing_f32_convs(g, k1, k2)
    torch.cuda.synchronize()
    return [k1, k2, timing_k3(launches["K3"], errs["K3"], slice_v)]


def cudnn_ms(x_nchw, w_oihw, b=None):
    """The fair library yardstick of a K1/K2 launch, in the inputs' dtype
    (bf16, or f32 with TF32 off): cuDNN's ``F.conv2d`` with
    ``torch.backends.cudnn.benchmark`` set only around this timing, in the
    NCHW and the channels_last layout; returns (the faster's ms, its
    layout, both ms)."""
    was = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        ms = {}
        for layout, fmt in (("NCHW", torch.contiguous_format),
                            ("channels_last", torch.channels_last)):
            xl = x_nchw.contiguous(memory_format=fmt)
            wl = w_oihw.contiguous(memory_format=fmt)
            ms[layout] = event_ms(lambda: F.conv2d(xl, wl, b), 5, 2)
            del xl, wl
    finally:
        torch.backends.cudnn.benchmark = was
    best = min(ms, key=ms.get)
    return ms[best], best, ms


def timing_f32_convs(g, k1, k2):
    """f32 K1 (without and with its prologue) and f32 K2 (packed stem and
    head), both 3xTF32 on wgmma, at the bf16 rows' 512² batch-8 shapes
    (the f32 ReCoNet forward of [4] and [5] runs both bodies), beside
    cuDNN's f32 conv in benchmark mode in the faster of NCHW and
    channels_last (``cudnn_ms``), per forward as the bf16 rows; event
    time over 5 launches after 1.  Bound in the f32 K3-K5 columns'
    convention: FLOPs over 3xTF32's 495 / 3 TFLOP/s, bytes (float32) over
    3.35 TB/s.  Added to the rows as ``ms_f32``, ``bound_ms_f32``,
    ``library_ms_f32`` (with TFLOP/s and the layout)."""
    dt = torch.float32
    apply_precision(dt)
    x, wt, b, gamma, beta = k1_inputs(g, dt)
    n, h, w, c = K1_SHAPE
    y, s = res_block.conv3x3_in_stats(x, wt, b)
    tk = event_ms(lambda: res_block.conv3x3_in_stats(x, wt, b), 5, 1)
    tk_pro = event_ms(lambda: res_block.conv3x3_in_stats(
        y, wt, b, s, gamma, beta), 5, 1)
    tp = event_ms(lambda: res_block.conv3x3_in_stats_plain(x, wt, b), 5, 1)
    tp_pro = event_ms(lambda: res_block.conv3x3_in_stats_plain(
        y, wt, b, s, gamma, beta), 5, 1)
    xp = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
    tl, layout, both = cudnn_ms(xp, wt.permute(3, 2, 0, 1), b)
    del xp
    flops = 2 * 9 * c * c * n * h * w
    nbytes = (2 * n * h * w * c + 9 * c * c + c + n * 2 * c) * 4
    b1, _ = bound(flops, nbytes, "tf32x3")
    b1_pro, _ = bound(flops, nbytes + (n * 2 * c + 2 * c) * 4, "tf32x3")
    k1.update(ms_f32=5 * (tk + tk_pro), bound_ms_f32=5 * (b1 + b1_pro),
              plain_ms_f32=5 * (tp + tp_pro),
              library_ms_f32=10 * tl, ms_f32_per_launch=[tk, tk_pro],
              tflops_f32_per_launch=[flops / tk / 1e9, flops / tk_pro / 1e9],
              bound_share_f32_per_launch=[b1 / tk, b1_pro / tk_pro],
              library_ms_f32_per_launch=tl,
              library_tflops_f32=flops / tl / 1e9,
              library_f32=f"F.conv2d f32 (cuDNN, TF32 off, benchmark mode, "
                          f"{layout}; NCHW {both['NCHW']:.4f}, channels_last "
                          f"{both['channels_last']:.4f} ms)")
    log(f"  K1 f32 ms per launch: kernel {tk:.4f}, with prologue "
        f"{tk_pro:.4f} ({flops / tk / 1e9:.1f} / {flops / tk_pro / 1e9:.1f} "
        f"TFLOP/s; bound share {b1 / tk:.3f} / {b1_pro / tk_pro:.3f}); plain "
        f"{tp:.4f} / {tp_pro:.4f}; cuDNN "
        f"f32 conv {tl:.4f} ({flops / tl / 1e9:.1f} TFLOP/s, {layout}; NCHW "
        f"{both['NCHW']:.4f}, channels_last {both['channels_last']:.4f}); "
        f"bound {b1:.4f} / {b1_pro:.4f}")
    k2.update(ms_f32=0.0, bound_ms_f32=0.0, library_ms_f32=0.0,
              plain_ms_f32=0.0,
              ms_f32_per_launch=[], tflops_f32_per_launch=[],
              bound_share_f32_per_launch=[], library_ms_f32_per_launch=[],
              library_f32=[])
    for part, (c2, co) in K2_SHAPES.items():
        xk, wk = k2_inputs(g, (8, 130, 130, c2, co), dt)
        tk = event_ms(lambda: head_conv.conv3x3_valid(xk, wk), 5, 1)
        tp = event_ms(lambda: head_conv.conv3x3_valid_plain(xk, wk), 5, 1)
        tl, layout, both = cudnn_ms(xk.permute(0, 3, 1, 2),
                                        wk.permute(3, 2, 0, 1))
        flops2 = 2 * 9 * c2 * co * 8 * 128 * 128
        bb, _ = bound(flops2, (8 * 130 * 130 * c2 + 9 * c2 * co
                               + 8 * 128 * 128 * co) * 4, "tf32x3")
        log(f"  K2 f32 {part} ms: kernel {tk:.4f} ({flops2 / tk / 1e9:.1f} "
            f"TFLOP/s, bound share {bb / tk:.3f}), plain {tp:.4f}, cuDNN "
            f"f32 conv {tl:.4f} "
            f"({flops2 / tl / 1e9:.1f} TFLOP/s, {layout}; NCHW "
            f"{both['NCHW']:.4f}, channels_last {both['channels_last']:.4f}), "
            f"bound {bb:.4f}")
        k2["ms_f32"] += tk
        k2["library_ms_f32"] += tl
        k2["plain_ms_f32"] += tp
        k2["bound_ms_f32"] += bb
        k2["ms_f32_per_launch"].append(tk)
        k2["tflops_f32_per_launch"].append(flops2 / tk / 1e9)
        k2["bound_share_f32_per_launch"].append(bb / tk)
        k2["library_ms_f32_per_launch"].append(tl)
        k2["library_f32"].append(
            f"{part}: F.conv2d f32 (cuDNN, TF32 off, benchmark mode, {layout})")
        del xk, wk
    apply_precision(torch.bfloat16)


def timing_k3(launches, err, slice_v):
    """K3, its plain version and one PyTorch call of the same function,
    ``F.scaled_dot_product_attention(q, k, [V, V∘V], scale=1)`` (M1‖M2; a
    yardstick the port never calls), at the three AdaAttN 512² batch-2
    levels, bf16; one launch per level per forward, with the executed-work
    factor of each level (logged; ``slice_v`` is the library's value slice
    width: S is computed once per slice), TFLOP/s on the least work and
    the bound's share of the kernel's time.  Bound: FLOPs 2·b·n·m·(d + 2c)
    on the tensor cores; bytes q, k, v read once, M1, M2, L written
    once."""
    log("[6] K3 at the AdaAttN 512² b2 level shapes (bf16)")
    g = torch.Generator(device="cuda").manual_seed(4)
    dt = torch.bfloat16
    apply_precision(dt)
    k3 = {"name": "K3 softmax_attention_moments", "route": "cuda",
          "source": "vst_tpu_torch/kernels/csrc/adaattn_fwd.cu",
          "replaces": "vst_tpu/kernels/adaattn_attention.py:48",
          "launches": launches, "max_abs_err": err,
          "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
          "bound_by": "operations",
          "per": "one AdaAttN 512x512 batch-2 bf16 softmax forward: "
                 "(n=m, d, c) = (16384, 448, 256), (4096, 960, 512), "
                 "(1024, 1472, 512)",
          "ms_per_launch": [], "tflops_per_launch": [],
          "bound_share_per_launch": [], "library_ms_per_launch": [],
          "library": "F.scaled_dot_product_attention"}
    for n, d, c in K3_LEVELS:
        q, k, v = k3_inputs(g, K3_BATCH, n, n, d, c, dt)
        vv = torch.cat([v, v * v], dim=-1)
        tk = event_ms(lambda: adaattn_attention.softmax_attention_moments(
            q, k, v))
        tp = event_ms(lambda: adaattn_attention.softmax_attention_moments_plain(
            q, k, v), reps=3, warmup=1)
        tl = event_ms(lambda: F.scaled_dot_product_attention(
            q, k, vv, scale=1.0), reps=3, warmup=1)
        flops = 2 * K3_BATCH * n * n * (d + 2 * c)
        nbytes = K3_BATCH * (2 * (2 * n * d + n * c + 2 * n * c) + 4 * n)
        bb, by = bound(flops, nbytes, dt)
        work = (-(-c // slice_v) * d + 2 * c) / (d + 2 * c)
        log(f"  K3 (n={n}, d={d}, c={c}) ms: kernel {tk:.4f} "
            f"({flops / tk / 1e9:.1f} TFLOP/s on the least work, executed "
            f"{work:.3f}x it, bound share {bb / tk:.3f}), plain {tp:.4f}, "
            f"{k3['library']} {tl:.4f}, bound {bb:.4f} ({by})")
        k3["ms"] += tk
        k3["plain_ms"] += tp
        k3["library_ms"] += tl
        k3["bound_ms"] += bb
        k3["ms_per_launch"].append(tk)
        k3["tflops_per_launch"].append(flops / tk / 1e9)
        k3["bound_share_per_launch"].append(bb / tk)
        k3["library_ms_per_launch"].append(tl)
        if by == "bytes":
            k3["bound_by"] = "bytes"
        del q, k, v, vv
    log(f"  K3 per bf16 forward: {k3['ms']:.4f} ms against SDPA's "
        f"{k3['library_ms']:.4f} ms")
    torch.cuda.synchronize()
    return k3


def _sdpa_backend(fn):
    """The family of the device kernel that takes most of ``fn``'s time
    (flash, efficient, cudnn, or math for plain matmuls): which backend
    ``F.scaled_dot_product_attention`` chose."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = " ".join(e.key.lower() for e in prof.key_averages()
                     if str(e.device_type).endswith("CUDA"))
    for family in ("flash", "efficient", "cudnn"):
        if family in names:
            return family
    return "math"


def executed_work(kid, d, c, slice_dq, slice_dv):
    """The multiply-adds bf16 K4 or K5 runs as a multiple of the least
    (4nm(d + c), 4nmd + 8nmc): each of the s dQ/dK output slices computes
    S (2nmd) and dA (4nmc), each of the r dV slices S; the slice widths
    are the built library's (``vst_k45_launch_config``).  The f32 K4 and
    K5 run the same tiling with their own slice widths, each product as
    three tf32 ones."""
    s, r = -(-d // slice_dq), -(-c // slice_dv)
    if kid == "K4":
        return (s * (2 * d + 4 * c) + 2 * d) / (4 * d + 4 * c)
    return (s * (2 * d + 4 * c) + 2 * d + r * 2 * d + 4 * c) / (4 * d + 8 * c)


def timing_k45(launches, errs, slices):
    """K4, K5 and their plain versions at the three AdaAttN training level
    shapes (256², batch 8), bf16, one launch each per level per step, with
    the executed-work factor of each level (logged; ``slices`` are the
    library's output slice widths), TFLOP/s on the least work and the
    bound's share of the kernel's time.  Library yardstick (never
    called by the port): the backward of ``F.scaled_dot_product_attention(
    q, k, [V, V∘V], scale=1)`` by ``torch.autograd.grad``, which returns
    dQ, dK and dV together; it is put beside both kernels.  Bounds: FLOPs
    4nm(d + c) (K4) and 4nmd + 8nmc (K5) per image on the tensor cores;
    bytes q, k, v, dM1, dM2 (bf16) and L, D (f32) read once, the outputs
    written once.  Also f32 K3, K4 and K5 per level (the f32 image step,
    the config default, runs them there; event time over 5 launches after
    1), beside ``F.scaled_dot_product_attention`` in f32 with TF32 off:
    its forward beside K3, its backward beside K4 + K5, each with the
    backend it chose.  f32 bounds: FLOPs over 3xTF32's 495 / 3 TFLOP/s
    (the route of all three), bytes in float32.  The f32 executed-work
    factors per level come from the built library's slice widths
    (``slices`` "K3_f32", "K4_f32", "K5_f32").  The f32 K3 numbers
    are returned; K4/K5's go in their rows as ``ms_f32``, ``bound_ms_f32``,
    ``plain_ms_f32``, ``library_ms_f32``, ``executed_work_f32`` (as K3's:
    products run per product of the least work, each of them three tf32
    ones) and ``tflops_f32_per_launch`` (on the least work)."""
    log("[6] K4, K5 at the AdaAttN training level shapes (256² b8, bf16)")
    g = torch.Generator(device="cuda").manual_seed(5)
    dt = torch.bfloat16
    apply_precision(dt)
    rows = {}
    for kid, name, fn, plain, line, per_image in (
            ("K4", "softmax_attention_dq", adaattn_attention.softmax_attention_dq,
             adaattn_attention.softmax_attention_dq_plain, 151,
             lambda n, d, c: 4 * n * n * (d + c)),
            ("K5", "softmax_attention_dkv", adaattn_attention.softmax_attention_dkv,
             adaattn_attention.softmax_attention_dkv_plain, 182,
             lambda n, d, c: 4 * n * n * d + 8 * n * n * c)):
        rows[kid] = dict(fn=fn, plain=plain, flops=per_image, row={
            "name": f"{kid} {name}", "route": "cuda",
            "source": "vst_tpu_torch/kernels/csrc/adaattn_bwd.cu",
            "replaces": f"vst_tpu/kernels/adaattn_attention.py:{line}",
            "launches": launches[kid], "max_abs_err": errs[kid],
            "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
            "bound_by": "operations",
            "per": "one AdaAttN 256x256 batch-8 bf16 image train step: "
                   "(n=m, d, c) = (4096, 448, 256), (1024, 960, 512), "
                   "(256, 1472, 512)",
            "ms_per_launch": [], "tflops_per_launch": [],
            "bound_share_per_launch": [], "ms_f32": 0.0,
            "ms_f32_per_launch": [], "bound_ms_f32": 0.0,
            "library_ms_f32": 0.0, "library_f32": None, "library": None,
            "max_abs_err_f32": errs[f"{kid} f32"], "executed_work_f32": [],
            "tflops_f32_per_launch": []})
    k3_f32 = {"ms": [], "bound_ms": 0.0, "library_ms": 0.0, "library": None,
              "work": [], "tflops": [], "plain_ms": 0.0}
    for n, d, c in TRAIN_LEVELS:
        args = k45_inputs(g, TRAIN_BATCH, n, n, d, c, dt)
        q, k, v, lse, dd, dm1, dm2 = args
        vv = torch.cat([v, v * v], dim=-1)
        leaves = [x.detach().requires_grad_() for x in (q, k, vv)]
        out = F.scaled_dot_product_attention(*leaves, scale=1.0)
        go = torch.cat([dm1, dm2], dim=-1)

        def lib():
            return torch.autograd.grad(out, leaves, go, retain_graph=True)

        tl = event_ms(lib, reps=3, warmup=1)
        backend = _sdpa_backend(lib)
        for kid, r in rows.items():
            row = r["row"]
            tk = event_ms(lambda: r["fn"](*args))
            tp = event_ms(lambda: r["plain"](*args), reps=3, warmup=1)
            out_elems = n * d if kid == "K4" else n * (d + c)
            nbytes = TRAIN_BATCH * (2 * (2 * n * d + n * c + 2 * n * c)
                                    + 8 * n + 2 * out_elems)
            flops = TRAIN_BATCH * r["flops"](n, d, c)
            bb, by = bound(flops, nbytes, dt)
            work = executed_work(kid, d, c, *slices["K45"])
            log(f"  {kid} (n={n}, d={d}, c={c}) ms: kernel {tk:.4f} "
                f"({flops / tk / 1e9:.1f} TFLOP/s on the least work, "
                f"executed {work:.3f}x it, bound share {bb / tk:.3f}), plain "
                f"{tp:.4f}, SDPA backward ({backend}) {tl:.4f}, bound "
                f"{bb:.4f} ({by})")
            row["ms"] += tk
            row["plain_ms"] += tp
            row["library_ms"] += tl
            row["bound_ms"] += bb
            row["ms_per_launch"].append(tk)
            row["tflops_per_launch"].append(flops / tk / 1e9)
            row["bound_share_per_launch"].append(bb / tk)
            row["library"] = (f"backward of F.scaled_dot_product_attention "
                              f"({backend}), dQ, dK, dV together")
            if bb >= r.get("top", 0.0):   # what bounds the largest level
                r["top"], row["bound_by"] = bb, by
        del vv, leaves, out, go
        # f32 on the same values: K3, K4, K5 and SDPA in f32, TF32 off
        apply_precision(torch.float32)
        a32 = [x.float() for x in args]
        k3_f32["ms"].append(event_ms(
            lambda: adaattn_attention.softmax_attention_moments(*a32[:3]),
            reps=5, warmup=1))
        k3_f32["plain_ms"] += event_ms(
            lambda: adaattn_attention.softmax_attention_moments_plain(
                *a32[:3]), reps=3, warmup=1)
        q, k, v, lse, dd, dm1, dm2 = a32
        vv = torch.cat([v, v * v], dim=-1)
        fwd = lambda: F.scaled_dot_product_attention(q, k, vv, scale=1.0)
        t_fwd = event_ms(fwd, reps=3, warmup=1)
        leaves = [x.detach().requires_grad_() for x in (q, k, vv)]
        out = F.scaled_dot_product_attention(*leaves, scale=1.0)
        go = torch.cat([dm1, dm2], dim=-1)

        def lib32():
            return torch.autograd.grad(out, leaves, go, retain_graph=True)

        t_bwd = event_ms(lib32, reps=3, warmup=1)
        be_fwd, be_bwd = _sdpa_backend(fwd), _sdpa_backend(lib32)
        nb = lambda out_elems: TRAIN_BATCH * (4 * (2 * n * d + n * c + 2 * n * c)
                                              + 8 * n + 4 * out_elems)
        b3, _ = bound(2 * TRAIN_BATCH * n * n * (d + 2 * c),
                      TRAIN_BATCH * 4 * (2 * n * d + 3 * n * c + n), "tf32x3")
        k3_f32["bound_ms"] += b3
        k3_f32["work"].append((-(-c // slices["K3_f32"]) * d + 2 * c)
                              / (d + 2 * c))
        k3_f32["tflops"].append(2 * TRAIN_BATCH * n * n * (d + 2 * c)
                                / k3_f32["ms"][-1] / 1e9)
        k3_f32["library_ms"] += t_fwd
        k3_f32["library"] = f"F.scaled_dot_product_attention f32 ({be_fwd})"
        msg = []
        for kid, r in rows.items():
            row = r["row"]
            t32 = event_ms(lambda: r["fn"](*a32), reps=5, warmup=1)
            row["plain_ms_f32"] = row.get("plain_ms_f32", 0.0) + event_ms(
                lambda: r["plain"](*a32), reps=3, warmup=1)
            flops = TRAIN_BATCH * r["flops"](n, d, c)
            b32, _ = bound(flops, nb(n * d if kid == "K4" else n * (d + c)),
                           "tf32x3")
            work = executed_work(kid, d, c, *slices[f"{kid}_f32"])
            row["ms_f32"] += t32
            row["ms_f32_per_launch"].append(t32)
            row["bound_ms_f32"] += b32
            row["library_ms_f32"] += t_bwd
            row["library_f32"] = (f"backward of F.scaled_dot_product_attention"
                                  f" f32 ({be_bwd}), dQ, dK, dV together")
            row["executed_work_f32"].append(work)
            row["tflops_f32_per_launch"].append(flops / t32 / 1e9)
            msg.append(f"{kid} {t32:.4f} (3xTF32 {3 * work:.3f}x the least work "
                       f"in tf32 products, {flops / t32 / 1e9:.1f} TFLOP/s on "
                       f"the least, bound {b32:.4f}, share {b32 / t32:.3f})")
        log(f"  f32 (n={n}, d={d}, c={c}) ms per launch: K3 "
            f"{k3_f32['ms'][-1]:.4f} (3xTF32 {3 * k3_f32['work'][-1]:.3f}x "
            f"the least work in tf32 products, {k3_f32['tflops'][-1]:.1f} "
            f"TFLOP/s on the least; bound {b3:.4f}), {', '.join(msg)}; SDPA "
            f"f32 forward ({be_fwd}) {t_fwd:.4f}, backward ({be_bwd}) "
            f"{t_bwd:.4f}")
        apply_precision(dt)
        del args, a32, q, k, v, lse, dd, dm1, dm2, vv, leaves, out, go
    k4, k5 = rows["K4"]["row"], rows["K5"]["row"]
    log(f"  K4 + K5 per bf16 step: {k4['ms'] + k5['ms']:.4f} ms against the "
        f"SDPA backward's {k4['library_ms']:.4f} ms")
    log(f"  per f32 step: K3 {sum(k3_f32['ms']):.4f} ms (6 launches: "
        f"{2 * sum(k3_f32['ms']):.4f}) against the f32 SDPA forward's "
        f"{k3_f32['library_ms']:.4f} (bound {k3_f32['bound_ms']:.4f}); K4 + K5 "
        f"{k4['ms_f32'] + k5['ms_f32']:.4f} ms (K4 {k4['ms_f32']:.4f}, bound "
        f"{k4['bound_ms_f32']:.4f}; K5 {k5['ms_f32']:.4f}, bound "
        f"{k5['bound_ms_f32']:.4f}) against the f32 SDPA backward's "
        f"{k4['library_ms_f32']:.4f}; plain versions in f32: K3 "
        f"{k3_f32['plain_ms']:.4f}, K4 {k4['plain_ms_f32']:.4f}, K5 "
        f"{k5['plain_ms_f32']:.4f}")
    torch.cuda.synchronize()
    return [k4, k5], k3_f32


def _profile(label, forward, top=14, share=None):
    """Device time by operator over two forwards (torch.profiler), and the
    device's busy share of the window's wall time; the ``top`` rows.
    ``share`` = (label, substrings): also the share of the device time in
    the rows whose name holds one of the substrings."""
    from torch.profiler import ProfilerActivity, profile

    forward()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            forward()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # device-side rows only (kernels and copies): CPU operators also carry
    # the device time of what they launch, which would count it twice, and
    # so do the package's profiler ranges ("vst::…") on the device side
    rows = sorted((e for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA")
                   and not e.key.startswith("vst::")),
                  key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in rows) / 1e3
    per_forward = sum(e.count for e in rows) // 2
    log(f"  {label}: window {wall_ms:.3f} ms wall, {busy_ms:.3f} ms device "
        f"time → busy {100 * busy_ms / wall_ms:.1f}%; {per_forward} device "
        f"kernels and copies per forward")
    for e in rows[:top]:
        if dev_us(e) <= 0:
            break
        log(f"  {dev_us(e) / 2e3:9.3f} ms/forward  x{e.count // 2:<4d} "
            f"{e.key[:90]}")
    if share is not None:
        part = [e for e in rows if any(k in e.key for k in share[1])]
        ms = sum(dev_us(e) for e in part) / 2e3
        log(f"  {share[0]}: {ms:.4f} ms/forward in "
            f"{sum(e.count for e in part) // 2} launches, "
            f"{100 * ms / (busy_ms / 2):.1f}% of the device time")


def phase_profile():
    """Where the time of one forward (one step) of each main path goes."""
    log("[7] profile: 2 forwards (steps) each")
    dt = torch.bfloat16
    model = init_reconet(0, device="cuda", dtype=dt)
    rng = np.random.default_rng(4)
    x = rng.integers(0, 256, (8, 512, 512, 3)).astype(np.uint8)
    _profile("ReCoNet 512² b8 bf16",
             lambda: stylize_reconet(model, x, uint8_out=True))
    apply_precision(torch.float32)
    model32 = init_reconet(0, device="cuda")
    _profile("ReCoNet 512² b8 f32",
             lambda: stylize_reconet(model32, x, uint8_out=True))
    del model32
    vgg, net = _ada_models(0, 1, dt)
    c, s = (rng.integers(0, 256, (K3_BATCH, ADA_SIZE, ADA_SIZE, 3))
            .astype(np.uint8) for _ in range(2))
    _profile("AdaAttN 512² b2 bf16 softmax",
             lambda: stylize_adaattn(vgg, net, c, s))
    cfg = dataclasses.replace(AdaAttNImageConfig(), dtype="bfloat16")
    state = create(init_stylizing_network(1, device="cuda"), cfg.lr)
    step = make_adaattn_image_step(cfg, init_vgg19_adaattn(0, device="cuda"))
    batch = _image_batch(rng, cfg.batch_size, cfg.crop_size)
    _profile("AdaAttN train 256² b8 bf16 image step",
             lambda: step(state, batch))
    del state, step, batch
    _profile_flow_step(rng)
    _profile_rtnstv_forward(rng)
    _profile_rtnstv_step(rng)


def _profile_flow_step(rng):
    """Device time by kernel of the f32 flow step (RECONET_CANDY): K1/K2's
    forwards beside their library backwards and the rest."""
    apply_precision(torch.float32)
    cfg = RECONET_CANDY
    vgg = init_vgg16_reconet(0, device="cuda")
    state = create(init_reconet(1, device="cuda"), cfg.lr)
    step = make_reconet_flow_step(cfg, vgg, _style_grams(vgg, cfg, rng))
    batch = _flow_batch(rng, cfg)
    _profile("ReCoNet train 360×640 b2 f32 flow step",
             lambda: step(state, batch), top=24)


def phase_f32_step():
    """``--f32-step``: f32 K3, K4 and K5 per launch at the three training
    levels (256² b8; event time over 5 launches after 1), then the f32
    image step at the config's settings (2 warmup and 8 timed steps, the
    checks of [5]) and its device time by kernel over two steps."""
    log("[f32] AdaAttN image step 256² b8 float32, broken down")
    log(f"  build: {_build.build_all():.2f} s")
    g = torch.Generator(device="cuda").manual_seed(5)
    apply_precision(torch.float32)
    att = adaattn_attention
    for n, d, c in TRAIN_LEVELS:
        args = k45_inputs(g, TRAIN_BATCH, n, n, d, c, torch.float32)
        ms = [event_ms(lambda: fn(*a), reps=5, warmup=1) for fn, a in (
            (att.softmax_attention_moments, args[:3]),
            (att.softmax_attention_dq, args), (att.softmax_attention_dkv, args))]
        log(f"  f32 (n={n}, d={d}, c={c}) ms per launch: K3 {ms[0]:.4f}, K4 "
            f"{ms[1]:.4f}, K5 {ms[2]:.4f}")
        del args
    rng = np.random.default_rng(8)
    cfg = AdaAttNImageConfig()
    batch = _image_batch(rng, cfg.batch_size, cfg.crop_size)
    _train_run("image float32", cfg, make_adaattn_image_step, batch, 8, 2,
               (6, 3, 3))
    state = create(init_stylizing_network(1, device="cuda"), cfg.lr)
    step = make_adaattn_image_step(cfg, init_vgg19_adaattn(0, device="cuda"))
    _profile("AdaAttN train 256² b8 f32 image step",
             lambda: step(state, batch), top=24)


def phase_f32_reconet():
    """``--f32-reconet``: the f32 K1 (without and with its prologue) and K2
    (stem, head) per launch at the 512² b8 shapes (event time over 5
    launches after 1), the f32 batch of [5] (``reconet_f32_batch``, launch
    counts asserted) and its device time by kernel over two batches."""
    log("[f32] ReCoNet 512² b8 float32, broken down")
    log(f"  build: {_build.build_all():.2f} s")
    g = torch.Generator(device="cuda").manual_seed(6)
    dt = torch.float32
    apply_precision(dt)
    x, wt, b, gamma, beta = k1_inputs(g, dt)
    y, s = res_block.conv3x3_in_stats(x, wt, b)
    ms = [event_ms(lambda: res_block.conv3x3_in_stats(x, wt, b), 5, 1),
          event_ms(lambda: res_block.conv3x3_in_stats(y, wt, b, s, gamma,
                                                      beta), 5, 1)]
    del x, y
    for c, co in K2_SHAPES.values():
        xk, wk = k2_inputs(g, (8, 130, 130, c, co), dt)
        ms.append(event_ms(lambda: head_conv.conv3x3_valid(xk, wk), 5, 1))
        del xk, wk
    log(f"  f32 ms per launch: K1 {ms[0]:.4f}, with prologue {ms[1]:.4f}; K2 "
        f"stem {ms[2]:.4f}, head {ms[3]:.4f}; per forward K1 "
        f"{5 * (ms[0] + ms[1]):.4f}, K2 {ms[2] + ms[3]:.4f}")
    batch_ms, times, launches = reconet_f32_batch()
    log(f"  512² b8 f32 stylize_reconet: {batch_ms:.3f} ms/batch (median of "
        f"5) → {8e3 / batch_ms:.1f} frames/s; runs "
        f"{[round(t, 3) for t in times]}; launches K1-K5 {launches} over 6 "
        f"forwards")
    if launches != (60, 12, 0, 0, 0):
        raise AssertionError(f"launches {launches}")
    model = init_reconet(0, device="cuda")
    frames = np.random.default_rng(4).integers(0, 256, (8, 512, 512, 3)).astype(
        np.uint8)
    _profile("ReCoNet 512² b8 f32",
             lambda: stylize_reconet(model, frames, uint8_out=True))


def phase_reconet_train_alone():
    """``--reconet-train``: the kernels' build and [5c] alone, then the
    f32 flow step's device time by kernel."""
    log(f"  build: {_build.build_all():.2f} s")
    phase_main_reconet_train(torch.Generator(device="cuda").manual_seed(0))
    _profile_flow_step(np.random.default_rng(4))


def main(argv):
    if not torch.cuda.is_available():
        print("error: no CUDA device; chip_smoke.py runs only on a GPU",
              file=sys.stderr)
        return 1
    parent = argv[1] if len(argv) == 2 and argv[0] == "--parent" else None
    alone = {"--f32-step": phase_f32_step, "--f32-reconet": phase_f32_reconet,
             "--reconet-train": phase_reconet_train_alone,
             "--rtnstv": phase_rtnstv_alone, "--eval": phase_eval_alone,
             "--scale-out": phase_scale_out_alone,
             "--spatial": phase_spatial_alone}
    if not (argv == [] or (len(argv) == 1 and argv[0] in alone)
            or parent is not None):
        print(f"usage: chip_smoke.py [--f32-step | --f32-reconet | "
              f"--reconet-train | --rtnstv | --eval | --scale-out | "
              f"--spatial | --parent DIR]; got {argv}", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    smi = phase_card()
    if len(argv) == 1:
        alone[argv[0]]()
        log(f"wall {time.perf_counter() - t0:.1f} s")
        log(smi)
        return 0
    started = start_parent_build(parent) if parent else None
    slices = phase_build()
    g = torch.Generator(device="cuda").manual_seed(0)
    errs = phase_kernels(g)
    errs.update(phase_kernels_k3(g))
    errs.update(phase_kernels_k45(g, started and parent_k5(started)))
    errs.update(phase_kernels_spatial(g))
    errs.update(phase_kernels_ring(g))
    phase_model()
    bf16, f32 = phase_main_path(), phase_main_f32()
    launches = {k: bf16[k] + f32[k] for k in ("K1", "K2")}
    for k in ("K1", "K2"):
        launches[f"{k} by path"] = {"ReCoNet bf16": bf16[k],
                                    "ReCoNet f32": f32[k]}
    launches["K3"] = phase_main_adaattn()
    train, bare_ms = phase_main_train()
    loop = phase_main_loop(bare_ms)
    rtrain = phase_main_reconet_train(g)
    for k in ("K1", "K2"):
        launches[k] += rtrain[k]
        launches[f"{k} by path"]["ReCoNet training"] = rtrain[k]
    rt_serving, rt_train = phase_main_rtnstv(), phase_main_rtnstv_train()
    for path, n in (("RTNSTV bf16", rt_serving["bf16"]["K1"]),
                    ("RTNSTV f32", rt_serving["f32"]["K1"]),
                    ("RTNSTV training", rt_train["K1"])):
        launches["K1"] += n
        launches["K1 by path"][path] = n
    ev, ev_res = phase_eval()
    for k in ("K1", "K2"):
        launches[k] += ev[k]
        launches[f"{k} by path"]["evaluation"] = ev[k]
    so, so_res = phase_scale_out()
    sp, st = so_res["spatial_launches"], so_res["space_train_launches"]
    for k in ("K1", "K2"):
        launches[k] += so[k] + sp[k] + st[k]
        launches[f"{k} by path"]["scale-out"] = so[k]
        launches[f"{k} by path"]["spatial"] = sp[k]
        launches[f"{k} by path"]["data × space training"] = st[k]
    by_path = {"serving": launches["K3"], "training": train["K3"],
               "training loop": loop["K3"], "evaluation": ev["K3"],
               "scale-out": so["K3"], "spatial": sp["K3"],
               "data × space training": st["K3"]}
    launches["K3"] += (train["K3"] + loop["K3"] + ev["K3"] + so["K3"]
                       + sp["K3"] + st["K3"])
    launches.update(K4=train["K4"] + loop["K4"] + so["K4"] + st["K4"],
                    K5=train["K5"] + loop["K5"] + so["K5"] + st["K5"])
    k45_rows, k3_f32 = timing_k45(launches, errs, slices)
    kernels = phase_timing(launches, errs, slices["K3"]) + k45_rows
    kernels[2]["launches_by_path"] = by_path
    for row, k in ((kernels[3], "K4"), (kernels[4], "K5")):
        row["launches_by_path"] = {"training": train[k],
                                   "training loop": loop[k],
                                   "scale-out": so[k],
                                   "data × space training": st[k]}
    kernels[2]["scale_out"] = {
        "per": "[8]: the ring's fold of 4 key blocks through K3 against one "
               "K3 call, per level",
        "fold_bf16": so_res["ring_bf16"], "fold_f32": so_res["ring_f32"],
        "max_abs_err_fold_bf16": so_res["ring_err_bf16"],
        "max_abs_err_fold_f32": so_res["ring_err_f32"]}
    ring_bwd = {
        "per": "[8]: the ring's backward over 4 x 4 (query shard, key "
               "block) pairs through block_grads (16 K4 and 16 K5 "
               "launches a level) against one K4 + K5 call, per level",
        "ring_bwd_bf16": so_res["ring_bwd_bf16"],
        "ring_bwd_f32": so_res["ring_bwd_f32"],
        "max_abs_err_ring_bwd_bf16": so_res["ring_bwd_err_bf16"],
        "max_abs_err_ring_bwd_f32": so_res["ring_bwd_err_f32"],
        "max_abs_err_hop_shapes": errs["K4/K5 ring hop"],
        "max_abs_err_hop_shapes_f32": errs["K4/K5 ring hop f32"],
        "stylizer_grads_world1": so_res["stylizer_grads"]}
    kernels[3]["scale_out"] = kernels[4]["scale_out"] = ring_bwd
    kernels[2]["ms_f32"] = sum(k3_f32["ms"])
    kernels[2]["plain_ms_f32"] = k3_f32["plain_ms"]
    kernels[2]["ms_f32_per_launch"] = k3_f32["ms"]
    kernels[2]["bound_ms_f32"] = k3_f32["bound_ms"]
    kernels[2]["library_ms_f32"] = k3_f32["library_ms"]
    kernels[2]["library_f32"] = k3_f32["library"]
    kernels[2]["max_abs_err_f32"] = errs["K3 f32"]
    kernels[2]["executed_work_f32"] = k3_f32["work"]
    kernels[2]["tflops_f32_per_launch"] = k3_f32["tflops"]
    kernels[2]["ms_f32_per"] = ("one f32 launch at each AdaAttN training "
                                "level (256x256 batch 8)")
    times = rtrain["times"]
    for row, k in ((kernels[0], "K1"), (kernels[1], "K2")):
        row["train_forward_ms_per_step"] = times[f"{k} forward"]
        row["train_backward_ms_per_step"] = times[f"{k} backward"]
        row["train_backward"] = ("library: torch.nn.grad.conv2d_input / "
                                 "conv2d_weight in f32, TF32 off")
        row["train_per"] = ("one RECONET_CANDY flow step, 360x640 batch 2 "
                            "f32 (the frame pair as a batch of 4)")
        row["train_grad_err"] = {e: v for e, v in rtrain["errs"].items()
                                 if e.startswith(k)}
    kernels[0]["train_step_ms"] = rtrain["ms"]
    kernels[0]["evaluation"] = {
        "per": "[5e]: Sintel Et (RTNSTV f32, 17 frames 640x360) and "
               "temporal MSE (ReCoNet f32, 9 frames)",
        "sintel_et_ms_per_pair": ev_res["sintel_et"]["ms_per_pair"],
        "temporal_mse_ms_per_pair": ev_res["temporal_mse"]["ms_per_pair"]}
    kernels[2]["evaluation"] = {
        "per": "[5e]: the image sweep (bf16 softmax 512^2, 2x2) and the "
               "sintel-ada loop (f32 softmax 256x512, batch 8, RAFT flows)",
        "image_ms_per_pair": ev_res["image"]["ms_per_pair"],
        "sintel_ada_ms_per_pair": {
            a: v["ms_per_pair"] for a, v in ev_res["sintel_ada"].items()},
        "raft_ms_per_pair": ev_res["raft"]["ms_per_pair"]}
    log("[6] timing: K1 at its narrow widths (bf16, f32)")
    kernels[0]["spatial"] = {
        "per": "[8] spatial: one 2160x3840 frame at world 1 through "
               "stylize_spatial_sharded / stylize_adaattn_sharded against "
               "the unsharded stylize_*; K1 every launch in its halo-rows "
               "mode",
        "halo_mode_max_abs_err": errs["K1 halo"],
        "halo_mode_max_abs_err_f32": errs["K1 halo f32"],
        "halo_mode_bits_equal_reflect": errs["K1 halo same bits as reflect"],
        **{k: {f: v[f] for f in ("max_abs_err", "bits_equal", "ms_sharded",
                                 "ms_unsharded", "launches_per_frame")}
           | {"copies_share_sharded": v["profile_sharded"]["copies_share"],
              "copies_share_unsharded":
                  v["profile_unsharded"]["copies_share"]}
           for k, v in so_res["spatial"].items() if isinstance(v, dict)}}
    train = so_res["space_train"]
    steps = {tag: {f: train[tag][f] for f in (
        "ms_bare", "ms_sharded", "memory", "exchange_share",
        "metrics_max_rel", "grad_max_rel", "launches_per_step")}
        for tag in SPACE_KEYS.values()}
    per = ("[8] data x space: one step of each builder at its config's size "
           "on a world-1 (data, space) mesh against the bare step")
    kernels[0]["space_train"] = {
        "per": per + "; K1 every launch in its halo-rows mode",
        "halo_vjp_err_vs_f64": train["k1_halo_vjp"],
        **{t: v for t, v in steps.items() if v["launches_per_step"]["K1"]}}
    kernels[1]["space_train"] = {
        "per": per + "; K2 the packed stems and heads",
        **{t: v for t, v in steps.items() if v["launches_per_step"]["K2"]}}
    for row, k in ((kernels[2], "K3"), (kernels[3], "K4"),
                   (kernels[4], "K5")):
        row["space_train"] = {
            "per": per + "; the block's queries against the whole style",
            **{t: v for t, v in steps.items() if v["launches_per_step"][k]}}
    g15 = torch.Generator(device="cuda").manual_seed(15)
    for key, (shape, what) in K1_NARROW_TIMED.items():
        kernels[0][key] = timing_k1_narrow(g15, shape, what)
    kernels[0]["rtnstv"].update(
        max_abs_err_f32_vs_f64=errs["K1 f32 RTNSTV vs f64"],
        serving_ms={k: v["ms"] for k, v in rt_serving.items()},
        train_step_ms=rt_train["ms"], train_remat_ms=rt_train["remat_ms"])
    phase_profile()
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        f"GiB; wall {time.perf_counter() - t0:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
