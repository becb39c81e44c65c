#!/usr/bin/env python3
"""Smoke run of vst_tpu_torch on one NVIDIA GPU: builds the CUDA kernels,
holds each against its plain PyTorch version, drives the seven paths of
the port (ReCoNet streaming stylization, AdaAttN arbitrary-style serving,
AdaAttN training, ReCoNet training, RTNSTV serving, RTNSTV training,
evaluation) and checks what comes out.

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
   and two launches of each giving the same bits; K3 in bf16 at the
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
   shapes;
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
6. timing: each kernel, its plain version and a library yardstick the
   port never calls (cuDNN ``F.conv2d`` of the same conv for K1/K2,
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
   slice widths the built library reports; K1 also at RTNSTV's
   (8,90,160,48) in bf16 and f32 beside cuDNN (benchmark mode);
7. profile: device time by kernel over two forwards (train steps) of each
   main path, ReCoNet in bf16 and f32, the f32 ReCoNet flow step and the
   f32 RTNSTV step (torch.profiler), and the device's busy share of that
   window.

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

builds the kernels and runs RTNSTV's part alone: K1 at (8,90,160,48),
the RTNSTV forward and golden, serving, training ([5d]), K1's times at
that shape and the f32 step's profile.

    python3 chip_smoke.py --eval

builds the kernels and runs [5e] alone.
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
    for w in WRAPPERS:
        w.launches = 0


def counts():
    """Launches of K1 … K5 since the last ``reset_counts``."""
    return tuple(w.launches for w in WRAPPERS)


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
K2_F32_ODD = {"C6 Co10": (2, 12, 21, 6, 10)}
# [5e]'s temporal MSE: ReCoNet f32 one 640×360 frame at a time
K1_EVAL_F32 = {"temporal MSE": (1, 90, 160, 192)}
K2_EVAL_F32 = {"temporal MSE stem": (1, 92, 162, 48, 768),
               "temporal MSE head": (1, 92, 162, 768, 48)}

# The shapes [3] held against the plain versions: ("K1" | "K2" | "K3",
# dtype, shape, batch-stride-0 operands); [5e] fails on a launch outside.
CHECKED = set()


def _k3_key(q, k, v):
    b = q.shape[0]
    bcast = "".join(t for t, x in (("q", q), ("kv", k))
                    if b > 1 and x.stride(0) == 0)
    return ("K3", q.dtype, (b, q.shape[1], k.shape[1], q.shape[2],
                            v.shape[2]), bcast)


@contextlib.contextmanager
def recording_launches():
    """Record the key of every K1, K2 and K3 launch in the block (the
    wrappers' ``_launch`` / ``_moments_fwd``, which run only on the
    card); yields the set."""
    seen = set()
    att = adaattn_attention
    saved = res_block._launch, head_conv._launch, att._moments_fwd

    def k1(x, w, *a, **kw):
        seen.add(("K1", x.dtype, tuple(x.shape), w.shape[3]))
        return saved[0](x, w, *a, **kw)

    def k2(x, w):
        seen.add(("K2", x.dtype, tuple(x.shape), w.shape[3]))
        return saved[1](x, w)

    def k3(q, k, v):
        seen.add(_k3_key(q, k, v))
        return saved[2](q, k, v)

    res_block._launch, head_conv._launch, att._moments_fwd = k1, k2, k3
    try:
        yield seen
    finally:
        res_block._launch, head_conv._launch, att._moments_fwd = saved


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
                          {**K1_BF16, **K1_F32_ODD,
                           **K1_EVAL_F32}.items()),
            "K2 f32": max(_k2_check(g, torch.float32, f"f32 {label}", shape,
                                    1e-4) for label, shape in
                          {**K2_BF16, **K2_F32_ODD,
                           **K2_EVAL_F32}.items())}
    apply_precision(torch.bfloat16)
    errs.update(
        K1=max(_k1_check(g, torch.bfloat16, f"bf16 {label}", shape, BF16_ULP)
               for label, shape in K1_BF16.items()),
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
        apply_precision(dtype)
        args = k45_inputs(g, *shape, dtype, score_std, bcast)
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
        suffix = "" if dtype == torch.bfloat16 else " f32"
        errs["K4" + suffix] = max(errs["K4" + suffix], e4)
        errs["K5" + suffix] = max(errs["K5" + suffix], e5)
        if parent is not None and tag == "f32" and shape in levels:
            if not all(torch.equal(a, b) for a, b in zip((dk, dv),
                                                         parent(*args))):
                raise AssertionError(f"K5 f32 {shape}: differs from the "
                                     f"parent's")
            log(f"  K5 f32 {shape}: the same bits as the parent's")
        del args, ref, dq, dk, dv, pq, pk, pv
    log("  K4 and K5, bf16 and f32: a second launch gives the same bits at "
        "every shape")
    torch.cuda.synchronize()
    return errs


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
    """``--rtnstv``: [3] at RTNSTV's shape alone: K1 (8, 90, 160, 48) → 48
    in f32 and bf16 against the plain version (and f32 against float64),
    two launches the same bits."""
    log("[3] K1 at RTNSTV's residual width")
    apply_precision(torch.float32)
    errs = {"K1 f32": _k1_check(g, torch.float32, "f32 RTNSTV", K1_RTNSTV,
                                1e-4)}
    errs["K1 f32 vs f64"] = _k1_f64_check(g, K1_RTNSTV)
    apply_precision(torch.bfloat16)
    errs["K1"] = _k1_check(g, torch.bfloat16, "bf16 RTNSTV", K1_RTNSTV,
                           BF16_ULP)
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


def timing_k1_rtnstv(g):
    """K1 at RTNSTV's serving shape (8, 90, 160, 48) → 48, per launch
    without and with its prologue, in bf16 and f32 (3xTF32), beside its
    plain version and cuDNN's ``F.conv2d`` of the same conv in benchmark
    mode (f32 with TF32 off), the faster of NCHW and channels_last; bound
    in the convention of the other K1 rows.  Per forward: 5 launches
    without and 5 with the prologue."""
    n, h, w, c = K1_RTNSTV
    flops = 2 * 9 * c * c * n * h * w
    row = {"shape": "(8,90,160,48)->48, RTNSTV 640x360 b8 serving",
           "per": "one 640x360 batch-8 forward: 5 launches without and 5 "
                  "with the prologue"}
    for dt, tag, peak, nb in ((torch.bfloat16, "", torch.bfloat16, 2),
                              (torch.float32, "_f32", "tf32x3", 4)):
        apply_precision(dt)
        x, wt, b, gamma, beta = k1_inputs(g, dt, K1_RTNSTV)
        y, s = res_block.conv3x3_in_stats(x, wt, b)
        t = [event_ms(lambda: res_block.conv3x3_in_stats(x, wt, b), 20, 3),
             event_ms(lambda: res_block.conv3x3_in_stats(
                 y, wt, b, s, gamma, beta), 20, 3)]
        tp = [event_ms(lambda: res_block.conv3x3_in_stats_plain(x, wt, b),
                       5, 1),
              event_ms(lambda: res_block.conv3x3_in_stats_plain(
                  y, wt, b, s, gamma, beta), 5, 1)]
        xp = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
        tl, layout, both = cudnn_f32_ms(xp, wt.permute(3, 2, 0, 1), b)
        nbytes = (2 * n * h * w * c + 9 * c * c + c) * nb + n * 2 * c * 4
        b1, by = bound(flops, nbytes, peak)
        b1_pro, _ = bound(flops, nbytes + (n * 2 * c + 2 * c) * 4, peak)
        row.update({f"ms{tag}": 5 * (t[0] + t[1]),
                    f"ms{tag}_per_launch": t,
                    f"plain_ms{tag}": 5 * (tp[0] + tp[1]),
                    f"bound_ms{tag}": 5 * (b1 + b1_pro),
                    f"bound_by{tag}": by,
                    f"library_ms{tag}": 10 * tl,
                    f"library_ms{tag}_per_launch": tl,
                    f"library{tag}": f"F.conv2d (cuDNN, benchmark mode, "
                                     f"{layout}; NCHW {both['NCHW']:.4f}, "
                                     f"channels_last "
                                     f"{both['channels_last']:.4f} ms)"})
        log(f"  K1{tag or ' bf16'} RTNSTV {K1_RTNSTV}->48 ms per launch: "
            f"kernel {t[0]:.4f}, with prologue {t[1]:.4f} "
            f"({flops / t[0] / 1e9:.1f} / {flops / t[1] / 1e9:.1f} TFLOP/s; "
            f"bound {b1:.4f} / {b1_pro:.4f} ({by}), share "
            f"{b1 / t[0]:.3f} / {b1_pro / t[1]:.3f}); plain {tp[0]:.4f} / "
            f"{tp[1]:.4f}; cuDNN {tl:.4f} ({layout}; NCHW {both['NCHW']:.4f}"
            f", channels_last {both['channels_last']:.4f})")
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
    log("[6] timing: K1 at RTNSTV's shape")
    row = timing_k1_rtnstv(g)
    row.update(errs=errs, serving=serving, train=train)
    log(json.dumps({"K1 RTNSTV": row}))
    log("[7] profile")
    _profile_rtnstv_step(np.random.default_rng(4))


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
    xp = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect").contiguous(
        memory_format=torch.channels_last)
    w_oihw = wt.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    t["lib"] = event_ms(lambda: F.conv2d(xp, w_oihw, b))
    log(f"  K1 ms: kernel {t['k']:.4f}, with prologue {t['k_pro']:.4f}; "
        f"plain {t['p']:.4f} / {t['p_pro']:.4f}; cuDNN conv {t['lib']:.4f}")
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
          "bound_share_per_launch": [], "library_ms_per_launch": []}
    by2 = set()
    for part, (c2, co) in K2_SHAPES.items():
        xk, wk = k2_inputs(g, (8, 130, 130, c2, co), dt)
        tk = event_ms(lambda: head_conv.conv3x3_valid(xk, wk))
        tp = event_ms(lambda: head_conv.conv3x3_valid_plain(xk, wk))
        xl = xk.permute(0, 3, 1, 2)
        wl = wk.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        tl = event_ms(lambda: F.conv2d(xl, wl))
        flops2 = 2 * 9 * c2 * co * 8 * 128 * 128
        bb, by = bound(flops2, (8 * 130 * 130 * c2 + 9 * c2 * co
                                + 8 * 128 * 128 * co) * 2, dt)
        log(f"  K2 {part} ms: kernel {tk:.4f} ({flops2 / tk / 1e9:.1f} "
            f"TFLOP/s, bound share {bb / tk:.3f}), plain {tp:.4f}, cuDNN conv "
            f"{tl:.4f}, bound {bb:.4f} ({by})")
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


def cudnn_f32_ms(x_nchw, w_oihw, b=None):
    """The fair library yardstick of an f32 K1/K2 launch: cuDNN's
    ``F.conv2d`` in f32 (TF32 off) with ``torch.backends.cudnn.benchmark``
    set only around this timing, in the NCHW and the channels_last layout;
    returns (the faster's ms, its layout, both ms)."""
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
    channels_last (``cudnn_f32_ms``), per forward as the bf16 rows; event
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
    tl, layout, both = cudnn_f32_ms(xp, wt.permute(3, 2, 0, 1), b)
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
        tl, layout, both = cudnn_f32_ms(xk.permute(0, 3, 1, 2),
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


def _profile(label, forward, top=14):
    """Device time by operator over two forwards (torch.profiler), and the
    device's busy share of the window's wall time; the ``top`` rows."""
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
    # the device time of what they launch, which would count it twice
    rows = sorted((e for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA")),
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
             "--rtnstv": phase_rtnstv_alone, "--eval": phase_eval_alone}
    if not (argv == [] or (len(argv) == 1 and argv[0] in alone)
            or parent is not None):
        print(f"usage: chip_smoke.py [--f32-step | --f32-reconet | "
              f"--reconet-train | --rtnstv | --eval | --parent DIR]; got "
              f"{argv}", file=sys.stderr)
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
    by_path = {"serving": launches["K3"], "training": train["K3"],
               "training loop": loop["K3"], "evaluation": ev["K3"]}
    launches["K3"] += train["K3"] + loop["K3"] + ev["K3"]
    launches.update(K4=train["K4"] + loop["K4"], K5=train["K5"] + loop["K5"])
    k45_rows, k3_f32 = timing_k45(launches, errs, slices)
    kernels = phase_timing(launches, errs, slices["K3"]) + k45_rows
    kernels[2]["launches_by_path"] = by_path
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
    log("[6] timing: K1 at RTNSTV's shape (bf16, f32)")
    kernels[0]["rtnstv"] = timing_k1_rtnstv(
        torch.Generator(device="cuda").manual_seed(15))
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
