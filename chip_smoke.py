#!/usr/bin/env python3
"""Smoke run of vst_tpu_torch on one NVIDIA GPU: builds the CUDA kernels,
holds each against its plain PyTorch version, drives the three paths of
the port (ReCoNet streaming stylization, AdaAttN arbitrary-style serving,
AdaAttN training) and checks what comes out.

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
   SD1/SD2 width (8,128,128,64) and the 640×360 stream's (8,90,160,192),
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
4. model: the f32 ReCoNet forward through the kernels against the same
   forward through the plain versions at 1×256×256 (and, with grad mode
   on, raising: K1/K2 have no backward yet), the f32 AdaAttN
   forward (softmax through K3 against the plain version, cosine against
   the materialized oracle) at 1×256², the ReCoNet, SD1, SD2 and both
   AdaAttN forwards against the reference goldens
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
6. timing: each kernel, its plain version and a library yardstick the
   port never calls (cuDNN ``F.conv2d`` of the same conv for K1/K2,
   ``F.scaled_dot_product_attention`` for K3 and its backward for K4/K5)
   at the main paths' shapes, printed as one JSON ``kernels`` line (K1/K2
   rows also carry ms, TFLOP/s and the bound's share per launch; K3-K5
   rows the same per level, and the f32 K3/K4/K5 times at the three
   training levels as ``ms_f32`` (with TFLOP/s and the executed-work
   factor per level) beside ``bound_ms_f32`` (3xTF32 peak)
   and ``library_ms_f32`` (SDPA in f32, TF32 off); the f32 K1 and K2 at
   the bf16 rows' shapes beside their plain versions and cuDNN in f32,
   TF32 off, in benchmark mode and the faster of NCHW and channels_last);
   K3's (bf16 and
   f32) and K4/K5's executed-work factor per level is logged, from the
   slice widths the built library reports;
7. profile: device time by kernel over two forwards (train steps) of each
   main path, ReCoNet in bf16 and f32 (torch.profiler), and the device's
   busy share of that window.

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
"""

import contextlib
import ctypes
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from vst_tpu_torch.device import apply_precision
from vst_tpu_torch.infer.image import (adaattn_style_state, stylize_adaattn,
                                       stylize_adaattn_cached, stylize_reconet)
from vst_tpu_torch.infer.video import AdaAttNVideoStylizer, StreamingStylizer
from vst_tpu_torch.kernels import (_build, adaattn_attention, head_conv,
                                   res_block)
from vst_tpu_torch.models.adaattn import (init_stylizing_network,
                                          stylizing_network_cached)
from vst_tpu_torch.models.reconet import (init_reconet, init_reconet_sd1,
                                          init_reconet_sd2)
from vst_tpu_torch.models.vgg import init_vgg19_adaattn
from vst_tpu_torch.ops import conv as ops_conv
from vst_tpu_torch.ops.yuv import rgb_to_i420
from vst_tpu_torch.train.config import AdaAttNImageConfig, AdaAttNVideoConfig
from vst_tpu_torch.train.state import create
from vst_tpu_torch.train.steps import (make_adaattn_image_step,
                                       make_adaattn_video_step)

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
K1_BF16 = {"ReCoNet": K1_SHAPE, "SD1/SD2": (8, 128, 128, 64),
           "stream": (8, 90, 160, 192)}
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
    K2_F32_ODD); a second launch must give the same bits.  Tolerances: f32
    1e-4·max|plain| (sums in another order over up to 6912 terms, and the
    split's 2^-21-relative products); bf16 one bf16 ulp at the output's
    scale, 2^-7·max|plain| (the f32 sums may round to neighbouring bf16
    values); the f32 stats 1e-4·max|plain|."""
    log("[3] kernels against their plain versions")
    apply_precision(torch.float32)
    errs = {"K1 f32": max(_k1_check(g, torch.float32, f"f32 {label}", shape,
                                    1e-4) for label, shape in
                          {**K1_BF16, **K1_F32_ODD}.items()),
            "K2 f32": max(_k2_check(g, torch.float32, f"f32 {label}", shape,
                                    1e-4) for label, shape in
                          {**K2_BF16, **K2_F32_ODD}.items())}
    apply_precision(torch.bfloat16)
    errs.update(
        K1=max(_k1_check(g, torch.bfloat16, f"bf16 {label}", shape, BF16_ULP)
               for label, shape in K1_BF16.items()),
        K2=max(_k2_check(g, torch.bfloat16, f"bf16 {label}", shape, BF16_ULP)
               for label, shape in K2_BF16.items()))
    log("  f32 and bf16 K1 and K2: a second launch gives the same bits at "
        "every shape")
    torch.cuda.synchronize()
    return errs


# AdaAttN attention levels at 512² (relu3_1, relu4_1, relu5_1): (n = m, d, c)
K3_LEVELS = [(16384, 448, 256), (4096, 960, 512), (1024, 1472, 512)]
K3_BATCH = 2


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
    d = 1480 past relu5_1's), a stride-0 K/V and a stride-0 Q.
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
    for tag, dtype, shape, score_std, bcast in cases:
        apply_precision(dtype)
        q, k, v = _broadcast(*k3_inputs(g, *shape, dtype, score_std), bcast)
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
        key = "K3" if dtype == torch.bfloat16 else "K3 f32"
        errs[key] = max(errs[key], e)
        del q, k, v, m1, m2, lse, ref
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
    try:   # K1/K2 have no backward: a forward that needs a gradient raises
        model(x)
    except RuntimeError as e:
        if "has no backward" not in str(e):
            raise
        log(f"  ReCoNet f32 forward with grad mode on raises: {e}")
    else:
        raise AssertionError("ReCoNet forward with grad mode on did not raise")
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
    ``per_step`` (K3, K4, K5) launches per step; returns the counts.
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
    if times:
        ms = float(np.median(times))
        log(f"  {label}: {ms:.3f} ms/step median of {steps} (min "
            f"{min(times):.3f}, max {max(times):.3f}) -> {b * 1e3 / ms:.2f} "
            f"samples/s (min {b * 1e3 / max(times):.2f}, max "
            f"{b * 1e3 / min(times):.2f})")
    if bad or launches != expect or moved < len(before) - 3:
        raise AssertionError(f"{label}: non-finite steps {bad}, launches "
                             f"{launches} (expected {expect}), moved {moved}")
    return launches


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
    total = [0, 0, 0]
    for dtype in ("float32", "bfloat16"):
        c = dataclasses.replace(cfg, dtype=dtype)
        launches = _train_run(f"image {dtype}", c, make_adaattn_image_step,
                              batch, 6, 2, (6, 3, 3))
        total = [a + b for a, b in zip(total, launches[2:])]
    vcfg = AdaAttNVideoConfig()
    vbatch = [torch.from_numpy(rng.integers(0, 256, (vcfg.batch_size,
                                                     *vcfg.frame_size, 3))
                               .astype(np.float32)).cuda() for _ in range(3)]
    _train_run("video float32 cosine", vcfg, make_adaattn_video_step, vbatch,
               3, 0, (0, 0, 0))
    return dict(zip(("K3", "K4", "K5"), total))


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
    ``library_ms_f32``, ``executed_work_f32`` (as K3's: products run per
    product of the least work, each of them three tf32 ones) and
    ``tflops_f32_per_launch`` (on the least work)."""
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
              "work": [], "tflops": []}
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
        f"{k4['library_ms_f32']:.4f}")
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


def main(argv):
    if not torch.cuda.is_available():
        print("error: no CUDA device; chip_smoke.py runs only on a GPU",
              file=sys.stderr)
        return 1
    parent = argv[1] if len(argv) == 2 and argv[0] == "--parent" else None
    alone = {"--f32-step": phase_f32_step, "--f32-reconet": phase_f32_reconet}
    if not (argv == [] or (len(argv) == 1 and argv[0] in alone)
            or parent is not None):
        print(f"usage: chip_smoke.py [--f32-step | --f32-reconet | --parent "
              f"DIR]; got {argv}", file=sys.stderr)
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
    train = phase_main_train()
    by_path = {"serving": launches["K3"], "training": train["K3"]}
    launches["K3"] += train["K3"]
    launches.update(K4=train["K4"], K5=train["K5"])
    k45_rows, k3_f32 = timing_k45(launches, errs, slices)
    kernels = phase_timing(launches, errs, slices["K3"]) + k45_rows
    kernels[2]["launches_by_path"] = by_path
    kernels[2]["ms_f32"] = sum(k3_f32["ms"])
    kernels[2]["ms_f32_per_launch"] = k3_f32["ms"]
    kernels[2]["bound_ms_f32"] = k3_f32["bound_ms"]
    kernels[2]["library_ms_f32"] = k3_f32["library_ms"]
    kernels[2]["library_f32"] = k3_f32["library"]
    kernels[2]["max_abs_err_f32"] = errs["K3 f32"]
    kernels[2]["executed_work_f32"] = k3_f32["work"]
    kernels[2]["tflops_f32_per_launch"] = k3_f32["tflops"]
    kernels[2]["ms_f32_per"] = ("one f32 launch at each AdaAttN training "
                                "level (256x256 batch 8)")
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
