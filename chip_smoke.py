#!/usr/bin/env python3
"""Smoke run of vst_tpu_torch on one NVIDIA GPU: builds the CUDA kernels,
holds each against its plain PyTorch version, drives the three paths of
the port (ReCoNet streaming stylization, AdaAttN arbitrary-style serving,
AdaAttN training) and checks what comes out.

    python3 chip_smoke.py

Phases, each failing loudly (an exception exits non-zero and prints no
result line):

1. card: nvidia-smi's name and power limit;
2. build: every kernel of ``vst_tpu_torch/kernels/csrc`` from source;
3. kernels: K1 (without and with its prologue) at (8,128,128,192) and K2
   at the stem and head packed shapes, bf16 and f32; K3 in bf16 at the
   three AdaAttN 512² batch-2 level shapes (and at relu3_1's with sharp
   scores of std 10) and in f32 at a ragged shape and the relu4_1 shape;
   K4 and K5 in bf16 at the three AdaAttN training level shapes (256²,
   batch 8; relu3_1's also with sharp scores) and in f32 at a ragged
   shape and the same three; each against its plain version on the same
   inputs;
4. model: the f32 ReCoNet forward through the kernels against the same
   forward through the plain versions at 1×256×256, the f32 AdaAttN
   forward (softmax through K3 against the plain version, cosine against
   the materialized oracle) at 1×256², the ReCoNet, SD1, SD2 and both
   AdaAttN forwards against the reference goldens
   (tests/goldens/reference_numerics.npz), and one f32 AdaAttN image
   train step at 1×64² through K3-K5 against their plain versions
   (metrics and every parameter gradient);
5. main paths, each with the launch counts set to 0 just before it and
   read just after: full-width ReCoNet from the port's seeded init, 512²
   batch 8 bf16, through ``stylize_reconet`` (uint8 and I420 wires), then
   ``StreamingStylizer`` over 96 synthetic 640×360 uint8 frames; then
   full-width AdaAttN (VGG19 seed 0, AdaAttN seed 1), 512² batch 2 bf16
   softmax, through ``stylize_adaattn`` and ``adaattn_style_state`` +
   ``stylize_adaattn_cached``, and ``AdaAttNVideoStylizer`` over 512×256
   synthetic uint8 frames at batch 4, softmax and cosine; then AdaAttN
   training, ``make_adaattn_image_step`` at 256² batch 8 softmax in f32
   and bf16 and ``make_adaattn_video_step`` at 256×512 batch 4 cosine;
6. timing: each kernel, its plain version and a library yardstick the
   port never calls (cuDNN ``F.conv2d`` of the same conv for K1/K2,
   ``F.scaled_dot_product_attention`` for K3 and its backward for K4/K5)
   at the main paths' shapes, printed as one JSON ``kernels`` line;
7. profile: device time by kernel over two forwards (train steps) of each
   main path (torch.profiler) and the device's busy share of that window.

The last line is {"ok": true, "device": {...}}.  Needs one CUDA card and
the CUDA toolkit (nvcc); no network, no cv2, no PIL.
"""

import contextlib
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
# H100 SXM data sheet, dense: bf16 tensor-core peak and HBM3 bandwidth.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
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


def phase_build():
    secs = _build.build_all()
    log(f"[2] build: {len(_build.KERNELS)} kernels in {secs:.2f} s")
    for name, out in _build.build_log.items():
        for line in out.splitlines():
            if any(s in line for s in ("entry function", "registers",
                                       "spill")):
                log(f"  {name}: {line.strip()}")
    for name in _build.KERNELS:
        _build.load(name)


K1_SHAPE = (8, 128, 128, 192)
K2_SHAPES = {"stem": (48, 768), "head": (768, 48)}   # packed (C, Co)


def k1_inputs(g, dtype):
    n, h, w, c = K1_SHAPE
    x = rnd(g, K1_SHAPE, 3.0, dtype)
    wt = rnd(g, (3, 3, c, c), 0.02, dtype)
    b = rnd(g, (c,), 0.02, dtype)
    gamma = rnd(g, (c,), 0.3, shift=1.0)
    beta = rnd(g, (c,), 0.1)
    return x, wt, b, gamma, beta


def k2_inputs(g, part, dtype):
    c, co = K2_SHAPES[part]
    return rnd(g, (8, 130, 130, c), 1.0, dtype), rnd(g, (3, 3, c, co), 0.05, dtype)


def phase_kernels(g):
    """Each kernel against its plain version on the same inputs.
    Tolerances: f32 1e-4·max|plain| (sums in another order over up to
    6912 terms); bf16 one bf16 ulp at the output's scale, 2^-7·max|plain|
    (the f32 sums may round to neighbouring bf16 values); the f32 stats
    1e-4·max|plain|."""
    log("[3] kernels against their plain versions")
    errs = {"K1": 0.0, "K2": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        apply_precision(dtype)
        tol = BF16_ULP if dtype == torch.bfloat16 else 1e-4
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        x, wt, b, gamma, beta = k1_inputs(g, dtype)
        y, s = res_block.conv3x3_in_stats(x, wt, b)
        yp, sp = res_block.conv3x3_in_stats_plain(x, wt, b)
        e1 = check(f"K1 {tag} y", y, yp, tol)
        check(f"K1 {tag} stats", s, sp, 1e-4)
        y2, s2 = res_block.conv3x3_in_stats(y, wt, b, s, gamma, beta)
        y2p, s2p = res_block.conv3x3_in_stats_plain(y, wt, b, s, gamma, beta)
        e2 = check(f"K1 {tag} prologue y", y2, y2p, tol)
        check(f"K1 {tag} prologue stats", s2, s2p, 1e-4)
        for part in K2_SHAPES:
            xk, wk = k2_inputs(g, part, dtype)
            e3 = check(f"K2 {tag} {part}", head_conv.conv3x3_valid(xk, wk),
                       head_conv.conv3x3_valid_plain(xk, wk), tol)
            if dtype == torch.bfloat16:
                errs["K2"] = max(errs["K2"], e3)
        if dtype == torch.bfloat16:
            errs["K1"] = max(e1, e2)
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


def phase_kernels_k3(g):
    """K3 against its plain version, at unit-scale scores and, in bf16 at
    relu3_1, at sharp scores of std 10 (base-2 running max and rescale,
    P rounded to bf16).  Tolerances: bf16 M1, M2 2^-6·max|plain| (one
    bf16 ulp of the output rounding plus the f32 difference of P rounded
    to bf16 against a running max instead of the row max); f32
    1e-4·max|plain| (sums in another order over up to 16384 keys); L
    1e-5·max|L| (f32 in both)."""
    errs = []
    cases = [("bf16", torch.bfloat16, (K3_BATCH, n, n, d, c), 1.0)
             for n, d, c in K3_LEVELS]
    n, d, c = K3_LEVELS[0]
    cases += [("bf16 sharp", torch.bfloat16, (K3_BATCH, n, n, d, c), 10.0),
              ("f32", torch.float32, (2, 300, 520, 96, 64), 1.0),
              ("f32", torch.float32, (K3_BATCH, 4096, 4096, 960, 512), 1.0)]
    for tag, dtype, shape, score_std in cases:
        apply_precision(dtype)
        q, k, v = k3_inputs(g, *shape, dtype, score_std)
        m1, m2, lse = adaattn_attention.softmax_attention_moments(q, k, v)
        p1, p2, pl = adaattn_attention.softmax_attention_moments_plain(q, k, v)
        tol = 2 * BF16_ULP if dtype == torch.bfloat16 else 1e-4
        name = f"K3 {tag} {shape}"
        e = max(check(f"{name} M1", m1, p1, tol), check(f"{name} M2", m2, p2, tol))
        check(f"{name} L", lse, pl, 1e-5)
        if dtype == torch.bfloat16:
            errs.append(e)
        del q, k, v, m1, m2, lse, p1, p2, pl
    torch.cuda.synchronize()
    return max(errs)


# AdaAttN training at 256² (relu3_1, relu4_1, relu5_1): (n = m, d, c)
TRAIN_LEVELS = [(4096, 448, 256), (1024, 960, 512), (256, 1472, 512)]
TRAIN_BATCH = 8


def k45_inputs(g, b, n, m, d, c, dtype, score_std=1.0):
    """K3's inputs, the plain forward's M1, M2, L on them, unit-scale
    cotangents in the inputs' type and the row term D."""
    q, k, v = k3_inputs(g, b, n, m, d, c, dtype, score_std)
    m1, m2, lse = adaattn_attention.softmax_attention_moments_plain(q, k, v)
    dm1, dm2 = rnd(g, (b, n, c), 1.0, dtype), rnd(g, (b, n, c), 1.0, dtype)
    dd = adaattn_attention.row_term(m1, m2, dm1, dm2)
    return q, k, v, lse, dd, dm1, dm2


def phase_kernels_k45(g):
    """K4 (dQ) and K5 (dK, dV) against their plain versions on the same
    inputs and cotangents: bf16 at the three AdaAttN training level shapes
    (256², batch 8) and at relu3_1's with sharp scores of std 10; f32 at a
    ragged shape and at the three level shapes (the f32 image step, the
    config default, launches both at all three).  Tolerances, of each
    output's scale: bf16 2^-6 (one bf16 ulp of the output rounding plus A
    and dS rounded to bf16 from f32 values summed in another order); f32
    1e-4 (sums in another order over up to 4096 terms)."""
    errs = {"K4": 0.0, "K5": 0.0}
    levels = [(TRAIN_BATCH, n, n, d, c) for n, d, c in TRAIN_LEVELS]
    cases = [("bf16", torch.bfloat16, shape, 1.0) for shape in levels]
    cases += [("bf16 sharp", torch.bfloat16, levels[0], 10.0),
              ("f32", torch.float32, (2, 300, 520, 96, 64), 1.0)]
    cases += [("f32", torch.float32, shape, 1.0) for shape in levels]
    for tag, dtype, shape, score_std in cases:
        apply_precision(dtype)
        args = k45_inputs(g, *shape, dtype, score_std)
        dq = adaattn_attention.softmax_attention_dq(*args)
        dk, dv = adaattn_attention.softmax_attention_dkv(*args)
        pq = adaattn_attention.softmax_attention_dq_plain(*args)
        pk, pv = adaattn_attention.softmax_attention_dkv_plain(*args)
        tol = 2 * BF16_ULP if dtype == torch.bfloat16 else 1e-4
        name = f"{tag} {shape}"
        e4 = check(f"K4 {name} dQ", dq, pq, tol)
        e5 = max(check(f"K5 {name} dK", dk, pk, tol),
                 check(f"K5 {name} dV", dv, pv, tol))
        if dtype == torch.bfloat16:
            errs["K4"] = max(errs["K4"], e4)
            errs["K5"] = max(errs["K5"], e5)
        del args, dq, dk, dv, pq, pk, pv
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


def phase_timing(launches, errs):
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
          "ms": 5 * (t["k"] + t["k_pro"]),
          "plain_ms": 5 * (t["p"] + t["p_pro"]),
          "bound_ms": 5 * (b1 + b1_pro), "bound_by": by1,
          "library_ms": 10 * t["lib"],
          "per": "one 512x512 batch-8 bf16 forward: 5 launches without and "
                 "5 with the prologue at (8,128,128,192)->192",
          "ms_per_launch": [t["k"], t["k_pro"]]}

    k2 = {"name": "K2 conv3x3_valid", "route": "cuda",
          "source": "vst_tpu_torch/kernels/csrc/head_conv.cu",
          "replaces": "vst_tpu/kernels/head_conv.py:33",
          "launches": launches["K2"], "max_abs_err": errs["K2"],
          "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
          "library_ms": 0.0,
          "per": "one 512x512 batch-8 bf16 forward: the packed stem "
                 "(8,130,130,48)->768 and head (8,130,130,768)->48",
          "ms_per_launch": []}
    by2 = set()
    for part, (c2, co) in K2_SHAPES.items():
        xk, wk = k2_inputs(g, part, dt)
        tk = event_ms(lambda: head_conv.conv3x3_valid(xk, wk))
        tp = event_ms(lambda: head_conv.conv3x3_valid_plain(xk, wk))
        xl = xk.permute(0, 3, 1, 2)
        wl = wk.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        tl = event_ms(lambda: F.conv2d(xl, wl))
        bb, by = bound(2 * 9 * c2 * co * 8 * 128 * 128,
                       (8 * 130 * 130 * c2 + 9 * c2 * co
                        + 8 * 128 * 128 * co) * 2, dt)
        log(f"  K2 {part} ms: kernel {tk:.4f}, plain {tp:.4f}, cuDNN conv "
            f"{tl:.4f}, bound {bb:.4f} ({by})")
        k2["ms"] += tk
        k2["plain_ms"] += tp
        k2["library_ms"] += tl
        k2["bound_ms"] += bb
        k2["ms_per_launch"].append(tk)
        by2.add(by)
    k2["bound_by"] = "operations" if "operations" in by2 else "bytes"
    torch.cuda.synchronize()
    return [k1, k2, timing_k3(launches["K3"], errs["K3"])]


def timing_k3(launches, err):
    """K3, its plain version and one PyTorch call of the same function,
    ``F.scaled_dot_product_attention(q, k, [V, V∘V], scale=1)`` (M1‖M2; a
    yardstick the port never calls), at the three AdaAttN 512² batch-2
    levels, bf16; one launch per level per forward.  Bound: FLOPs 2·b·n·m·
    (d + 2c) on the tensor cores; bytes q, k, v read once, M1, M2, L
    written once."""
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
          "ms_per_launch": [], "library": "F.scaled_dot_product_attention"}
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
        log(f"  K3 (n={n}, d={d}, c={c}) ms: kernel {tk:.4f} "
            f"({flops / tk / 1e9:.1f} TFLOP/s), plain {tp:.4f}, "
            f"{k3['library']} {tl:.4f}, bound {bb:.4f} ({by})")
        k3["ms"] += tk
        k3["plain_ms"] += tp
        k3["library_ms"] += tl
        k3["bound_ms"] += bb
        k3["ms_per_launch"].append(tk)
        if by == "bytes":
            k3["bound_by"] = "bytes"
        del q, k, v, vv
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


def timing_k45(launches, errs):
    """K4, K5 and their plain versions at the three AdaAttN training level
    shapes (256², batch 8), bf16, one launch each per level per step.
    Library yardstick (never called by the port): the backward of
    ``F.scaled_dot_product_attention(q, k, [V, V∘V], scale=1)`` by
    ``torch.autograd.grad``, which returns dQ, dK and dV together; it is
    put beside both kernels.  Bounds: FLOPs 4nm(d + c) (K4) and
    4nmd + 8nmc (K5) per image on the tensor cores; bytes q, k, v, dM1,
    dM2 (bf16) and L, D (f32) read once, the outputs written once."""
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
            "ms_per_launch": [], "library": None})
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
            bb, by = bound(TRAIN_BATCH * r["flops"](n, d, c), nbytes, dt)
            log(f"  {kid} (n={n}, d={d}, c={c}) ms: kernel {tk:.4f} "
                f"({TRAIN_BATCH * r['flops'](n, d, c) / tk / 1e9:.1f} TFLOP/s), "
                f"plain {tp:.4f}, SDPA backward ({backend}) {tl:.4f}, bound "
                f"{bb:.4f} ({by})")
            row["ms"] += tk
            row["plain_ms"] += tp
            row["library_ms"] += tl
            row["bound_ms"] += bb
            row["ms_per_launch"].append(tk)
            row["library"] = (f"backward of F.scaled_dot_product_attention "
                              f"({backend}), dQ, dK, dV together")
            if bb >= r.get("top", 0.0):   # what bounds the largest level
                r["top"], row["bound_by"] = bb, by
        del args, q, k, v, vv, leaves, out, go
    torch.cuda.synchronize()
    return [r["row"] for r in rows.values()]


def _profile(label, forward):
    """Device time by operator over two forwards (torch.profiler), and the
    device's busy share of the window's wall time."""
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
    for e in rows[:14]:
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


def main():
    if not torch.cuda.is_available():
        print("error: no CUDA device; chip_smoke.py runs only on a GPU",
              file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    smi = phase_card()
    phase_build()
    g = torch.Generator(device="cuda").manual_seed(0)
    errs = phase_kernels(g)
    errs["K3"] = phase_kernels_k3(g)
    errs.update(phase_kernels_k45(g))
    phase_model()
    launches = phase_main_path()
    launches["K3"] = phase_main_adaattn()
    train = phase_main_train()
    by_path = {"serving": launches["K3"], "training": train["K3"]}
    launches["K3"] += train["K3"]
    launches.update(K4=train["K4"], K5=train["K5"])
    kernels = phase_timing(launches, errs) + timing_k45(launches, errs)
    kernels[2]["launches_by_path"] = by_path
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
    sys.exit(main())
