#!/usr/bin/env python3
"""Smoke run of vst_tpu_torch on one NVIDIA GPU: builds the CUDA kernels,
holds each against its plain PyTorch version, drives the main path
(ReCoNet streaming stylization) and checks what comes out.

    python3 chip_smoke.py

Phases, each failing loudly (an exception exits non-zero and prints no
result line):

1. card: nvidia-smi's name and power limit;
2. build: every kernel of ``vst_tpu_torch/kernels/csrc`` from source;
3. kernels: K1 (without and with its prologue) at (8,128,128,192) and K2
   at the stem and head packed shapes, bf16 and f32, against the plain
   versions on the same inputs;
4. model: the f32 ReCoNet forward through the kernels against the same
   forward through the plain versions at 1×256×256, and the ReCoNet,
   SD1 and SD2 forwards against the reference goldens
   (tests/goldens/reference_numerics.npz);
5. main path: full-width ReCoNet from the port's seeded init, 512²
   batch 8 bf16, through ``stylize_reconet`` (uint8 and I420 wires), then
   ``StreamingStylizer`` over 96 synthetic 640×360 uint8 frames, with the
   kernels' launch counts read around this phase only;
6. timing: each kernel, its plain version and the cuDNN ``F.conv2d`` of
   the same conv (a yardstick the port never calls) at the main path's
   shapes, printed as one JSON ``kernels`` line;
7. profile: device time by kernel over two main-path forwards
   (torch.profiler) and the device's busy share of that window.

The last line is {"ok": true, "device": {...}}.  Needs one CUDA card and
the CUDA toolkit (nvcc); no network, no cv2, no PIL.
"""

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from vst_tpu_torch.device import apply_precision
from vst_tpu_torch.infer.image import stylize_reconet
from vst_tpu_torch.infer.video import StreamingStylizer
from vst_tpu_torch.kernels import _build, head_conv, res_block
from vst_tpu_torch.models.reconet import (init_reconet, init_reconet_sd1,
                                          init_reconet_sd2)
from vst_tpu_torch.ops import conv as ops_conv
from vst_tpu_torch.ops.yuv import rgb_to_i420

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
    (the comparison of phase 4; the package itself never does this)."""
    saved = (res_block.conv3x3_in_stats, ops_conv.conv3x3_valid)
    res_block.conv3x3_in_stats = res_block.conv3x3_in_stats_plain
    ops_conv.conv3x3_valid = head_conv.conv3x3_valid_plain
    try:
        yield
    finally:
        res_block.conv3x3_in_stats, ops_conv.conv3x3_valid = saved


def reset_counts():
    res_block.conv3x3_in_stats.launches = 0
    head_conv.conv3x3_valid.launches = 0


def counts():
    return (res_block.conv3x3_in_stats.launches,
            head_conv.conv3x3_valid.launches)


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
            if "registers" in line or "spill" in line:
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
    k1, k2 = counts()

    log(f"  launches: K1 {k1}, K2 {k2} over {forwards} forwards")
    if (k1, k2) != (10 * forwards, 2 * forwards):
        raise AssertionError(f"expected K1 {10 * forwards}, K2 "
                             f"{2 * forwards} launches")
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
    return [k1, k2]


def phase_profile():
    """Where the time of one 512² batch-8 bf16 forward goes: device time by
    operator over two forwards (torch.profiler), and the device's busy
    share of the window's wall time."""
    log("[7] profile: 2 forwards, 512² b8 bf16")
    from torch.profiler import ProfilerActivity, profile

    model = init_reconet(0, device="cuda", dtype=torch.bfloat16)
    x = np.random.default_rng(4).integers(0, 256, (8, 512, 512, 3)).astype(
        np.uint8)
    stylize_reconet(model, x, uint8_out=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            stylize_reconet(model, x, uint8_out=True)
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
    log(f"  window {wall_ms:.3f} ms wall, {busy_ms:.3f} ms device time "
        f"→ busy {100 * busy_ms / wall_ms:.1f}%")
    for e in rows[:14]:
        if dev_us(e) <= 0:
            break
        log(f"  {dev_us(e) / 2e3:9.3f} ms/forward  x{e.count // 2:<4d} "
            f"{e.key[:90]}")


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
    phase_model()
    launches = phase_main_path()
    kernels = phase_timing(launches, errs)
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
