#!/usr/bin/env python3
"""The bf16 K1 at narrow residual widths (RTNSTV's 48 channels, SD1/SD2's
64) against variants that drop one part of its design, on one NVIDIA
GPU: what a call costs on the host and on the device, and what each part
is worth on its own.

    python3 experiments/k1_narrow_variants.py

Each variant is the shipped ``conv3x3_wgmma.cuh`` or
``res_block_common.cuh`` with a few text edits (each must apply exactly
once), written with copies of ``conv3x3_tf32.cuh`` and ``res_block.cu``
into ``build/k1_narrow_variants/<name>/`` (the headers beside the source,
where its includes find them first), built with the package's nvcc
flags, all ``nvcc``s at once, and called through the package's own
wrapper with the variant's library loaded in place of the package's.

- ``shipped``: the narrow body as it is: 16 x 16-pixel tiles (two 64-row
  GEMM blocks a consumer warpgroup), the nine taps' weights resident in
  shared memory and each tile's products in one commit group, the
  prologue's parameters derived by the halo threads; then
  ``finalize_stats``: two launches a call.
- ``mt1``: 8 x 16-pixel tiles (one GEMM block a warpgroup), the tile the
  body had with statistics before.
- ``prologue_launch``: the prologue's parameters from a launch of their
  own (``prologue_params``), as the wider K1 has them.
- ``staged``: the wider body's structure at the narrow tile: the weights
  streamed through a ring of four (tap) stages every tile, each stage
  waited for and released (and ``prologue_params``).
- Timing only (their results are not checked): ``no_mma`` issues no
  product; ``no_loads`` stages no halo (the rings' waits stay);
  ``no_epilogue`` skips the bias, the stores and the statistics after a
  tile's products.

At (8, 90, 160, 48) and (8, 128, 128, 64), without and with the
prologue, each variant reports:
- the call's time: CUDA events around 50 back-to-back wrapper calls;
- the device time a call: CUDA events around 20 calls queued behind a
  sleep kernel, so that the card runs them back to back, and beside it
  torch.profiler's time of each kernel (the conv, ``finalize_stats`` and,
  where it has one, ``prologue_params``) over 20 more;
- the host time a call: ``time.perf_counter`` over 200 calls with no
  synchronization between them.
Each variant is timed twice (in order, then in reverse) and the minimum
printed.  For the shipped body the host time is also split: through
the autograd Function (what a call with a gradient to carry costs), the
wrapper (which skips the Function when no gradient can flow), ``_launch``
alone, and the bare ctypes call on buffers allocated once.  Beside them: cuDNN's
``F.conv2d`` of the same conv in benchmark mode (the faster of NCHW and
channels_last) and the bound (each input read once, each output written
once, over 3.35 TB/s; the FLOPs over 989 TFLOP/s).  The shipped kernel
and every checked variant are held against the plain version (y within
one bf16 ulp of its scale, the statistics within 1e-4) and must give the
same bits twice.  Exits 1 without a card or nvcc, or when one fails that
check.
"""

import contextlib
import ctypes
import os
import statistics
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from vst_tpu_torch.device import apply_precision  # noqa: E402
from vst_tpu_torch.kernels import _build, res_block  # noqa: E402

BODY = "conv3x3_wgmma.cuh"
COMMON = "res_block_common.cuh"
FILES = (BODY, COMMON, "conv3x3_tf32.cuh", "res_block.cu")
LIB = "res_block"
OUT = os.path.join(ROOT, "build", "k1_narrow_variants")
SHAPES = {"RTNSTV": (8, 90, 160, 48), "SD1/SD2": (8, 128, 128, 64)}
PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12
ULP = 2.0 ** -7


def variants():
    """name -> (list of (file, old, new) edits, whether the result is
    checked)."""
    return {
        "shipped": ([], True),
        "mt1": ([(BODY, "constexpr int m_blocks(int n) { return n <= 64 ? 2 "
                        ": 1; }", "constexpr int m_blocks(int n) { return "
                                  "n < 0 ? 2 : 1; }")], True),
        "prologue_launch": ([(COMMON, "  if (stats_in != nullptr && bf16 && "
                                      "wg::k1_narrow(c, co)) {",
                              "  if (stats_in != nullptr && bf16 && "
                              "wg::k1_narrow(c, co) && n < 0) {")], True),
        "staged": ([(BODY, "  return stats && n <= 64;\n",
                     "  return stats && n < 0;\n")], True),
        "no_mma": ([(BODY, "        const int nks = groups(0) / 2;\n",
                     "        const int nks = tl.n < 0 ? groups(0) / 2 : 0;"
                     "\n")], False),
        "no_loads": ([(BODY, "          cp_async16(dst + p * 16,",
                       "          if (tl.n < 0) cp_async16(dst + p * 16,")],
                     False),
        "no_epilogue": ([(BODY, "      // Epilogue.  acc[mb][4j + 2h + t]",
                          "      if (tl.n >= 0) continue;   // timing only\n"
                          "      // Epilogue.  acc[mb][4j + 2h + t]")],
                        False)}


def sources():
    """The shipped files a variant edits or copies: name -> text."""
    out = {}
    for f in FILES:
        with open(os.path.join(_build.CSRC, f)) as fh:
            out[f] = fh.read()
    return out


def apply(src, edits):
    """The files with the edits made, each checked to match exactly once."""
    texts = dict(src)
    for f, old, new in edits:
        if texts[f].count(old) != 1:
            raise ValueError(f"edit of {f} matches {texts[f].count(old)} "
                             f"times: {old[:60]!r}")
        texts[f] = texts[f].replace(old, new)
    return texts


def build(src):
    """Writes and builds every variant at once; returns name -> (CDLL,
    checked)."""
    nvcc = _build.find_nvcc()
    procs = {}
    for name, (edits, _) in variants().items():
        d = os.path.join(OUT, name)
        os.makedirs(d, exist_ok=True)
        for f, text in apply(src, edits).items():
            with open(os.path.join(d, f), "w") as out:
                out.write(text)
        so = os.path.join(d, f"lib{LIB}.so")
        procs[name] = (so, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-I", _build.CSRC, "-o", so,
             os.path.join(d, f"{LIB}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        lines = out.splitlines()
        for i, line in enumerate(lines):
            if ("Compiling entry" in line and "conv3x3_wgmma" in line
                    and ("Li48E" in line or "Li64E" in line)):
                spill = next(m for m in lines[i:] if "spill" in m).strip()
                used = next(m for m in lines[i:] if "Used" in m)
                print(f"  {name} {line.split(chr(39))[1][:52]}: "
                      f"{used.split(':', 1)[1].strip()}; {spill}", flush=True)
        libs[name] = (ctypes.CDLL(so), variants()[name][1])
    return libs


def _caches():
    return [getattr(res_block, n) for n in dir(res_block)
            if hasattr(getattr(res_block, n), "cache_clear")]


@contextlib.contextmanager
def loaded(lib):
    """The package's K1 wrapper calling the given library."""
    saved = _build._loaded.get(LIB)
    for c in _caches():
        c.cache_clear()
    _build._loaded[LIB] = lib
    try:
        yield
    finally:
        for c in _caches():
            c.cache_clear()
        if saved is None:
            _build._loaded.pop(LIB, None)
        else:
            _build._loaded[LIB] = saved


def event_ms(fn, reps=50, warmup=5):
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


def host_ms(fn, reps=200):
    """Host ms a call, no synchronization between the calls."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / reps


def device_ms(fn, reps=20):
    """(device ms a call: CUDA events around ``reps`` calls queued behind a
    sleep kernel of about 10 ms, so that the card runs them back to back
    whatever the host's pace; {kernel: ms a call} from torch.profiler over
    ``reps`` more calls)."""
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
    rows = {}
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
            if us > 0:
                rows[e.key[:40]] = us / 1e3 / reps
    return a.elapsed_time(b) / reps, rows


def inputs(g, shape):
    n, h, w, c = shape
    x = (torch.randn(shape, device="cuda", generator=g) * 3).bfloat16()
    wt = (torch.randn(3, 3, c, c, device="cuda", generator=g)
          * 0.02).bfloat16()
    b = (torch.randn(c, device="cuda", generator=g) * 0.02).bfloat16()
    gamma = torch.rand(c, device="cuda", generator=g) + 0.5
    beta = torch.randn(c, device="cuda", generator=g) * 0.1
    return x, wt, b, gamma, beta


def cases(g):
    """(label, shape, args without and with the prologue) per shape."""
    out = []
    for label, shape in SHAPES.items():
        x, wt, b, gamma, beta = inputs(g, shape)
        y, s = res_block.conv3x3_in_stats_plain(x, wt, b)
        out.append((f"{label} {shape}", shape, (x, wt, b)))
        out.append((f"{label} {shape} prologue", shape,
                    (y, wt, b, s, gamma, beta)))
    return out


def check(args):
    """(y error in bf16 ulps of the scale, stats error / 1e-4 of theirs,
    same bits twice)."""
    y, s = res_block.conv3x3_in_stats(*args)
    y2, s2 = res_block.conv3x3_in_stats(*args)
    yp, sp = res_block.conv3x3_in_stats_plain(*args)
    ey = ((y.float() - yp.float()).abs().max()
          / (ULP * yp.float().abs().max())).item()
    es = ((s - sp).abs().max() / (1e-4 * sp.abs().max())).item()
    return ey, es, torch.equal(y, y2) and torch.equal(s, s2)


def bare_call(args):
    """The ctypes call of the loaded library on buffers allocated once."""
    x, wt, b = args[:3]
    pro = args[3:] if len(args) > 3 else None
    n, h, wd, c = x.shape
    co = wt.shape[3]
    y = torch.empty((n, h, wd, co), dtype=x.dtype, device="cuda")
    stats = torch.empty((n, 2, co), dtype=torch.float32, device="cuda")
    work = torch.empty(res_block.work_floats(n, h, wd, c, co, True,
                                             pro is not None),
                       dtype=torch.float32, device="cuda")
    p = (None, None, None) if pro is None else tuple(
        t.data_ptr() for t in pro)
    stream = torch.cuda.current_stream().cuda_stream
    fn = res_block._kernel()
    call = (x.data_ptr(), wt.data_ptr(), b.data_ptr(), *p, 0, y.data_ptr(),
            stats.data_ptr(), work.data_ptr(), n, h, wd, c, co, 1,
            torch.cuda.current_device(), stream)
    keep = (y, stats, work)

    def run():
        assert keep and fn(*call) == 0
    return run


def cudnn_ms(x, wt, b):
    """cuDNN's F.conv2d of the same conv (reflect-padded input), benchmark
    mode, the faster of NCHW and channels_last."""
    xp = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
    w = wt.permute(3, 2, 0, 1)
    was = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        ms = {}
        for layout, fmt in (("NCHW", torch.contiguous_format),
                            ("channels_last", torch.channels_last)):
            xl, wl = (t.contiguous(memory_format=fmt) for t in (xp, w))
            ms[layout] = event_ms(lambda: F.conv2d(xl, wl, b))
    finally:
        torch.backends.cudnn.benchmark = was
    return min(ms.values()), ms


def bound_ms(shape, prologue):
    n, h, w, c = shape
    nbytes = (2 * n * h * w * c + 9 * c * c + c) * 2 + n * 2 * c * 4
    if prologue:
        nbytes += (n * 2 * c + 2 * c) * 4
    return max(2 * 9 * c * c * n * h * w / PEAK_FLOPS,
               nbytes / PEAK_BYTES) * 1e3


def main():
    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[k1 narrow variants] {smi}; torch {torch.__version__}",
          flush=True)
    t0 = time.perf_counter()
    libs = build(sources())
    print(f"  built {len(libs)} variants in {time.perf_counter() - t0:.1f} s",
          flush=True)
    apply_precision(torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(0)
    fails = 0
    names = list(libs)
    for label, shape, args in cases(g):
        call = (lambda a=args: res_block.conv3x3_in_stats(*a))
        for name, (lib, checked) in libs.items():
            if checked and name != "shipped":
                with loaded(lib):
                    e = check(args)
                fails += not (e[0] <= 1.0 and e[1] <= 1.0 and e[2])
                print(f"  {label}: {name} y {e[0]:.3f} ulp of scale, stats "
                      f"{e[1]:.3f} x 1e-4, same bits {e[2]}", flush=True)
        with loaded(libs["shipped"][0]):
            ey, es, same = check(args)
            fails += not (ey <= 1.0 and es <= 1.0 and same)
            full = args + (None,) * (6 - len(args))
            function = (lambda a=full: res_block.Conv3x3InStats.apply(
                *a, res_block._launch))
            launch = (lambda a=args: res_block._launch(*a))
            split = {"Function": host_ms(function), "wrapper": host_ms(call),
                     "_launch": host_ms(launch),
                     "ctypes": host_ms(bare_call(args))}
        print(f"  {label}: shipped y {ey:.3f} ulp of scale, stats "
              f"{es:.3f} x 1e-4, same bits {same}; host ms a call: "
              + ", ".join(f"{k} {v:.4f}" for k, v in split.items()),
              flush=True)
        res = {name: {"call": [], "device": [], "host": []} for name in names}
        kernels = {}
        for order in (names, names[::-1]):
            for name in order:
                with loaded(libs[name][0]):
                    res[name]["call"].append(event_ms(call))
                    dev, rows = device_ms(call)
                    res[name]["device"].append(dev)
                    res[name]["host"].append(host_ms(call))
                    kernels[name] = rows
        lib, both = cudnn_ms(*args[:3])
        bnd = bound_ms(shape, len(args) > 3)
        print(f"  {label}: bound {bnd:.4f} ms; cuDNN {lib:.4f} (NCHW "
              f"{both['NCHW']:.4f}, channels_last "
              f"{both['channels_last']:.4f})", flush=True)
        for name in names:
            r = {k: min(v) for k, v in res[name].items()}
            print(f"    {name:14s} call {r['call']:.4f}  device "
                  f"{r['device']:.4f} ({bnd / r['device']:.2f} of bound)  "
                  f"host {r['host']:.4f}  [{statistics.median(res[name]['call']):.4f}"
                  f" median call]  "
                  + ", ".join(f"{k} {v:.4f}" for k, v in
                              kernels[name].items()), flush=True)
    print(f"[k1 narrow variants] shipped {'FAILED' if fails else 'ok'}; {smi}")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
