#!/usr/bin/env python3
"""The float32 K3 (3xTF32 on wgmma) against variants that sum on the
tensor core without its fresh partial sums, and timing-only variants with
a part of its work or bytes removed, on one NVIDIA GPU: accuracy against
the float64 evaluation of the same formulas, and times in turns.

    python3 experiments/k3_f32_variants.py

Each variant is the shipped source, ``vst_tpu_torch/kernels/csrc/
adaattn_fwd.cu`` and the ``attn_common.cuh`` it includes (whose 3xTF32
phase it shares with the f32 K5), with a few text edits (each must apply
exactly once), written into ``build/k3_f32_variants/<name>/`` (the header
beside the source, where its include finds it first) and built with the
package's nvcc flags, all ``nvcc``s at once, and called through its C
entry point.

- ``shipped``: S summed per 32-column stage of d, and P·V and P·W per
  (key tile, 64-column chunk), in fresh partials added in float32.
- ``chain_pv``: P·V and P·W chained across the key tiles straight into
  the accumulators, as the bf16 body does (M = M·α, then wgmma into M).
- ``chain_s``: S as one wgmma chain over d per key tile.
- ``chain_both``: both.
- Timing only (their results are wrong, and not checked):
  ``no_q_reload`` loads Q for the first key tile only (the L2 bytes of
  streaming Q's parts every tile); ``no_s`` and ``no_pv`` drop the S or
  the P·V / P·W products (the barriers and loads stay).

Accuracy cases: relu3_1's training shape (8, 4096, 4096, 448, 256) with
scores of std 1, 10 and 100: M1, M2 and L's largest error as a share of
the output's scale against the float64 evaluation, the plain float32
version's own, and whether a second launch gives the same bits.  Times:
CUDA events over 5 launches after 1 (pre-pass included), each variant
twice (in order, then in reverse), at the three AdaAttN 256² batch-8
training levels; the minimum is printed with TFLOP/s on the least work
2·b·n²·(d + 2c).  Exits 1 without a card or nvcc, or when the shipped
kernel is further than 1e-4 (L 1e-5) from float64 or differs between two
launches.
"""

import ctypes
import importlib.util
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from vst_tpu_torch.device import apply_precision  # noqa: E402
from vst_tpu_torch.kernels import _build, adaattn_attention  # noqa: E402

SOURCES = ("adaattn_fwd.cu", "attn_common.cuh")   # the files the edits touch
OUT = os.path.join(ROOT, "build", "k3_f32_variants")
FWD = "adaattn_fwd.cu"


def _k5_variants():
    spec = importlib.util.spec_from_file_location(
        "k5_f32_variants", os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "k5_f32_variants.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


CHAIN_S = _k5_variants().CHAIN_S   # phase1_tf32 without its partials
PV_PART = "      float part[32];\n      wg::fence_acc(part);\n      wg::wgmma_fence();"
PV_FIRST = "kmajor(b, ks), kh + ks > 0);"
PV_ADD = "#pragma unroll\n      for (int i = 0; i < 32; ++i) acc[h][i] += part[i];\n"
CHAIN_PV = [(FWD, PV_PART, PV_PART.replace("float part[32];",
                                           "float (&part)[32] = acc[h];")),
            (FWD, PV_FIRST, "kmajor(b, ks));"), (FWD, PV_ADD, "")]
PV_SMALL = """          wg::wgmma_tf32(part, kmajor(a + FB, ks), kmajor(b, ks), kh + ks > 0);
          wg::wgmma_tf32(part, kmajor(a, ks), kmajor(b + FB, ks));
"""
PV_BIG = "          wg::wgmma_tf32(part, kmajor(a, ks), kmajor(b, ks));\n"
Q_LOAD = """          const int s = claim<FRQ>(fq, eq, g, FSTAGE);
          load_stage(wg::smem_u32(ring_qk + s * FSTAGE), fq + 8 * s, &mp.q,
                     mp.pq, q0, &mp.k, mp.pk, T * j, FW * t, bi);
"""
K_ONLY = """          const int s = claim<FRQ>(fq, eq, g, j == 0 ? FSTAGE : 2 * FB);
          const unsigned dst = wg::smem_u32(ring_qk + s * FSTAGE);
          if (j == 0)
            load_stage(dst, fq + 8 * s, &mp.q, mp.pq, q0, &mp.k, mp.pk, 0,
                       FW * t, bi);
          else
            for (int p = 0; p < 2; ++p)
              wg::tma_load_3d(dst + (2 + p) * FB, &mp.k, FW * t, T * j,
                              plane(p, mp.pk, bi), fq + 8 * s);
"""
S_STAGE = "    stage_tf32(part, wg::smem_u32(ring + slot * FSTAGE));\n"
S_ZERO = "#pragma unroll\n    for (int i = 0; i < 32; ++i) part[i] = 0.f;\n"
COMMON = "attn_common.cuh"


def variants():
    """name -> (list of (file, old, new) edits, whether the result is
    checked)."""
    return {"shipped": ([], True), "chain_pv": (CHAIN_PV, True),
            "chain_s": (CHAIN_S, True), "chain_both": (CHAIN_S + CHAIN_PV, True),
            "no_q_reload": ([(FWD, Q_LOAD, K_ONLY)], False),
            "no_s": ([(COMMON, S_STAGE, S_ZERO)], False),
            "no_pv": ([(FWD, PV_SMALL, ""), (FWD, PV_BIG, "          ;\n")],
                      False)}


def sources():
    """file name -> the shipped text of each file the edits touch."""
    return {f: open(os.path.join(_build.CSRC, f)).read() for f in SOURCES}


def apply(src, edits):
    """The texts of ``src`` (file name -> text) with ``edits`` applied; an
    edit that does not match exactly once raises."""
    texts = dict(src)
    for f, old, new in edits:
        if texts[f].count(old) != 1:
            raise RuntimeError(f"{f}: edit does not apply once: {old[:60]!r}")
        texts[f] = texts[f].replace(old, new)
    return texts


def build(src):
    """Writes and builds every variant at once; returns name -> (K3 entry
    point, scratch-size entry point, checked)."""
    nvcc = _build.find_nvcc()
    procs = {}
    for name, (edits, checked) in variants().items():
        d = os.path.join(OUT, name)
        os.makedirs(d, exist_ok=True)
        for f, text in apply(src, edits).items():
            with open(os.path.join(d, f), "w") as out:
                out.write(text)
        lib = os.path.join(d, "libk3.so")
        procs[name] = (lib, checked, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-I", _build.CSRC, "-o", lib,
             os.path.join(d, FWD)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, checked, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        lines = out.splitlines()
        at = next(i for i, line in enumerate(lines)
                  if "Compiling entry" in line and "attn_fwd_tf32" in line)
        spill = next(line for line in lines[at:] if "spill" in line).strip()
        used = next(line for line in lines[at:] if "Used" in line)
        print(f"  {name}: attn_fwd_tf32 {used.split(':', 1)[1].strip()}; "
              f"{spill}", flush=True)
        so = ctypes.CDLL(lib)
        fn = so.vst_k3_attention_moments
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                       + [ctypes.c_longlong] * 3 + [ctypes.c_int, ctypes.c_void_p])
        floats = so.vst_k3_scratch_floats
        floats.argtypes = [ctypes.c_int] * 5 + [ctypes.c_longlong] * 3
        floats.restype = ctypes.c_longlong
        fns[name] = (fn, floats, checked)
    return fns


def launch(entry, q, k, v):
    fn, floats, _ = entry
    b, n, d = q.shape
    m, c = k.shape[1], v.shape[2]
    strides = (q.stride(0), k.stride(0), v.stride(0))
    m1 = torch.empty((b, n, c), device=q.device)
    m2 = torch.empty_like(m1)
    lse = torch.empty((b, n, 1), device=q.device)
    scratch = torch.empty(floats(b, n, m, d, c, *strides), device=q.device)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), m1.data_ptr(),
            m2.data_ptr(), lse.data_ptr(), scratch.data_ptr(), b, n, m, d, c,
            *strides, 0, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"launch failed: CUDA error {rc}")
    return m1, m2, lse


def event_ms(fn, reps=5, warmup=1):
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


def inputs(g, b, n, m, d, c, std):
    s = std ** 0.5 / d ** 0.25
    return (torch.randn(b, n, d, device="cuda", generator=g) * s,
            torch.randn(b, m, d, device="cuda", generator=g) * s,
            torch.randn(b, m, c, device="cuda", generator=g))


def rel(a, b):
    return ((a.double() - b.double()).abs().max()
            / b.double().abs().max()).item()


def main():
    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[k3 f32 variants] {smi}", flush=True)
    fns = build(sources())
    apply_precision(torch.float32)
    g = torch.Generator(device="cuda").manual_seed(0)
    fails = 0
    for std in (1.0, 10.0, 100.0):
        shape = (8, 4096, 4096, 448, 256)
        q, k, v = inputs(g, *shape, std)
        exact = adaattn_attention.softmax_attention_moments_plain(
            q.double(), k.double(), v.double())
        plain = adaattn_attention.softmax_attention_moments_plain(q, k, v)
        errs = ", ".join(f"{t} {rel(o, e):.3e}"
                         for t, o, e in zip(("M1", "M2", "L"), plain, exact))
        print(f"  {shape} std {std:g}: plain float32 against float64 {errs}",
              flush=True)
        for name, entry in fns.items():
            if not entry[2]:
                continue
            out, again = launch(entry, q, k, v), launch(entry, q, k, v)
            same = all(torch.equal(a, b) for a, b in zip(out, again))
            ex = [rel(o, e) for o, e in zip(out, exact)]
            if name == "shipped":
                fails += not (same and max(ex[:2]) <= 1e-4 and ex[2] <= 1e-5)
            print(f"    {name}: against float64 M1 {ex[0]:.3e}, M2 {ex[1]:.3e}"
                  f", L {ex[2]:.3e}; same bits {same}", flush=True)
        del q, k, v, exact, plain
    names = list(fns)
    for n, d, c in [(4096, 448, 256), (1024, 960, 512), (256, 1472, 512)]:
        q, k, v = inputs(g, 8, n, n, d, c, 1.0)
        ms = {name: [] for name in names}
        for order in (names, names[::-1]):
            for name in order:
                ms[name].append(event_ms(lambda: launch(fns[name], q, k, v)))
        flops = 2 * 8 * n * n * (d + 2 * c)
        print(f"  (b=8, n=m={n}, d={d}, c={c}) ms (TFLOP/s on the least): "
              + ", ".join(f"{name} {min(t):.4f} ({flops / min(t) / 1e9:.1f})"
                          for name, t in ms.items()), flush=True)
        del q, k, v
    print(f"[k3 f32 variants] shipped {'FAILED' if fails else 'ok'}; {smi}")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
