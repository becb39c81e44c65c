#!/usr/bin/env python3
"""The float32 K1 and K2 (3xTF32 on wgmma, ``csrc/conv3x3_tf32.cuh``)
against variants that drop a part of their work, on one NVIDIA GPU:
accuracy against the float64 evaluation of the same conv, and times in
turns.

    python3 experiments/conv_f32_variants.py

Each variant is the shipped ``conv3x3_tf32.cuh`` with a few text edits
(each must apply exactly once), written with copies of ``res_block.cu``
and ``head_conv.cu`` into ``build/conv_f32_variants/<name>/`` (the header
beside the sources, where their include finds it first), built with the
package's nvcc flags, all ``nvcc``s at once, and called through the
package's own wrappers with the variant's libraries loaded in place of
the package's.

- ``shipped``: every (32-channel chunk, tap) stage in a fresh partial of
  3xTF32 products, added in float32.
- ``chain``: the products chained straight into the accumulators across
  the whole tile (the stages still wait for their multiply).
- Timing only (their results are not checked): ``one_tf32`` drops the
  small-part products (1xTF32: one tf32 product a stage and k8 step);
  ``no_epilogue`` skips the bias, the stores and the statistics after a
  tile's last stage (the accumulators stay live).

Accuracy cases: K1 (8, 128, 128, 192) -> 192 without and with its
prologue, K2's packed stem (8, 130, 130, 48) -> 768 and head 768 -> 48:
the largest error as a share of the output's scale against float64, the
plain float32 version's own, and whether a second launch gives the same
bits.  Times: CUDA events over 5 launches after 1 (the weights' pre-pass
included), each variant twice (in order, then in reverse), the minimum
printed with TFLOP/s.  Exits 1 without a card or nvcc, or when the shipped
kernel is further than 1e-4 from float64 or differs between two launches.
"""

import contextlib
import ctypes
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from vst_tpu_torch.device import apply_precision  # noqa: E402
from vst_tpu_torch.kernels import _build, head_conv, res_block  # noqa: E402

BODY = "conv3x3_tf32.cuh"
LIBS = ("res_block", "head_conv")
OUT = os.path.join(ROOT, "build", "conv_f32_variants")
TOL = 1e-4

SMALL = """        for (int ks = 0; ks < nks; ++ks) {   // small parts first
          wg::wgmma_tf32n<N>(part, da(ks, 1), db(ks, 0), ks > 0);
          wg::wgmma_tf32n<N>(part, da(ks, 0), db(ks, 1));
        }
"""
BIG = "          wg::wgmma_tf32n<N>(part, da(ks, 0), db(ks, 0));\n"
CHAIN = [
    (BODY, "wg::wgmma_tf32n<N>(part, da(ks, 1), db(ks, 0), ks > 0);",
     "wg::wgmma_tf32n<N>(acc, da(ks, 1), db(ks, 0));"),
    (BODY, "wg::wgmma_tf32n<N>(part, da(ks, 0), db(ks, 1));",
     "wg::wgmma_tf32n<N>(acc, da(ks, 0), db(ks, 1));"),
    (BODY, BIG, BIG.replace("(part,", "(acc,")),
    (BODY, "        wg::fence_acc(part);\n        wg::wgmma_fence();\n",
     "        wg::fence_acc(acc);\n        wg::wgmma_fence();\n"),
    (BODY, "        wg::wgmma_wait<0>();\n        wg::fence_acc(part);\n",
     "        wg::wgmma_wait<0>();\n        wg::fence_acc(acc);\n"),
    (BODY, "#pragma unroll\n        for (int k = 0; k < N / 2; ++k) acc[k] += "
           "part[k];\n", ""),
]


def variants():
    """name -> (list of (file, old, new) edits, whether the result is
    checked)."""
    return {
        "shipped": ([], True),
        "chain": (CHAIN, True),
        "one_tf32": ([(BODY, SMALL, ""),
                      (BODY, BIG, BIG.replace("));", "), ks > 0);"))], False),
        "no_epilogue": ([(BODY, "      gc += nch;\n",
                          "      gc += nch;\n      if (tl.n >= 0) continue;"
                          "   // no epilogue (timing only)\n")], False)}


def sources():
    """The shipped files a variant edits or copies: name -> text."""
    names = (BODY,) + tuple(f"{lib}.cu" for lib in LIBS)
    out = {}
    for f in names:
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
    """Writes and builds every variant at once; returns name -> ({library
    name: CDLL}, checked)."""
    nvcc = _build.find_nvcc()
    procs = {}
    for name, (edits, checked) in variants().items():
        d = os.path.join(OUT, name)
        os.makedirs(d, exist_ok=True)
        for f, text in apply(src, edits).items():
            with open(os.path.join(d, f), "w") as out:
                out.write(text)
        for lib in LIBS:
            so = os.path.join(d, f"lib{lib}.so")
            procs[(name, lib)] = (so, subprocess.Popen(
                [nvcc, *_build.NVCC_FLAGS, "-I", _build.CSRC, "-o", so,
                 os.path.join(d, f"{lib}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {name: ({}, checked) for name, (_, checked) in variants().items()}
    for (name, lib), (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name} {lib}:\n{out}")
        lines = out.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry" in line and "conv3x3_tf32" in line and (
                    "Li192E" in line or "Li48E" in line):
                spill = next(m for m in lines[i:] if "spill" in m).strip()
                used = next(m for m in lines[i:] if "Used" in m)
                print(f"  {name} {lib} {line.split(chr(39))[1][:48]}: "
                      f"{used.split(':', 1)[1].strip()}; {spill}", flush=True)
        libs[name][0][lib] = ctypes.CDLL(so)
    return libs


@contextlib.contextmanager
def loaded(libs):
    """The package's K1/K2 wrappers calling the given libraries."""
    saved = {lib: _build._loaded.get(lib) for lib in LIBS}
    caches = (res_block._kernel, res_block.partial_blocks,
              res_block.work_floats, head_conv._kernel,
              head_conv.weight_floats)
    for c in caches:
        c.cache_clear()
    _build._loaded.update(libs)
    try:
        yield
    finally:
        for c in caches:
            c.cache_clear()
        for lib, so in saved.items():
            if so is None:
                _build._loaded.pop(lib, None)
            else:
                _build._loaded[lib] = so


def rel(a, b):
    return ((a.double() - b.double()).abs().max()
            / b.double().abs().max()).item()


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


def cases(g):
    """(label, FLOPs, kernel call, plain evaluation in a given dtype) at the
    512² b8 ReCoNet shapes."""
    x = torch.randn(8, 128, 128, 192, device="cuda", generator=g) * 3
    w = torch.randn(3, 3, 192, 192, device="cuda", generator=g) * 0.02
    b = torch.randn(192, device="cuda", generator=g) * 0.02
    y, s = res_block.conv3x3_in_stats_plain(x, w, b)
    gamma = torch.rand(192, device="cuda", generator=g) + 0.5
    beta = torch.randn(192, device="cuda", generator=g) * 0.1
    out = []
    for label, args in (("K1", (x, w, b)), ("K1 prologue",
                                            (y, w, b, s, gamma, beta))):
        out.append((label, 2 * 9 * 192 * 192 * 8 * 128 * 128,
                    lambda a=args: res_block.conv3x3_in_stats(*a)[0],
                    lambda dt, a=args: res_block.conv3x3_in_stats_plain(
                        *(t.to(dt) for t in a))[0]))
    for label, c, co in (("K2 stem", 48, 768), ("K2 head", 768, 48)):
        xk = torch.randn(8, 130, 130, c, device="cuda", generator=g)
        wk = torch.randn(3, 3, c, co, device="cuda", generator=g) * 0.05
        out.append((label, 2 * 9 * c * co * 8 * 128 * 128,
                    lambda a=(xk, wk): head_conv.conv3x3_valid(*a),
                    lambda dt, a=(xk, wk): head_conv.conv3x3_valid_plain(
                        *(t.to(dt) for t in a))))
    return out


def main():
    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[conv f32 variants] {smi}", flush=True)
    libs = build(sources())
    apply_precision(torch.float32)
    g = torch.Generator(device="cuda").manual_seed(0)
    fails = 0
    todo = cases(g)
    for label, _, call, plain in todo:
        exact = plain(torch.float64)
        print(f"  {label}: plain float32 against float64 "
              f"{rel(plain(torch.float32), exact):.3e}", flush=True)
        for name, (built, checked) in libs.items():
            with loaded(built):
                out, again = call(), call()
            same = torch.equal(out, again)
            err = rel(out, exact)
            if name == "shipped":
                fails += not (same and err <= TOL)
            print(f"  {label}: {name} against float64 {err:.3e}; same bits "
                  f"{same}{'' if checked else ' (timing only)'}", flush=True)
            del out, again
        del exact
    names = list(libs)
    for label, flops, call, _ in todo:
        ms = {name: [] for name in names}
        for order in (names, names[::-1]):
            for name in order:
                with loaded(libs[name][0]):
                    ms[name].append(event_ms(call))
        print(f"  {label} ms per launch: " + ", ".join(
            f"{name} {min(t):.4f} ({flops / min(t) / 1e9:.1f} TFLOP/s)"
            for name, t in ms.items()), flush=True)
    print(f"[conv f32 variants] shipped {'FAILED' if fails else 'ok'}; {smi}")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
