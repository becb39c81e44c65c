#!/usr/bin/env python3
"""The float32 K5 (3xTF32 on wgmma) against variants that sum on the
tensor core without its fresh partial sums, on one NVIDIA GPU: accuracy
against the plain version and against the float64 evaluation of the same
formulas, and times in turns.

    python3 experiments/k5_f32_variants.py

Each variant is the shipped source, ``vst_tpu_torch/kernels/csrc/
adaattn_bwd.cu`` and the ``attn_common.cuh`` it includes (whose 3xTF32
phase it shares with the f32 K3), with a few text edits (each must apply
exactly once), written into ``build/k5_f32_variants/<name>/`` (the
header beside the source, where its include finds it first) and built
with the package's nvcc flags, all ``nvcc``s at once, and called through
its C entry point.

- ``shipped``: every 32-column stage of S^T and dA^T, and every output
  chunk of a query tile, is summed into a fresh partial that the consumer
  adds in float32.
- ``chain_s``: S^T and dA^T as one wgmma chain per tile into the
  accumulator (no partials in the first phase).
- ``chain_out``: dK and dV as one wgmma chain per output chunk over all
  query tiles (no partials in the output products).
- ``chain_both``: both.

Cases: relu3_1's training shape (8, 4096, 4096, 448, 256) with scores of
std 1 and 10, and (2, 200, 330, 448, 256) with q, k × 10 (scores of std
100, the card test's sharp case).  For each: dK and dV's largest error as
a share of the output's scale against the plain version (float32) and
against the float64 evaluation, the plain version's own against float64,
and whether a second launch gives the same bits.  Times: CUDA events over
5 launches after 1, each variant twice (in order, then in reverse), at
the three AdaAttN 256² batch-8 training levels; the minimum is printed.
Exits 1 without a card or nvcc, or when the shipped kernel is further
than 1e-4 from float64, or than 1e-4 from the plain version at scores of
std up to 10, or differs between two launches.
"""

import ctypes
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from vst_tpu_torch.device import apply_precision  # noqa: E402
from vst_tpu_torch.kernels import _build, adaattn_attention  # noqa: E402

SOURCES = ("adaattn_bwd.cu", "attn_common.cuh")   # the files the edits touch
OUT = os.path.join(ROOT, "build", "k5_f32_variants")

STAGE_FIRST = "kmajor(b + 2 * FB, ks), ks > 0);"
PHASE1 = """    stage_tf32(part, wg::smem_u32(ring + slot * FSTAGE));
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    wg::fence_acc(part);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] += part[i];
"""
PHASE1_CHAIN = """    stage_tf32(acc, wg::smem_u32(ring + slot * FSTAGE));
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    wg::fence_acc(acc);
"""
OUT_PART = "      float part[32];\n      wg::fence_acc(part);"
OUT_FIRST = "kmajor(b, ks), kh + ks > 0);"
OUT_ADD = "#pragma unroll\n      for (int i = 0; i < 32; ++i) acc[h][i] += part[i];\n"
CHAIN_S = [("attn_common.cuh", STAGE_FIRST, "kmajor(b + 2 * FB, ks));"),
           ("attn_common.cuh", PHASE1, PHASE1_CHAIN)]
CHAIN_OUT = [("adaattn_bwd.cu", OUT_PART,
              "      float (&part)[32] = acc[h];\n      wg::fence_acc(part);"),
             ("adaattn_bwd.cu", OUT_FIRST, "kmajor(b, ks));"),
             ("adaattn_bwd.cu", OUT_ADD, "")]
TOL = 1e-4


def variants():
    """name -> list of (file, old, new) edits."""
    return {"shipped": [], "chain_s": CHAIN_S, "chain_out": CHAIN_OUT,
            "chain_both": CHAIN_S + CHAIN_OUT}


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
    """Writes and builds every variant at once; returns name -> (K5 entry
    point, scratch-size entry point)."""
    nvcc = _build.find_nvcc()
    procs = {}
    for name, edits in variants().items():
        d = os.path.join(OUT, name)
        os.makedirs(d, exist_ok=True)
        for f, text in apply(src, edits).items():
            with open(os.path.join(d, f), "w") as out:
                out.write(text)
        lib = os.path.join(d, "libk5.so")
        procs[name] = (lib, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-I", _build.CSRC, "-o", lib,
             os.path.join(d, "adaattn_bwd.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        lines = out.splitlines()
        at = next(i for i, line in enumerate(lines)
                  if "Compiling entry" in line and "attn_dkv_tf32" in line)
        spill = next(line for line in lines[at:] if "spill" in line).strip()
        used = next(line for line in lines[at:] if "Used" in line)
        print(f"  {name}: attn_dkv_tf32 {used.split(':', 1)[1].strip()}; "
              f"{spill}", flush=True)
        so = ctypes.CDLL(lib)
        fn = so.vst_k5_attention_dkv
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                       + [ctypes.c_longlong] * 3 + [ctypes.c_int, ctypes.c_void_p])
        floats = so.vst_k5_scratch_floats
        floats.argtypes = [ctypes.c_int] * 5 + [ctypes.c_longlong] * 3
        floats.restype = ctypes.c_longlong
        fns[name] = (fn, floats)
    return fns


def launch(entry, q, k, v, lse, dd, dm1, dm2):
    fn, floats = entry
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
        raise RuntimeError(f"launch failed: CUDA error {rc}")
    return dk, dv


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
    """Scores of std ``std``; cotangents as the card test's (dM2 × 0.1)."""
    s = std ** 0.5 / d ** 0.25
    q = torch.randn(b, n, d, device="cuda", generator=g) * s
    k = torch.randn(b, m, d, device="cuda", generator=g) * s
    v = torch.randn(b, m, c, device="cuda", generator=g)
    m1, m2, lse = adaattn_attention.softmax_attention_moments_plain(q, k, v)
    dm1 = torch.randn(b, n, c, device="cuda", generator=g)
    dm2 = torch.randn(b, n, c, device="cuda", generator=g) * 0.1
    return q, k, v, lse, adaattn_attention.row_term(m1, m2, dm1, dm2), dm1, dm2


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
    print(f"[k5 f32 variants] {smi}", flush=True)
    fns = build(sources())
    apply_precision(torch.float32)
    g = torch.Generator(device="cuda").manual_seed(0)
    fails = 0
    for shape, std in [((8, 4096, 4096, 448, 256), 1.0),
                       ((8, 4096, 4096, 448, 256), 10.0),
                       ((2, 200, 330, 448, 256), 100.0)]:
        args = inputs(g, *shape, std)
        q, k, v, lse, dd, dm1, dm2 = args
        plain = adaattn_attention.softmax_attention_dkv_plain(*args)
        exact = adaattn_attention.softmax_attention_dkv_plain(
            q.double(), k.double(), v.double(), lse, dd, dm1.double(),
            dm2.double())
        print(f"  {shape} std {std:g}: plain float32 against float64 dK "
              f"{rel(plain[0], exact[0]):.3e}, dV {rel(plain[1], exact[1]):.3e}",
              flush=True)
        for name, entry in fns.items():
            out, again = launch(entry, *args), launch(entry, *args)
            same = all(torch.equal(a, b) for a, b in zip(out, again))
            ep = [rel(o, p) for o, p in zip(out, plain)]
            ex = [rel(o, e) for o, e in zip(out, exact)]
            if name == "shipped":
                fails += not (same and max(ex) <= TOL
                              and (std > 10.0 or max(ep) <= TOL))
            print(f"    {name}: against plain dK {ep[0]:.3e}, dV {ep[1]:.3e}; "
                  f"against float64 dK {ex[0]:.3e}, dV {ex[1]:.3e}; same bits "
                  f"{same}", flush=True)
        del args, q, k, v, lse, dd, dm1, dm2, plain, exact
    names = list(fns)
    for n, d, c in [(4096, 448, 256), (1024, 960, 512), (256, 1472, 512)]:
        args = inputs(g, 8, n, n, d, c, 1.0)
        ms = {name: [] for name in names}
        for order in (names, names[::-1]):
            for name in order:
                ms[name].append(event_ms(lambda: launch(fns[name], *args)))
        print(f"  (b=8, n=m={n}, d={d}, c={c}) ms: " + ", ".join(
            f"{name} {min(t):.4f}" for name, t in ms.items()), flush=True)
        del args
    print(f"[k5 f32 variants] shipped {'FAILED' if fails else 'ok'}; {smi}")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
