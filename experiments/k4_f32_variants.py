#!/usr/bin/env python3
"""The float32 K4 (dQ, 3xTF32 on wgmma) against variants that sum on the
tensor core without its fresh partial sums, and timing-only variants with
a phase removed, on one NVIDIA GPU: accuracy against the float64
evaluation of the same formulas, and times in turns.

    python3 experiments/k4_f32_variants.py

Each variant is the shipped source, ``vst_tpu_torch/kernels/csrc/
adaattn_bwd.cu`` and the ``attn_common.cuh`` it includes (whose 3xTF32
phase it shares with the f32 K3 and K5), with a few text edits (each must
apply exactly once), written into ``build/k4_f32_variants/<name>/`` (the
header beside the source, where its include finds it first) and built
with the package's nvcc flags, all ``nvcc``s at once, and called through
its C entry point.

- ``shipped``: S summed per 32-column stage of d, dA per (dM1, V) and
  (dM2, W) stage of 32 columns of c, and dS·K per (key tile, 64-column
  chunk), in fresh partials added in float32.
- ``chain_s``: S and dA as one wgmma chain per key tile.
- ``chain_dq``: dS·K chained across the key tiles straight into the
  accumulators.
- ``chain_both``: both.
- Timing only (their results are wrong, and not checked): ``no_s`` drops
  consumer 0's S products and ``no_da`` consumer 1's dA products (the
  ring is still loaded, waited on and released), ``no_dq`` the dS·K
  products (the K^T ring, the barriers and the drains stay).

Accuracy cases: relu3_1's training shape (8, 4096, 4096, 448, 256) with
scores of std 1, 10 and 100: dQ's largest error as a share of its scale
against the float64 evaluation, the plain float32 version's own, and
whether a second launch gives the same bits.  Times: CUDA events over 5
launches after 1 (pre-pass included), each variant twice (in order, then
in reverse), at the three AdaAttN 256² batch-8 training levels; the
minimum is printed with TFLOP/s on the least work 4·b·n²·(d + c).  Exits
1 without a card or nvcc, or when the shipped kernel is further than
1e-4 from float64 or differs between two launches.
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

BWD = "adaattn_bwd.cu"
OUT = os.path.join(ROOT, "build", "k4_f32_variants")


def _k5_variants():
    spec = importlib.util.spec_from_file_location(
        "k5_f32_variants", os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "k5_f32_variants.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


K5V = _k5_variants()
CHAIN_S = K5V.CHAIN_S       # phase1_tf32 without its partials
CHAIN_DQ = K5V.CHAIN_OUT    # phase2_tf32 (K4's and K5's) without its partials
S_CALL = "      phase1_tf32<FR0>(s, sm.ring0, sm.f0, sm.e0, g, nd, lane);\n"
DA_CALL = "      phase1_tf32<FR1>(s, sm.ring1, sm.f1, sm.e1, g, 2 * nc, lane);\n"


def _wait_only(ring, count):
    """Consumer ``ring``'s phase 1 without its products: s = 0, and each
    of its ``count`` stages waited for and released."""
    return f"""      {{   // no products: each stage is waited for and released
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = 0.f;
        for (int t = 0; t < {count}; ++t, ++g) {{
          wg::mbar_wait(sm.f{ring} + 8 * (g % FR{ring}), (g / FR{ring}) & 1);
          if (lane == 0) wg::mbar_arrive(sm.e{ring} + 8 * (g % FR{ring}));
        }}
      }}
"""


DQ_SMALL = """          wg::wgmma_tf32(part, kmajor(a + FB, ks), kmajor(b, ks), kh + ks > 0);
          wg::wgmma_tf32(part, kmajor(a, ks), kmajor(b + FB, ks));
"""
DQ_BIG = "          wg::wgmma_tf32(part, kmajor(a, ks), kmajor(b, ks));\n"
TOL = 1e-4


def variants():
    """name -> (list of (file, old, new) edits, whether the result is
    checked)."""
    return {"shipped": ([], True), "chain_s": (CHAIN_S, True),
            "chain_dq": (CHAIN_DQ, True),
            "chain_both": (CHAIN_S + CHAIN_DQ, True),
            "no_s": ([(BWD, S_CALL, _wait_only(0, "nd"))], False),
            "no_da": ([(BWD, DA_CALL, _wait_only(1, "2 * nc"))], False),
            "no_dq": ([(BWD, DQ_SMALL, ""), (BWD, DQ_BIG, "          ;\n")],
                      False)}


sources = K5V.sources   # the same two files
apply = K5V.apply


def build(src):
    """Writes and builds every variant at once; returns name -> (K4 entry
    point, scratch-size entry point, checked)."""
    nvcc = _build.find_nvcc()
    procs = {}
    for name, (edits, checked) in variants().items():
        d = os.path.join(OUT, name)
        os.makedirs(d, exist_ok=True)
        for f, text in apply(src, edits).items():
            with open(os.path.join(d, f), "w") as out:
                out.write(text)
        lib = os.path.join(d, "libk4.so")
        procs[name] = (lib, checked, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-I", _build.CSRC, "-o", lib,
             os.path.join(d, BWD)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, checked, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        lines = out.splitlines()
        at = next(i for i, line in enumerate(lines)
                  if "Compiling entry" in line and "attn_dq_tf32" in line)
        spill = next(line for line in lines[at:] if "spill" in line).strip()
        used = next(line for line in lines[at:] if "Used" in line)
        print(f"  {name}: attn_dq_tf32 {used.split(':', 1)[1].strip()}; "
              f"{spill}", flush=True)
        so = ctypes.CDLL(lib)
        fn = so.vst_k4_attention_dq
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                       + [ctypes.c_longlong] * 3 + [ctypes.c_int, ctypes.c_void_p])
        floats = so.vst_k4_scratch_floats
        floats.argtypes = [ctypes.c_int] * 5 + [ctypes.c_longlong] * 3
        floats.restype = ctypes.c_longlong
        fns[name] = (fn, floats, checked)
    return fns


def launch(entry, q, k, v, lse, dd, dm1, dm2):
    fn, floats, _ = entry
    b, n, d = q.shape
    m, c = k.shape[1], v.shape[2]
    strides = (q.stride(0), k.stride(0), v.stride(0))
    dq = torch.empty((b, n, d), device=q.device)
    scratch = torch.empty(floats(b, n, m, d, c, *strides), device=q.device)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dm1.data_ptr(),
            dm2.data_ptr(), lse.data_ptr(), dd.data_ptr(), dq.data_ptr(),
            scratch.data_ptr(), b, n, m, d, c, *strides, 0,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"launch failed: CUDA error {rc}")
    return dq


def main():
    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[k4 f32 variants] {smi}", flush=True)
    fns = build(sources())
    apply_precision(torch.float32)
    g = torch.Generator(device="cuda").manual_seed(0)
    fails = 0
    shape = (8, 4096, 4096, 448, 256)
    for std in (1.0, 10.0, 100.0):
        args = K5V.inputs(g, *shape, std)
        q, k, v, lse, dd, dm1, dm2 = args
        exact = adaattn_attention.softmax_attention_dq_plain(
            q.double(), k.double(), v.double(), lse, dd, dm1.double(),
            dm2.double())
        plain = adaattn_attention.softmax_attention_dq_plain(*args)
        print(f"  {shape} std {std:g}: plain float32 against float64 dQ "
              f"{K5V.rel(plain, exact):.3e}", flush=True)
        for name, entry in fns.items():
            if not entry[2]:
                continue
            out, again = launch(entry, *args), launch(entry, *args)
            same = torch.equal(out, again)
            err = K5V.rel(out, exact)
            if name == "shipped":
                fails += not (same and err <= TOL)
            print(f"    {name}: against float64 dQ {err:.3e}; same bits "
                  f"{same}", flush=True)
        del args, q, k, v, lse, dd, dm1, dm2, plain, exact
    names = list(fns)
    for n, d, c in [(4096, 448, 256), (1024, 960, 512), (256, 1472, 512)]:
        args = K5V.inputs(g, 8, n, n, d, c, 1.0)
        ms = {name: [] for name in names}
        for order in (names, names[::-1]):
            for name in order:
                ms[name].append(K5V.event_ms(lambda: launch(fns[name], *args)))
        flops = 8 * 4 * n * n * (d + c)
        print(f"  (b=8, n=m={n}, d={d}, c={c}) ms: " + ", ".join(
            f"{name} {min(t):.4f} ({flops / min(t) / 1e9:.1f} TFLOP/s)"
            for name, t in ms.items()), flush=True)
        del args
    print(f"[k4 f32 variants] shipped {'FAILED' if fails else 'ok'}; {smi}")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
