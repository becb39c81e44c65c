#!/usr/bin/env python3
"""Design variants of the bf16 K3 (AdaAttN softmax attention moments) on
one NVIDIA GPU, timed in turns against the shipped kernel.

    python3 experiments/k3_variants.py

Each variant is the shipped source, ``vst_tpu_torch/kernels/csrc/
adaattn_fwd.cu``, with a few text edits (each must apply exactly once),
built with the package's nvcc flags into ``build/k3_variants/<name>/``,
all ``nvcc``s at once, and called through its C entry point.

- ``shipped``: the kernel as it is (Q/K ring 6 deep).
- ``ring4``, ``ring7``: the Q/K ring 4 or 7 stages deep.
- ``split_s``: S split over d between the two consumers and summed through
  a 16 KB float32 exchange (the body in ``k3_split_kernel.cu``), two Q/K
  rings of 3.
- ``pv_overlap``: consumer 0 leaves P V in flight under the next tile's S.
- ``eager_rescale``: every warp rescales its accumulators on every key
  tile (the shipped kernel skips a warp whose rows' factors are all 1).
- Timing only (their results are wrong, and not checked): ``no_q_reload``
  loads Q for the first key tile only (the L2 bytes of streaming Q);
  ``no_s``, ``no_pv``, ``no_pw``, ``no_products`` drop the S, P V, P W or
  all three products; ``no_square`` drops the V∘V pass; ``no_exp`` forms P
  without the exponential.

The variants that compute the function are held against the plain version
at four shapes (relu3_1's, a second value slice of 8 columns, d = 1480
with two slices, c under one chunk) to 2^-6 of each output's scale (L to
1e-5), and must give the same bits twice.  Times: CUDA events over 10
launches after 2, each variant twice (in order, then in reverse), at the
AdaAttN 512² batch-2 and 256² batch-8 level shapes; the minimum of the
two is printed with TFLOP/s on the least work 2·b·n²·(d + 2c).  Exits 1
without a card or nvcc, or when a checked variant fails.
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

SRC_PATH = os.path.join(_build.CSRC, "adaattn_fwd.cu")
OUT = os.path.join(ROOT, "build", "k3_variants")

S_WAIT = """        wg::wgmma_wait<1>();   // the stage before is done
        wg::fence_acc(s);
        if (t > 0 && lane == 0) wg::mbar_arrive(eq + 8 * ((g - 1) % RQ));
      }
      wg::wgmma_wait<0>();
      wg::fence_acc(s);
      if (lane == 0) wg::mbar_arrive(eq + 8 * ((g - 1) % RQ));
"""
PV = """      mma_p_slice(acc, pb + (j & 1) * CB, wg::smem_u32(ring_v + sv * SLOT_V));
"""
PV_WAIT = PV + """      wg::wgmma_commit();
      wg::wgmma_wait<0>();
      wg::fence_acc(acc);
      if (lane == 0) wg::mbar_arrive(ev + 8 * sv);
    }
"""
PW = "      mma_p_slice(acc, pb + (j & 1) * CB, wb);\n"
LAZY = """      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int i = 0; i < NV * 32; ++i) acc[i] *= alpha[(i >> 1) & 1];
      }
"""
EAGER = """#pragma unroll
      for (int i = 0; i < NV * 32; ++i) acc[i] *= alpha[(i >> 1) & 1];
"""
LAYOUT = """constexpr int OFF_V = RQ * SLOT_QK;
constexpr int OFF_W = OFF_V + RV * SLOT_V;      // W = V o V, consumer 1's
constexpr int OFF_P = OFF_W + SLOT_V;           // P, bf16, two buffers
constexpr int OFF_ROW = OFF_P + 2 * CB;         // rescale factors [2][T], 1/l [T]
constexpr int OFF_BAR = OFF_ROW + 3 * T * 4;
constexpr int NBAR = 2 * (RQ + RV);"""
RING = "constexpr int RQ = 6; "


def variants(src):
    """name -> (list of (old, new) edits, whether the result is checked)."""
    body = src[src.index("// Block (query tile, value slice, image)."):
               src.index("// -------------------------------------------------"
                         "--------------- float32")]
    split = open(os.path.join(os.path.dirname(__file__),
                              "k3_split_kernel.cu")).read()
    return {
        "shipped": ([], True),
        "ring4": ([(RING, "constexpr int RQ = 4; ")], True),
        "ring7": ([(RING, "constexpr int RQ = 7; ")], True),
        "split_s": ([(RING, "constexpr int RQ = 3; "),
                     (LAYOUT, LAYOUT.replace(
                         "OFF_V = RQ * SLOT_QK", "OFF_V = 2 * RQ * SLOT_QK")
                      .replace("OFF_ROW = OFF_P + 2 * CB",
                               "OFF_X = OFF_P + 2 * CB;\n"
                               "constexpr int OFF_ROW = OFF_X + T * T * 4")
                      .replace("NBAR = 2 * (RQ + RV)", "NBAR = 2 * (2 * RQ + RV)")),
                     (body, split)], True),
        "pv_overlap": ([(S_WAIT, S_WAIT.replace(
                            "        if (t > 0 && lane == 0) wg::mbar_arrive("
                            "eq + 8 * ((g - 1) % RQ));\n",
                            "        if (lane == 0) {\n"
                            "          if (t > 0) wg::mbar_arrive(eq + 8 * ((g - 1) % RQ));\n"
                            "          else if (j > 0) wg::mbar_arrive(ev + 8 * ((j - 1) % RV));\n"
                            "        }\n").replace(
                            "      wg::fence_acc(s);\n      if (lane == 0)",
                            "      wg::fence_acc(s);\n      wg::fence_acc(acc);\n"
                            "      if (lane == 0)")),
                        (PV_WAIT, PV + "      wg::wgmma_commit();\n"
                         "      wg::fence_acc(acc);\n    }\n"
                         "    wg::wgmma_wait<0>();\n    wg::fence_acc(acc);\n"
                         "    if (lane == 0) wg::mbar_arrive(ev + 8 * ((nkt - 1) % RV));\n")],
                       True),
        "eager_rescale": ([(LAZY + "      const int sv", EAGER + "      const int sv"),
                           (LAZY + "      wg::fence_acc", EAGER + "      wg::fence_acc")],
                          True),
        "no_q_reload": ([("          const int s = claim<RQ>(fq, eq, g, 2 * CB);",
                          "          const int s = claim<RQ>(fq, eq, g, j == 0 ? 2 * CB : CB);"),
                         ("          wg::tma_load_3d(dst, &mp.q,",
                          "          if (j == 0) wg::tma_load_3d(dst, &mp.q,")], False),
        "no_s": ([("        mma_xyt(s, b, b + CB);\n", "")], False),
        "no_pv": ([(PV, "")], False),
        "no_pw": ([(PW, "")], False),
        "no_products": ([("        mma_xyt(s, b, b + CB);\n", ""), (PV, ""), (PW, "")],
                        False),
        "no_square": ([("for (int r = 0; r < nv * (CB / 16 / 128); ++r) {",
                        "for (int r = 0; r < 0; ++r) {")], False),
        "no_exp": ([("exp2f(s[i] - mrow[h])", "(s[i] - mrow[h])"),
                    ("exp2f(s[i + 1] - mrow[h])", "(s[i + 1] - mrow[h])")], False),
    }


def build(src):
    """Writes and builds every variant at once; returns name -> (C entry
    point, checked)."""
    nvcc = _build.find_nvcc()
    procs = {}
    for name, (edits, checked) in variants(src).items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: edit does not apply once: {old[:60]!r}")
            text = text.replace(old, new)
        d = os.path.join(OUT, name)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "adaattn_fwd.cu"), "w") as f:
            f.write(text)
        lib = os.path.join(d, "libk3.so")
        procs[name] = (lib, checked, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-I", _build.CSRC, "-o", lib,
             os.path.join(d, "adaattn_fwd.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, checked, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        lines = out.splitlines()
        at = next(i for i, line in enumerate(lines)
                  if "Compiling entry" in line and "attn_fwd_bf16" in line)
        used = next(line for line in lines[at:] if "Used" in line)
        print(f"  {name}: bf16 kernel {used.split(':', 1)[1].strip()}",
              flush=True)
        fn = ctypes.CDLL(lib).vst_k3_attention_moments
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                       + [ctypes.c_longlong] * 3 + [ctypes.c_int, ctypes.c_void_p])
        fns[name] = (fn, checked)
    return fns


def launch(fn, q, k, v):
    b, n, d = q.shape
    m, c = k.shape[1], v.shape[2]
    m1 = torch.empty((b, n, c), dtype=q.dtype, device=q.device)
    m2 = torch.empty_like(m1)
    lse = torch.empty((b, n, 1), dtype=torch.float32, device=q.device)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), m1.data_ptr(),
            m2.data_ptr(), lse.data_ptr(), None, b, n, m, d, c, q.stride(0),
            k.stride(0), v.stride(0), 1, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"launch failed: CUDA error {rc}")
    return m1, m2, lse


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


def inputs(g, b, n, m, d, c):
    s = d ** -0.25
    return ((torch.randn(b, n, d, device="cuda", generator=g) * s).bfloat16(),
            (torch.randn(b, m, d, device="cuda", generator=g) * s).bfloat16(),
            torch.randn(b, m, c, device="cuda", generator=g).bfloat16())


def main():
    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[k3 variants] {smi}", flush=True)
    fns = build(open(SRC_PATH).read())
    apply_precision(torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(0)
    fails = 0
    for shape in [(2, 16384, 16384, 448, 256), (2, 200, 330, 520, 264),
                  (2, 130, 200, 1480, 512), (1, 128, 700, 48, 24)]:
        q, k, v = inputs(g, *shape)
        ref = adaattn_attention.softmax_attention_moments_plain(q, k, v)
        for name, (fn, checked) in fns.items():
            if not checked:
                continue
            out, again = launch(fn, q, k, v), launch(fn, q, k, v)
            err = [(o.float() - r.float()).abs().max().item()
                   / r.float().abs().max().item() for o, r in zip(out, ref)]
            same = all(torch.equal(a, b) for a, b in zip(out, again))
            ok = max(err[:2]) <= 2 ** -6 and err[2] <= 1e-5 and same
            fails += not ok
            print(f"  {name} {shape}: relative M1 {err[0]:.3e}, M2 {err[1]:.3e}, "
                  f"L {err[2]:.3e}, same bits {same}: {'ok' if ok else 'FAIL'}",
                  flush=True)
        del q, k, v, ref
    names = list(fns)
    for b, n, d, c in [(2, 16384, 448, 256), (2, 4096, 960, 512),
                       (2, 1024, 1472, 512), (8, 4096, 448, 256),
                       (8, 1024, 960, 512), (8, 256, 1472, 512)]:
        q, k, v = inputs(g, b, n, n, d, c)
        ms = {name: [] for name in names}
        for order in (names, names[::-1]):
            for name in order:
                ms[name].append(event_ms(lambda: launch(fns[name][0], q, k, v)))
        flops = 2 * b * n * n * (d + 2 * c)
        print(f"  (b={b}, n=m={n}, d={d}, c={c}) ms: " + ", ".join(
            f"{name} {min(t):.4f} ({flops / min(t) / 1e9:.0f} TFLOP/s)"
            for name, t in ms.items()), flush=True)
        del q, k, v
    print(f"[k3 variants] {fails} checked variant(s) failed; {smi}")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
