#!/usr/bin/env python3
"""The float32 (3xTF32) K1 at narrow residual widths (RTNSTV's 48
channels, SD1/SD2's 64) against variants that drop or change one part of
its design, on one NVIDIA GPU: what a call costs on the host and on the
device, how far each variant is from the float64 evaluation, and what each
part is worth on its own.

    python3 experiments/k1_f32_narrow_variants.py [variant ...]

(every variant when none is named).

Each variant is the shipped ``conv3x3_tf32_narrow.cuh`` (the narrow body),
``conv3x3_tf32.cuh`` (the wide float32 body) or ``res_block_common.cuh``
with a few text edits (each must apply exactly once), written with copies
of the others and of ``res_block.cu`` into
``build/k1_f32_narrow_variants/<name>/`` (the headers beside the source,
where its includes find them first), built with the package's nvcc flags,
all ``nvcc``s at once, and called through the package's own wrapper with
the variant's library loaded in place of the package's.

- ``narrow``: the narrow body as it is: 16 x 16-pixel tiles (two 64-row
  GEMM blocks a consumer warpgroup), so each weight stage feeds 256
  pixels; the prologue's parameters derived by the halo threads; then
  ``finalize_stats`` over one partial sum per tile: three launches a call
  with ``split_tf32``.
- ``narrow_two_chains``: each block's stage in two independent chains of
  products (small terms, big terms), four chains a consumer.
- ``narrow_wait1``: two partial sets, stage q + 1 issued before stage q
  is waited for (``wgmma_wait<1>``) and added.
- ``narrow_mt1``: the narrow body on 8 x 16-pixel tiles.
- ``wide``: K1 at these widths on the wide body (the body before the
  narrow one): 8 x 16-pixel tiles, every (chunk, tap) stage waited for
  (``wgmma_wait<0>``), added and released before the next is issued;
  ``split_tf32``, ``prologue_params`` and ``finalize_stats`` launches
  beside the conv.  The ``wide_*`` variants edit it:
- ``wide_wait1``: two partial register sets, the next stage issued before
  the previous one is waited for (``wgmma_wait<1>``) and added.
- ``wide_tap``: one stage per tap over all C (the chunks' products of a
  tap into one fresh partial, tap-major), each still waited for.
- Timing only (their results are not checked): ``*_no_mma`` issues no
  product; ``*_no_loads`` stages no halo (the rings' waits stay);
  ``wide_no_split`` skips the prologue and the split of the staged halo;
  ``*_no_epilogue`` skips the bias, the stores and the statistics after a
  tile's last stage (the wide body only: in the narrow one ptxas then
  drops or serializes the products); ``narrow_no_weights`` hands the weight stages over
  without loading them, ``narrow_no_halo`` the halos without loading or
  splitting them; ``narrow_only_weights`` and ``narrow_only_halo`` keep
  only that part (no products, no epilogue, not the other part), and
  ``narrow_skeleton`` neither: the handshakes alone.

At (8, 90, 160, 48) and (8, 128, 128, 64), without and with the
prologue, each variant reports:
- the call's time: CUDA events around 50 back-to-back wrapper calls;
- the device time a call: CUDA events around 20 calls queued behind a
  sleep kernel, so that the card runs them back to back, and beside it
  torch.profiler's time of each kernel the call launches over 20 more;
- the host time a call: ``time.perf_counter`` over 200 calls with no
  synchronization between them.
Each variant is timed twice (in order, then in reverse) and the minimum
printed.  Beside them: cuDNN's ``F.conv2d`` of the same conv in float32,
TF32 off, in benchmark mode (the faster of NCHW and channels_last), and
the bound (each input read once, each output written once, over 3.35
TB/s; the FLOPs over 3xTF32's 495 / 3 TFLOP/s).  Every checked variant is
held against the plain version and against the float64 evaluation of the
same inputs (y and the statistics within 1e-4 of their scale; the errors
are printed as fractions of that scale) and must give the same bits
twice.  Exits 1 without a card or nvcc, or when a checked variant fails
that check.
"""

import ctypes
import os
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)
sys.path.insert(0, HERE)

import k1_narrow_variants as kn  # noqa: E402
from vst_tpu_torch.device import apply_precision  # noqa: E402
from vst_tpu_torch.kernels import _build, res_block  # noqa: E402

NARROW = "conv3x3_tf32_narrow.cuh"
WIDE = "conv3x3_tf32.cuh"
COMMON = "res_block_common.cuh"
FILES = (NARROW, WIDE, COMMON, "res_block.cu")
LIB = kn.LIB
OUT = os.path.join(ROOT, "build", "k1_f32_narrow_variants")
SHAPES = kn.SHAPES
PEAK_FLOPS, PEAK_BYTES = 495e12 / 3, 3.35e12
TOL = 1e-4

# The wide body's consumer stage loop, from its first line to the end of
# the stage's release: wide_wait1 replaces it.
WIDE_LOOP_HEAD = (") acc[k] = 0.f;\n"
                  "      for (int s = 0; s < stages; ++s, ++gs) {\n")
WIDE_LOOP_TAIL = ("          if (tap == 8) wg::mbar_arrive(a_empty + 8 * buf);\n"
                  "        }\n"
                  "      }\n")
WIDE_WAIT1 = """) acc[k] = 0.f;
      // two partial sets: stage s + 1 is issued before stage s is waited
      // for and added (timing and accuracy variant)
      float pa[N / 2], pb[N / 2];
      auto issue = [&](int s, float (&part)[N / 2]) {
        const int ch = s / 9, tap = s - 9 * (s / 9), slot = (gs + s) % NB;
        const int buf = (gc + ch) % NA;
        if (tap == 0) wg::mbar_wait(a_full + 8 * buf, ((gc + ch) / NA) & 1);
        wg::mbar_wait(b_full + 8 * slot, ((gs + s) / NB) & 1);
        const int dy = tap / 3, dx = tap - 3 * (tap / 3);
        const unsigned a0 = wg::smem_u32(As + buf * A_BYTES) +
                            (dy * HW + wgi * 8 + dx) * 16;
        const unsigned b0 = wg::smem_u32(Bs + slot * B_BYTES);
        const int nks = steps(ch);
        auto da = [&](int ks, int p) {
          return wg::desc(a0 + p * A_PART + ks * 2 * HP * 16, HP * 16,
                          HW * 16, 0);
        };
        auto db = [&](int ks, int p) {
          return wg::desc(b0 + p * B_PART + ks * 32, 16, 1024, 1);
        };
        wg::fence_acc(part);
        wg::wgmma_fence();
        for (int ks = 0; ks < nks; ++ks) {
          wg::wgmma_tf32n<N>(part, da(ks, 1), db(ks, 0), ks > 0);
          wg::wgmma_tf32n<N>(part, da(ks, 0), db(ks, 1));
        }
        for (int ks = 0; ks < nks; ++ks)
          wg::wgmma_tf32n<N>(part, da(ks, 0), db(ks, 0));
        wg::wgmma_commit();
      };
      auto retire = [&](int s, float (&part)[N / 2]) {
        wg::fence_acc(part);
#pragma unroll
        for (int k = 0; k < N / 2; ++k) acc[k] += part[k];
        const int ch = s / 9, tap = s - 9 * (s / 9);
        if (lane == 0) {
          wg::mbar_arrive(b_empty + 8 * ((gs + s) % NB));
          if (tap == 8) wg::mbar_arrive(a_empty + 8 * ((gc + ch) % NA));
        }
      };
      for (int s = 0; s < stages; s += 2) {
        issue(s, pa);
        if (s > 0) {
          wg::wgmma_wait<1>();
          retire(s - 1, pb);
        }
        if (s + 1 < stages) {
          issue(s + 1, pb);
          wg::wgmma_wait<1>();
          retire(s, pa);
        }
      }
      wg::wgmma_wait<0>();
      if (stages & 1)
        retire(stages - 1, pa);
      else
        retire(stages - 1, pb);
      gs += stages;
"""

WIDE_TAP = [
    # tap-major stage order in the weight ring and in the consumers
    (WIDE, "\n            const int ch = s / 9, tap = s - 9 * (s / 9), "
           "slot = gs % NB;",
     "\n            const int ch = s % nch, tap = s / nch, slot = gs % NB;"),
    (WIDE, "\n        const int ch = s / 9, tap = s - 9 * (s / 9), "
           "slot = gs % NB;",
     "\n        const int ch = s % nch, tap = s / nch, slot = gs % NB;"),
    # one partial across the chunks of a tap, fresh at chunk 0
    (WIDE, WIDE_LOOP_HEAD, WIDE_LOOP_HEAD.replace(
        "      for", "      float part[N / 2];\n      for")),
    (WIDE, "        float part[N / 2];\n        wg::fence_acc(part);",
     "        wg::fence_acc(part);"),
    (WIDE, "wg::wgmma_tf32n<N>(part, da(ks, 1), db(ks, 0), ks > 0);",
     "wg::wgmma_tf32n<N>(part, da(ks, 1), db(ks, 0), ks > 0 || ch > 0);"),
    # waited for, added and released once its last chunk is issued
    (WIDE, """        wg::wgmma_commit();
        wg::wgmma_wait<0>();
        wg::fence_acc(part);
#pragma unroll
        for (int k = 0; k < N / 2; ++k) acc[k] += part[k];
        if (lane == 0) {   // release the stage (and, after tap 8, the halo)
          wg::mbar_arrive(b_empty + 8 * slot);
          if (tap == 8) wg::mbar_arrive(a_empty + 8 * buf);
        }
""", """        wg::wgmma_commit();
        if (ch == nch - 1) {
          wg::wgmma_wait<0>();
          wg::fence_acc(part);
#pragma unroll
          for (int k = 0; k < N / 2; ++k) acc[k] += part[k];
          if (lane == 0) {
            for (int j = 0; j < nch; ++j) {
              wg::mbar_arrive(b_empty + 8 * ((gs - j) % NB));
              if (tap == 8) wg::mbar_arrive(a_empty + 8 * ((gc + j) % NA));
            }
          }
        }
""")]


def _wide_wait1(src):
    """The edit replacing the wide body's stage loop (found by its first
    and last lines) with WIDE_WAIT1."""
    text = src[WIDE]
    i = text.index(WIDE_LOOP_HEAD)
    j = text.index(WIDE_LOOP_TAIL, i) + len(WIDE_LOOP_TAIL)
    return [(WIDE, text[i:j], WIDE_WAIT1)]


# K1 at C, Co <= 64 on the wide body
WIDE_ON = [(NARROW, "inline bool k1_narrow(int c, int co) { return c <= 64 "
                    "&& co <= 64; }",
            "inline bool k1_narrow(int c, int co) { return c < 0 && co < 0; }")]


def _no_mma(f):
    if f == NARROW:
        return [(f, "        const int nks = steps(ch);\n",
                 "        const int nks = i < 0 ? steps(ch) : 0;\n")]
    return [(f, "        const int nks = steps(ch);\n",
             "        const int nks = tl.n < 0 ? steps(ch) : 0;\n")]


def _no_loads(f):
    return [(f, "            wg::cp_async16(wg::smem_u32(dst + p * 16), "
                "ok ? src : xn, ok);",
             "            if (tl.n < 0) wg::cp_async16(wg::smem_u32(dst + p "
             "* 16), ok ? src : xn, ok);")]


def _no_epilogue(f):
    if f == NARROW:
        # (acc stays live: without a reader ptxas drops the products)
        return [(f, "      epilogue(i);\n",
                 "      if (acc[0][0] + acc[MT - 1][0] == 1e-30f) "
                 "epilogue(i);\n")]
    return [(f, "      gc += nch;\n",
             "      gc += nch;\n      if (tl.n >= 0) continue;   // timing "
             "only\n")]


# The weight ring's stages arrive without their TMA loads (timing only)
NO_WEIGHTS = [(NARROW, """          wg::mbar_expect_tx(b_full + 8 * slot, B_BYTES);
          const unsigned dst = wg::smem_u32(Bs + slot * B_BYTES);
          wg::tma_load_3d(dst, &wmap, ch * KC, 0, tap, b_full + 8 * slot);
          wg::tma_load_3d(dst + B_PART, &wmap, ch * KC, 0, 9 + tap,
                          b_full + 8 * slot);
""", """          wg::mbar_expect_tx(b_full + 8 * slot, a.c < 0 ? B_BYTES : 0);
          const unsigned dst = wg::smem_u32(Bs + slot * B_BYTES);
          if (a.c < 0) {
            wg::tma_load_3d(dst, &wmap, ch * KC, 0, tap, b_full + 8 * slot);
            wg::tma_load_3d(dst + B_PART, &wmap, ch * KC, 0, 9 + tap,
                            b_full + 8 * slot);
          }
""")]
# The halo buffers handed over without their loads and split (timing only)
NO_HALO = [(NARROW, "        wg::cp_async_wait<NA - 2>();   // chunk gc has "
                    "landed (this thread's part)\n        split(gc);\n",
            "        wg::cp_async_wait<NA - 2>();   // chunk gc has "
            "landed (this thread's part)\n        if (a.c < 0) split(gc);\n"),
           *_no_loads(NARROW)]


# The stream without the drain at a tile's end: the next tile's first
# group is in flight while the epilogue runs
# Two independent chains a block and stage: the small terms into one
# fresh partial, the big ones into another, both added in float32
TWO_CHAINS = [
    (NARROW, "        float part[MT][N / 2];\n",
     "        float part[MT][N / 2], big[MT][N / 2];\n"),
    (NARROW, "        for (int mb = 0; mb < MT; ++mb) wg::fence_acc(part[mb]);\n"
             "        wg::wgmma_fence();\n",
     "        for (int mb = 0; mb < MT; ++mb) {\n"
     "          wg::fence_acc(part[mb]);\n"
     "          wg::fence_acc(big[mb]);\n"
     "        }\n"
     "        wg::wgmma_fence();\n"),
    (NARROW, "            wg::wgmma_tf32n<N>(part[mb], da(mb, ks, 0), db(ks, 0));",
     "            wg::wgmma_tf32n<N>(big[mb], da(mb, ks, 0), db(ks, 0), ks > 0);"),
    (NARROW, "          wg::fence_acc(part[mb]);\n#pragma unroll\n"
             "          for (int k = 0; k < N / 2; ++k) acc[mb][k] += part[mb][k];",
     "          wg::fence_acc(part[mb]);\n          wg::fence_acc(big[mb]);\n"
     "#pragma unroll\n          for (int k = 0; k < N / 2; ++k)\n"
     "            acc[mb][k] += part[mb][k] + big[mb][k];")]


def _wait1(src):
    """The edit replacing the narrow body's stage loop (from its first line
    to the epilogue's call) with NARROW_WAIT1."""
    text = src[NARROW]
    head = "    int gs = 0, gc = 0;\n    for (int i = 0; i < my_tiles; ++i) {\n"
    tail = "      gc += nch;\n      epilogue(i);\n    }\n"
    i = text.index(head)
    j = text.index(tail, i) + len(tail)
    return [(NARROW, text[i:j], NARROW_WAIT1)]


# Two partial sets: stage q + 1 issued before stage q is waited for
NARROW_WAIT1 = """    auto issue = [&](int q, auto& part) {
      const int s = q % stages, ch = s / 9, tap = s - 9 * ch, slot = q % NB;
      const int gc = q / stages * nch + ch, buf = gc % NA;
      if (tap == 0) wg::mbar_wait(a_full + 8 * buf, (gc / NA) & 1);
      wg::mbar_wait(b_full + 8 * slot, (q / NB) & 1);
      const int dy = tap / 3, dx = tap - 3 * (tap / 3);
      const unsigned a0 = wg::smem_u32(As + buf * A_BYTES) +
                          (dy * HW + wgi * 8 + dx) * 16;
      const unsigned b0 = wg::smem_u32(Bs + slot * B_BYTES);
      auto da = [&](int mb, int ks, int p) {
        return wg::desc(a0 + p * A_PART + (mb * 8 * HW + ks * 2 * HP) * 16,
                        HP * 16, HW * 16, 0);
      };
      auto db = [&](int ks, int p) {
        return wg::desc(b0 + p * B_PART + ks * 32, 16, 1024, 1);
      };
      const int nks = steps(ch);
#pragma unroll
      for (int mb = 0; mb < MT; ++mb) wg::fence_acc(part[mb]);
      wg::wgmma_fence();
      for (int ks = 0; ks < nks; ++ks) {
#pragma unroll
        for (int mb = 0; mb < MT; ++mb) {
          wg::wgmma_tf32n<N>(part[mb], da(mb, ks, 1), db(ks, 0), ks > 0);
          wg::wgmma_tf32n<N>(part[mb], da(mb, ks, 0), db(ks, 1));
        }
      }
      for (int ks = 0; ks < nks; ++ks)
#pragma unroll
        for (int mb = 0; mb < MT; ++mb)
          wg::wgmma_tf32n<N>(part[mb], da(mb, ks, 0), db(ks, 0));
      wg::wgmma_commit();
    };
    auto retire = [&](int q, auto& part) {
#pragma unroll
      for (int mb = 0; mb < MT; ++mb) {
        wg::fence_acc(part[mb]);
#pragma unroll
        for (int k = 0; k < N / 2; ++k) acc[mb][k] += part[mb][k];
      }
      const int s = q % stages, ch = s / 9, tap = s - 9 * ch;
      if (lane == 0) {
        wg::mbar_arrive(b_empty + 8 * (q % NB));
        if (tap == 8)
          wg::mbar_arrive(a_empty + 8 * ((q / stages * nch + ch) % NA));
      }
    };
    float pa[MT][N / 2], pb[MT][N / 2];
    for (int i = 0; i < my_tiles; ++i) {
      const int q0 = i * stages, q1 = q0 + stages;
      issue(q0, pa);
      for (int q = q0; q < q1; q += 2) {
        if (q + 1 < q1) {
          issue(q + 1, pb);
          wg::wgmma_wait<1>();
        } else {
          wg::wgmma_wait<0>();
        }
        retire(q, pa);
        if (q + 1 == q1) break;
        if (q + 2 < q1) {
          issue(q + 2, pa);
          wg::wgmma_wait<1>();
        } else {
          wg::wgmma_wait<0>();
        }
        retire(q + 1, pb);
      }
      epilogue(i);
    }
"""


def sass_counts(so):
    """{kernel: {instruction: count}} of the conv3x3_tf32_narrow kernels in
    a built library, from cuobjdump's SASS: the tensor-core products
    (HGMMA) and the waits and arrivals around them (WARPGROUP.DEPBAR,
    WARPGROUP.ARRIVE)."""
    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", so], capture_output=True,
                         text=True).stdout
    counts, name = {}, None
    for line in out.splitlines():
        if "Function : " in line:
            name = line.split("Function : ")[1].strip()
            name = name if "conv3x3_tf32_narrow" in name else None
            if name:
                counts[name] = dict.fromkeys(
                    ("HGMMA", "WARPGROUP.DEPBAR", "WARPGROUP.ARRIVE"), 0)
        elif name:
            for op in counts[name]:
                counts[name][op] += f" {op}" in line
    return counts


def variants(src):
    """name -> (list of (file, old, new) edits, whether the result is
    checked), for the shipped sources ``src``."""
    return {
        "narrow": ([], True),
        "narrow_two_chains": (TWO_CHAINS, True),
        "narrow_wait1": (_wait1(src), True),
        "narrow_mt1": ([(NARROW, "constexpr int MT = 2;",
                         "constexpr int MT = 1;")], True),
        "narrow_no_mma": (_no_mma(NARROW), False),
        "narrow_no_loads": (_no_loads(NARROW), False),
        "narrow_no_weights": (NO_WEIGHTS, False),
        "narrow_no_halo": (NO_HALO, False),
        "narrow_only_weights": (NO_HALO + _no_mma(NARROW)
                                + _no_epilogue(NARROW), False),
        "narrow_only_halo": (NO_WEIGHTS + _no_mma(NARROW)
                             + _no_epilogue(NARROW), False),
        "narrow_skeleton": (NO_WEIGHTS + NO_HALO + _no_mma(NARROW)
                            + _no_epilogue(NARROW), False),
        "wide": (WIDE_ON, True),
        "wide_wait1": (WIDE_ON + _wide_wait1(src), True),
        "wide_tap": (WIDE_ON + WIDE_TAP, True),
        "wide_no_mma": (WIDE_ON + _no_mma(WIDE), False),
        "wide_no_loads": (WIDE_ON + _no_loads(WIDE), False),
        "wide_no_split": (WIDE_ON + [
            (WIDE, "      auto split = [&](int gc) {\n"
                   "        const int ch = gc % nch;\n",
             "      auto split = [&](int gc) {\n"
             "        if (gc >= 0) return;   // timing only\n"
             "        const int ch = gc % nch;\n")], False),
        "wide_no_epilogue": (WIDE_ON + _no_epilogue(WIDE), False)}


def sources():
    """The shipped files a variant edits or copies: name -> text."""
    out = {}
    for f in FILES:
        with open(os.path.join(_build.CSRC, f)) as fh:
            out[f] = fh.read()
    return out


def start_build(name, edits, src):
    """Writes variant ``name`` (the sources ``src`` with ``edits``) and
    starts its nvcc; returns (library path, process)."""
    d = os.path.join(OUT, name)
    os.makedirs(d, exist_ok=True)
    for f, text in kn.apply(src, edits).items():
        with open(os.path.join(d, f), "w") as out:
            out.write(text)
    so = os.path.join(d, f"lib{LIB}.so")
    return so, subprocess.Popen(
        [_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC, "-o", so,
         os.path.join(d, f"{LIB}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def finish_build(name, started):
    """The CDLL of a variant from ``start_build`` once its nvcc is done,
    and nvcc's output."""
    so, proc = started
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{out}")
    return ctypes.CDLL(so), out


def build(src, names=()):
    """Writes and builds the variants ``names`` (all when empty) at once;
    returns name -> (CDLL, checked)."""
    table = variants(src)
    if names:
        table = {name: table[name] for name in names}
    procs = {name: start_build(name, edits, src)
             for name, (edits, _) in table.items()}
    libs = {}
    for name, started in procs.items():
        lib, out = finish_build(name, started)
        lines = out.splitlines()
        for line in lines:
            if "serialized" in line:   # ptxas: wgmma waits it inserted
                print(f"  {name}: {line.strip()[:240]}", flush=True)
        for i, line in enumerate(lines):
            if ("Compiling entry" in line and "conv3x3_tf32" in line
                    and ("narrow" in line) == name.startswith("narrow")
                    and ("Li48E" in line or "Li64E" in line)):
                spill = next(m for m in lines[i:] if "spill" in m).strip()
                used = next(m for m in lines[i:] if "Used" in m)
                print(f"  {name} {line.split(chr(39))[1][:60]}: "
                      f"{used.split(':', 1)[1].strip()}; {spill}", flush=True)
        libs[name] = (lib, table[name][1])
        if name.startswith("narrow"):
            for kernel, ops in sass_counts(started[0]).items():
                if "Li48E" in kernel:
                    print(f"  {name} {kernel[:56]}: SASS {ops}", flush=True)
    return libs


def inputs(g, shape):
    n, h, w, c = shape
    x = torch.randn(shape, device="cuda", generator=g) * 3
    wt = torch.randn(3, 3, c, c, device="cuda", generator=g) * 0.02
    b = torch.randn(c, device="cuda", generator=g) * 0.02
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


def _rel(a, ref):
    return ((a.double() - ref.double()).abs().max()
            / ref.double().abs().max()).item()


def check(args):
    """(y error against the plain version, against float64, stats error
    against float64, each as a share of the scale; same bits twice)."""
    y, s = res_block.conv3x3_in_stats(*args)
    y2, s2 = res_block.conv3x3_in_stats(*args)
    yp, _ = res_block.conv3x3_in_stats_plain(*args)
    y64, s64 = res_block.conv3x3_in_stats_plain(*(a.double() for a in args))
    return (_rel(y, yp), _rel(y, y64), _rel(s, s64),
            torch.equal(y, y2) and torch.equal(s, s2))


def bound_ms(shape, prologue):
    n, h, w, c = shape
    nbytes = (2 * n * h * w * c + 9 * c * c + c) * 4 + n * 2 * c * 4
    if prologue:
        nbytes += (n * 2 * c + 2 * c) * 4
    return max(2 * 9 * c * c * n * h * w / PEAK_FLOPS,
               nbytes / PEAK_BYTES) * 1e3


def main(names):
    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[k1 f32 narrow variants] {smi}; torch {torch.__version__}",
          flush=True)
    t0 = time.perf_counter()
    libs = build(sources(), names)
    print(f"  built {len(libs)} variants in {time.perf_counter() - t0:.1f} s",
          flush=True)
    apply_precision(torch.float32)
    g = torch.Generator(device="cuda").manual_seed(0)
    fails = 0
    names = list(libs)
    for label, shape, args in cases(g):
        call = (lambda a=args: res_block.conv3x3_in_stats(*a))
        for name, (lib, checked) in libs.items():
            if checked:
                with kn.loaded(lib):
                    e = check(args)
                fails += not (max(e[:3]) <= TOL and e[3])
                print(f"  {label}: {name} y {e[0]:.3e} of scale from the "
                      f"plain f32, {e[1]:.3e} from float64, stats {e[2]:.3e}"
                      f", same bits {e[3]}", flush=True)
        res = {name: {"call": [], "device": [], "host": []} for name in names}
        kernels = {}
        for order in (names, names[::-1]):
            for name in order:
                with kn.loaded(libs[name][0]):
                    res[name]["call"].append(kn.event_ms(call))
                    dev, rows = kn.device_ms(call)
                    res[name]["device"].append(dev)
                    res[name]["host"].append(kn.host_ms(call))
                    kernels[name] = rows
        lib, both = kn.cudnn_ms(*args[:3])
        bnd = bound_ms(shape, len(args) > 3)
        print(f"  {label}: bound {bnd:.4f} ms (3xTF32 operations); cuDNN f32 "
              f"{lib:.4f} (NCHW {both['NCHW']:.4f}, channels_last "
              f"{both['channels_last']:.4f})", flush=True)
        for name in names:
            r = {k: min(v) for k, v in res[name].items()}
            print(f"    {name:18s} call {r['call']:.4f}  device "
                  f"{r['device']:.4f} ({bnd / r['device']:.2f} of bound)  "
                  f"host {r['host']:.4f}  "
                  + ", ".join(f"{k} {v:.4f}" for k, v in
                              kernels[name].items()), flush=True)
    print(f"[k1 f32 narrow variants] {'FAILED' if fails else 'ok'}; {smi}")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
