"""Driver ``pairs``: arbitrary-style image serving
(``cli/infer_image.py``): the configuration's batch call
(``entry/<config>.py::pair_batch``, for ``adaattn`` ``infer/image.py::
stylize_adaattn``) on batches of seeded (content, style) pairs, each pair
with its own style.

A closed loop with one batch in flight: each batch is a request that ends
with its styled images on the host, and the next is sent when it has.  An
image's latency runs from the call to the moment its batch is on the host.
Afterwards a seeded sample of the batches handed back in the window, every
image of each, is held against the plain reference in float32, from the
same weights (the served bfloat16 values) and the same images."""

import math

import torch

from portbench.core import launches
from portbench.core.seeds import sub_seed
from portbench.core.trace import Tracer, span
from portbench.drivers.common import (Phases, Reservoir, now, read_peak,
                                      reference, release, reset_peak,
                                      sync)
from portbench.reference import common as ref_common
from portbench.synth import frames as synth_frames


HOOK = "serve"   # what ``run_cell``'s hook may stand in for
# what it calls of ``entry/<config>.py``
ENTRY = ("serve_models", "pair_batch")


def _weights(ref, cfg, seed, dev, dtype):
    w = ref.stylizer_weights(cfg, sub_seed(seed, "weights"), dev)
    v = ref.vgg_weights(sub_seed(seed, "vgg"), dev)
    return ({k: t.to(dtype) for k, t in w.items()},
            {k: t.to(dtype) for k, t in v.items()})


def _float(weights):
    return {k: t.float() for k, t in weights.items()}


def pairs(i, b, pool):
    """Content and style indices of batch ``i``: the contents in order,
    the styles a stride-5 walk, so that each pair has a style of its
    own.  The batches repeat every ``pool // gcd(pool, b)``."""
    idx = [(i * b + j) % pool for j in range(b)]
    return idx, [(5 * k + 1) % pool for k in idx]


def run(run, entry, traffic, trace, t0, hook):
    phases = Phases(t0)
    dev, cfg, seed = run.device, run.config, run.seed
    ref = reference(run)
    dtype = getattr(torch, traffic["dtype"])
    b = traffic["batch"]
    phases.mark("imports")
    h, w = traffic["size"]
    reset_peak(dev)
    models = entry.serve_models(cfg, *_weights(ref, cfg, seed, dev, dtype),
                                dev, dtype)
    phases.mark("models")
    n = traffic["pool_images"]
    contents = synth_frames.clip(sub_seed(seed, "traffic"), n, (h, w))
    styles = synth_frames.clip(sub_seed(seed, "style"), n, (h, w))
    phases.mark("images")

    def call(content, style):
        return entry.pair_batch(cfg, models, content, style)

    def in_place_of_port(q):
        """The reference in the program's place, one image at a time, its
        products' operands rounded by ``q`` (the control)."""
        w, v = (_float(t) for t in _weights(ref, cfg, seed, dev, dtype))

        def reference_batch(content, style):
            return torch.cat([ref.serve(
                w, v, torch.from_numpy(c[None]).to(dev),
                torch.from_numpy(s[None]).to(dev), q)
                for c, s in zip(content, style)])
        return reference_batch

    fn = hook(HOOK, call, {"run": run, "reference": in_place_of_port}) \
        if hook else call

    # the requests, assembled in set-up: the source hands them over as a
    # server holds decoded images, at no cost inside the window
    batches = [pairs(i, b, n) for i in range(n // math.gcd(n, b))]
    batches = [(ci, si, contents[ci], styles[si]) for ci, si in batches]

    def request(i):
        ci, si, c, s = batches[i % len(batches)]
        t = now()
        with span("dispatch"):
            out = fn(c, s)
        td = now()
        with span("read"):
            host = out.cpu()
        return t, td, now(), host, ci, si

    for i in range(traffic["warmup_batches"]):
        request(i)
    sync(dev)
    phases.mark("warm-up")
    tracer = Tracer(trace)
    tracer.warm()
    phases.mark("profiler")
    run.notes.append(phases.note())
    keep = Reservoir(traffic["check_batches"], sub_seed(seed, "sample"))
    launches.reset()
    start = now()
    run.setup_s = start - t0
    end = start + run.seconds
    t_trace = end - min(traffic["trace_seconds"], run.seconds / 2)
    i = 0
    while True:
        if trace and now() >= t_trace:
            tracer.start()
        t, td, te, host, ci, si = request(i)
        i += 1
        run.attempted += b
        if te > end:
            break
        run.dispatch_s.append(td - t)
        run.latencies_s += [te - t] * b
        keep.offer(lambda: list(zip(ci, si, host)))
    tracer.stop()
    run.launches = launches.read()
    run.window_s = run.seconds
    run.frames = len(run.latencies_s)
    run.peak_bytes = read_peak(dev)
    run.trace = tracer.trace
    run.work = {"frames": (h, w), "batch": b, "dtype": traffic["dtype"]}
    run.launch_units = ("image", run.attempted)
    del models, fn, call
    release(dev)
    check(run, ref, traffic, contents, styles,
          [image for whole in keep.items for image in whole], dtype)


def check(run, ref, traffic, contents, styles, kept, dtype):
    """The sampled styled images against the plain float32 reference, one
    image at a time: the mean gap in 0-255 steps."""
    dev = run.device
    ref_common.full_float32()
    w, v = (_float(t) for t in _weights(ref, run.config, run.seed, dev,
                                          dtype))
    worst, total, count = 0.0, 0.0, 0
    with torch.no_grad():
        for ci, si, got in kept:
            c = torch.from_numpy(contents[ci][None]).to(dev)
            s = torch.from_numpy(styles[si][None]).to(dev)
            want = ref.serve(w, v, c, s)[0].cpu()
            diff = (got.float() - want).abs()
            worst = max(worst, float(diff.max()))
            total += float(diff.sum())
            count += diff.numel()
    run.check("images_unchecked",
              max(0, traffic["check_batches"] * traffic["batch"] - len(kept)),
              0)
    run.check("mean_abs", total / max(count, 1), traffic["limits"]["mean_abs"])
    # the widest gap is not compared: bfloat16 and float32 part by up to
    # two thirds of the float8 control's widest gap at some pixel
    run.notes.append(f"widest gap {worst} (not compared)")
