"""Driver ``stream``: streaming video stylization, the port's main path
(``cli/infer_video.py``): ``infer/video.py::StreamingStylizer`` around
the configuration's batch call (``entry/<config>.py::stream_batch``, for
``reconet`` ``infer/image.py::stylize_reconet(..., uint8_out=True)``).

A closed loop: the source hands the port's reader the next frame of a
seeded uint8 pool whenever it asks, never waiting, until the window's end.
A frame's latency runs from that hand-off to the moment the stylizer hands
back its styled frame on the host.  ``frames_per_s`` counts the frames
handed back inside the window.  Afterwards a seeded sample of the batches
handed back whole inside the window (every slot of each) is held against
the plain reference in float32, from the same weights (the served
bfloat16 values) and the same frames."""

import numpy as np
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
ENTRY = ("serve_model", "stream_batch")


def served_weights(ref, cfg, seed, device, dtype):
    """The stylizer's weights in the type they are served in."""
    w = ref.stylizer_weights(cfg, sub_seed(seed, "weights"), device)
    return {k: v.to(dtype) for k, v in w.items()}


def run(run, entry, traffic, trace, t0, hook):
    from vst_tpu_torch.infer.video import StreamingStylizer

    phases = Phases(t0)
    dev, cfg, seed = run.device, run.config, run.seed
    ref = reference(run)
    dtype = getattr(torch, traffic["dtype"])
    b, depth = traffic["batch"], traffic["pipeline_depth"]
    phases.mark("imports")
    h, w = traffic["frame_hw"]
    reset_peak(dev)
    model = entry.serve_model(cfg, served_weights(ref, cfg, seed, dev, dtype),
                              dev, dtype)
    phases.mark("model")
    pool = synth_frames.clip(sub_seed(seed, "traffic"),
                             traffic["pool_frames"], (h, w))
    phases.mark("frames")
    dispatch = []

    def call(batch):
        with span("dispatch"):
            t = now()
            out = entry.stream_batch(model, batch, traffic["wire"])
            dispatch.append(now() - t)
        return out

    def in_place_of_port(q):
        """The reference in the program's place, its products' operands
        rounded by ``q`` (the control)."""
        w = {k: v.float() for k, v in served_weights(ref, cfg, seed, dev,
                                                      dtype).items()}
        return lambda batch: ref.serve(w, torch.as_tensor(batch).to(dev), q)

    fn = hook(HOOK, call, {"run": run, "reference": in_place_of_port}) \
        if hook else call

    def stream(frames):
        return StreamingStylizer(fn, frames, batch_size=b,
                                 pipeline_depth=depth, wire=traffic["wire"],
                                 device=dev)

    for _ in stream(iter(pool[:traffic["warmup_batches"] * b])):
        pass
    sync(dev)
    dispatch.clear()
    phases.mark("warm-up")
    tracer = Tracer(trace)
    tracer.warm()
    phases.mark("profiler")
    run.notes.append(phases.note())

    t_in = []
    keep = Reservoir(traffic["check_batches"], sub_seed(seed, "sample"))
    launches.reset()
    start = now()
    run.setup_s = start - t0
    end = start + run.seconds
    t_trace = end - min(traffic["trace_seconds"], run.seconds / 2)

    def source():
        i = 0
        while True:
            t = now()
            if t >= end:
                return
            t_in.append(t)
            yield pool[i % len(pool)]
            i += 1

    done = 0
    whole = []   # the frames of the batch being handed back, in slot order
    frames = iter(stream(source()))
    while True:
        with span("stream"):   # inside the stylizer's iterator
            frame = next(frames, None)
        if frame is None:
            break
        t = now()
        i = done
        done += 1
        if t <= end:
            run.latencies_s.append(t - t_in[i])
            whole.append((i, frame))
            if len(whole) == b:
                keep.offer(lambda batch=whole: batch)
                whole = []
            if trace and t >= t_trace:
                tracer.start()
        elif tracer.active:
            tracer.stop()
    sync(dev)
    tracer.stop()
    run.launches = launches.read()
    run.window_s = run.seconds
    run.frames = len(run.latencies_s)
    run.attempted = len(t_in)
    run.failed = len(t_in) - done
    run.dispatch_s = dispatch
    run.peak_bytes = read_peak(dev)
    run.trace = tracer.trace
    run.work = {"frames": (h, w), "batch": b, "dtype": traffic["dtype"]}
    run.launch_units = ("frame", run.attempted)
    del model, fn, call
    release(dev)
    check(run, ref, traffic, pool, [f for whole in keep.items
                                    for f in whole], dtype)


def check(run, ref, traffic, pool, kept, dtype):
    """The sampled styled frames against the plain float32 reference of the
    same frames and the same (served) weights: the widest and the mean
    gap in uint8 steps."""
    dev = run.device
    ref_common.full_float32()
    weights = {k: v.float() for k, v in served_weights(
        ref, run.config, run.seed, dev, dtype).items()}
    kept = sorted(kept, key=lambda item: item[0])
    worst, total, count = 0, 0.0, 0
    with torch.no_grad():
        for a in range(0, len(kept), traffic["batch"]):
            part = kept[a:a + traffic["batch"]]
            x = torch.from_numpy(np.stack([pool[i % len(pool)]
                                           for i, _ in part])).to(dev)
            want = ref.serve(weights, x).cpu().numpy().astype(np.int32)
            got = np.stack([f for _, f in part]).astype(np.int32)
            diff = np.abs(got - want)
            worst = max(worst, int(diff.max()))
            total += float(diff.sum())
            count += diff.size
    limits = traffic["limits"]
    run.check("frames_unchecked",
              max(0, traffic["check_batches"] * traffic["batch"] - len(kept)),
              0)
    run.check("max_abs_u8", worst, limits["max_abs_u8"])
    run.check("mean_abs_u8", total / max(count, 1), limits["mean_abs_u8"])
