"""The port's spans (``vst_tpu_torch/utils/profiling.py::span``): a shared
no-op while no profiler records; under ``torch.profiler`` the stream's,
the data feed's, a train step's and the models' spans on the consuming
thread, none open across a ``yield``; and the benchmark's readers of them
(``portbench/metrics/``) on a hand-built trace."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench.core import load
from portbench.core.record import Run
from portbench.core.trace import Trace
from vst_tpu_torch.data.pipeline import BatchLoader, device_prefetch
from vst_tpu_torch.infer.video import StreamingStylizer
from vst_tpu_torch.models import reconet as pr
from vst_tpu_torch.models import vgg as pv
from vst_tpu_torch.ops.pad import reflection_pad2d
from vst_tpu_torch.train import config as pc
from vst_tpu_torch.train import state as ps
from vst_tpu_torch.train import steps as pst
from vst_tpu_torch.utils import profiling, span

CONSUMER = "test.consumer"


class _Counted:
    """Stands in for ``record_function``: counts the ranges entered."""

    entered = 0

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        type(self).entered += 1

    def __exit__(self, *exc):
        return False


def _spans(prof):
    """{name: [(start_ns, end_ns)]} of the CPU events whose name starts
    with "vst::" or is the consumer's, from the profiler's raw Kineto
    results (what ``portbench/core/trace.py`` reads)."""
    cpu = torch.autograd.DeviceType.CPU
    out = {}
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        if ev.device_type() == cpu and (name.startswith("vst::")
                                        or name == CONSUMER):
            a = ev.start_ns()
            out.setdefault(name, []).append((a, a + ev.duration_ns()))
    return out


def _consume(it):
    """Everything ``it`` yields, the consumer holding its own span open
    around its code between ``next()`` calls."""
    items = []
    for item in it:
        with torch.profiler.record_function(CONSUMER):
            items.append(item)
    return items


def _assert_none_across_yield(spans):
    """No program span overlaps a span the consumer held between two
    ``next()`` calls."""
    held = spans[CONSUMER]
    for name, intervals in spans.items():
        if name == CONSUMER:
            continue
        for a, b in intervals:
            assert all(max(a, c) >= min(b, d) for c, d in held), name


def test_span_is_one_shared_no_op_while_no_profiler_records(monkeypatch):
    monkeypatch.setattr(profiling, "record_function", _Counted)
    monkeypatch.setattr(_Counted, "entered", 0)
    assert span("vst::a") is span("vst::b")
    with span("vst::a"):
        reflection_pad2d(torch.zeros(1, 4, 4, 2), 1)
    assert _Counted.entered == 0
    with profile(activities=[ProfilerActivity.CPU]):
        assert isinstance(span("vst::a"), _Counted)
        with span("vst::a"):
            reflection_pad2d(torch.zeros(1, 4, 4, 2), 1)
    assert _Counted.entered == 2
    assert span("vst::a") is span("vst::b")


def test_stream_spans_once_a_batch_and_none_across_a_yield():
    frames = [np.full((6, 8, 3), i, np.uint8) for i in range(10)]

    def model_fn(batch):
        return batch.to(torch.float32) + 1.0

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = _consume(StreamingStylizer(model_fn, frames, batch_size=4,
                                         pipeline_depth=2, device="cpu"))
    assert [int(f[0, 0, 0]) for f in out] == list(range(1, 11))
    spans = _spans(prof)
    batches = 3   # 4 + 4 + 2 frames, the last padded to 4
    for what in ("assemble", "upload", "call", "download", "result_wait"):
        assert len(spans[f"vst::stream.{what}"]) == batches, what
    assert len(spans["vst::stream.read_wait"]) == len(frames) + 1   # + end
    assert len(spans["vst::stream.hand_out"]) == batches + len(frames)
    assert len(spans[CONSUMER]) == len(frames)
    _assert_none_across_yield(spans)


def test_loader_and_prefetch_spans_once_a_batch():
    items = [(np.full((4, 4, 3), i, np.float32), np.array([i]))
             for i in range(8)]
    loader = BatchLoader(items, 2, shuffle=True, seed=3, num_workers=2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        batches = _consume(device_prefetch(iter(loader), 2, "cpu"))
    assert len(batches) == 4
    assert all(isinstance(x, torch.Tensor) for b in batches for x in b)
    spans = _spans(prof)
    assert len(spans["vst::data.load"]) == 4
    assert len(spans["vst::data.upload"]) == 4
    _assert_none_across_yield(spans)


def test_const_build_span_once_per_constant():
    """A device constant's first use opens "vst::ops.const_build" and
    counts one build; its later uses open nothing."""
    from vst_tpu_torch.ops.constants import device_constant

    values = (0.5, 1.5, 2.5, 3.5)
    before = device_constant.builds
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            device_constant(values, torch.float64, "cpu")
    assert len(_spans(prof)["vst::ops.const_build"]) == 1
    assert device_constant.builds == before + 1


@pytest.fixture(scope="module")
def coco_step_spans():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        cfg = pc.ReCoNetCocoConfig()
        vgg = pv.init_vgg16_reconet(0, device="cpu")
        rng = np.random.default_rng(0)
        style = (rng.random((1, 16, 16, 3)) * 255).astype(np.float32)
        step = pst.make_reconet_coco_step(
            cfg, vgg, pst.reconet_style_grams(vgg, style))
        state = ps.create(pr.init_reconet(1, device="cpu"), cfg.lr)
        batch = (rng.random((1, 16, 16, 3)) * 255).astype(np.float32)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            state, _ = step(state, batch)
        return _spans(prof)
    finally:
        torch.set_num_threads(threads)


def test_train_step_spans(coco_step_spans):
    spans = coco_step_spans
    for what in ("inputs", "forward", "backward", "optimizer"):
        assert len(spans[f"vst::step.{what}"]) == 1, what
    assert "vst::step.reduce" not in spans   # no mesh
    (fa, fb), = spans["vst::step.forward"]
    (ba, _), = spans["vst::step.backward"]
    (oa, _), = spans["vst::step.optimizer"]
    assert fb <= ba and spans["vst::step.backward"][0][1] <= oa


def test_model_spans_sit_inside_the_forward(coco_step_spans):
    spans = coco_step_spans
    (fa, fb), = spans["vst::step.forward"]
    names = [f"vst::ReCoNet.{layer[1]}" for layer in pr.ReCoNet.spec(1)]
    for name in names + ["vst::vgg.encode"]:
        assert spans[name], name
        assert all(fa <= a and b <= fb for a, b in spans[name]), name
    # K1's backward pads too
    assert any(fa <= a and b <= fb for a, b in spans["vst::reflection_pad2d"])


# A traced span [0, 10] s: the device busy over (0, 1), (2, 6) and (8, 10),
# idle over (1, 2) and (6, 8), 3 s in all; "vst::stream.call" starts twice
# inside it and "vst::step.optimizer" three times.
DEVICE = [("k", 0.0, 1.0), ("k", 2.0, 6.0), ("k", 8.0, 12.0)]
HOST = [
    ("portbench.traced", 0.0, 10.0), ("portbench.stream", 0.0, 10.0),
    ("aten::conv2d", 0.1, 0.2),
    ("vst::stream.call", 0.5, 1.5), ("vst::stream.call", 5.0, 5.5),
    ("vst::stream.call", 11.0, 11.5),
    ("vst::stream.read_wait", -1.0, 0.5), ("vst::stream.read_wait", 6.0, 6.5),
    ("vst::stream.result_wait", 6.4, 7.4),
    ("vst::stream.assemble", 1.5, 1.7), ("vst::stream.upload", 1.7, 1.8),
    ("vst::stream.download", 5.5, 5.6), ("vst::stream.hand_out", 7.4, 7.6),
    ("vst::stream.hand_out", 9.8, 10.3),
    ("vst::k1", 0.6, 0.7), ("vst::k2", 0.7, 0.75), ("vst::k1", 5.1, 5.2),
    ("vst::k3", 0.8, 0.9),
    ("vst::step.optimizer", 1.0, 1.1), ("vst::step.optimizer", 4.0, 4.1),
    ("vst::step.optimizer", 9.95, 10.2),
    ("vst::step.forward", 0.2, 0.6), ("vst::step.forward", 3.0, 3.5),
    ("vst::step.backward", 0.6, 1.0), ("vst::step.backward", 3.5, 4.0),
    ("vst::step.backward", 8.0, 9.95),
    ("vst::data.load", 1.2, 1.9), ("vst::data.upload", 1.9, 2.1),
    ("vst::data.load", 6.1, 6.3),
]
EXPECTED = {
    # (0.5 clipped + 0.5) s over 2 batches
    "read_wait_ms.serve": 500.0,
    "result_wait_ms.serve": 500.0,
    # assemble 0.2 + upload 0.1 + download 0.1 + hand_out 0.2 + 0.2 clipped
    "stream_host_ms.serve": 400.0,
    "kernel_host_ms.serve": 125.0,          # k1 0.1 + 0.1, k2 0.05; not k3
    # idle under assemble + upload (1.5, 1.8) and under the union of
    # read_wait, result_wait and hand_out (6.0, 7.6): 0.3 + 1.6 of 3 s;
    # the call's (1, 1.5) does not count
    "idle_in_stream_share.serve": 100.0 * 1.9 / 3.0,
    "load_ms.train": 300.0,                 # 0.7 + 0.2 over 3 steps
    # idle under (1.2, 2.0) and (6.1, 6.3): 1.0 of 3 s
    "idle_in_data_share.train": 100.0 * 1.0 / 3.0,
    "forward_ms.train": 300.0,
    "backward_ms.train": 950.0,
    "optimizer_ms.train": 250.0 / 3.0,      # 0.1 + 0.1 + 0.05 clipped
}


def _read(metric, trace):
    run = Run(cell={}, config={}, seed=0, seconds=10.0, trace=trace)
    return load.module("metrics", metric).read(run)


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_span_metric_reads_a_hand_built_trace(metric):
    assert _read(metric, Trace(DEVICE, HOST, 0.0, 10.0)) == \
        pytest.approx(EXPECTED[metric])
    assert _read(metric, None) is None
    # a program without the spans (the parent's) reads nothing
    bare = [h for h in HOST if not h[0].startswith("vst::")]
    assert _read(metric, Trace(DEVICE, bare, 0.0, 10.0)) is None
