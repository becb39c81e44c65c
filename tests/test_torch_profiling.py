"""The port's profiling hooks (``vst_tpu_torch/utils/profiling.py``)
against the JAX package's: ``StepTimer`` summaries on one clock sequence,
and ``trace_context`` writing a Chrome trace of the region."""

import json

import pytest
import torch

from vst_tpu.utils import profiling as jp
from vst_tpu_torch.utils import StepTimer, trace_context
from vst_tpu_torch.utils import profiling as pp


@pytest.mark.parametrize("warmup,steps", [(2, 7), (0, 3), (3, 3)])
def test_step_timer_matches_jax(monkeypatch, warmup, steps):
    """The same perf_counter readings give JAX's times and summary keys and
    values (an empty summary when every step was warm-up)."""
    ticks = [0.0]
    for i in range(steps):
        ticks += [ticks[-1] + 0.5 * i, ticks[-1] + 0.5 * i + 0.01 * (i + 1)]
    ticks = ticks[1:]
    out = []
    for mod in (jp, pp):
        clock = iter(ticks)
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(clock))
        timer = mod.StepTimer(warmup=warmup)
        for _ in range(steps):
            with timer:
                pass
        out.append((timer.times, timer.summary()))
    (jt, js), (pt, ps) = out
    assert pt == jt and len(pt) == max(steps - warmup, 0)
    assert ps == js
    if pt:
        assert set(ps) == {"steps", "mean_s", "p50_s", "p95_s",
                           "steps_per_sec"}


def test_trace_context_writes_chrome_trace(tmp_path):
    """A trace of a small conv lands in log_dir as a Chrome trace JSON
    whose events name the region's operators."""
    log_dir = tmp_path / "trace"
    x = torch.randn(1, 3, 16, 16)
    w = torch.randn(4, 3, 3, 3)
    with trace_context(str(log_dir)):
        torch.nn.functional.conv2d(x, w)
    files = list(log_dir.glob("*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("conv" in str(e.get("name", "")) for e in events)
    assert StepTimer is pp.StepTimer
