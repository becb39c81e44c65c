"""Profiling and tracing hooks.  Counterpart of
``vst_tpu/utils/profiling.py``.

- ``span(name)`` names a region of the host's work in the profiler's
  trace: ``torch.profiler.record_function(name)`` while a profiler is
  recording, one shared no-op context manager otherwise (under a
  microsecond, where an idle ``record_function`` costs ten or more).
  Every range the package opens goes through it.  Names are
  ``vst::<layer>.<what>``; a span is entered and left on the thread that
  does or waits for the work (the profiler records no ranges opened in
  other threads) and stays open across no ``yield``.
- ``trace_context`` wraps a code region in a ``torch.profiler`` trace of
  the host and, where there is a card, its kernels, written into
  ``log_dir`` as a Chrome trace (``chrome://tracing``, Perfetto).
- ``StepTimer`` collects wall-clock step times with warm-up skipping and
  percentile summaries.  CUDA launches return before the device finishes:
  end a timed step with ``torch.cuda.synchronize()`` or a read of its
  result.
"""

import contextlib
import os
import time

import numpy as np
import torch
from torch.autograd import profiler as _profiler
from torch.profiler import record_function

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager that records ``name`` as a range of the host's
    timeline while a profiler (``trace_context``, ``torch.profiler``) is
    recording, and does nothing otherwise."""
    if _profiler._is_profiler_enabled:
        return record_function(name)
    return _OFF


@contextlib.contextmanager
def trace_context(log_dir: str):
    """Trace the region and write ``<log_dir>/trace_<pid>_<n>.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    n = len(os.listdir(log_dir))
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{n}.json"))


class StepTimer:
    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self._times = []
        self._count = 0
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._count += 1
        if self._count > self.warmup:
            self._times.append(dt)
        return False

    @property
    def times(self):
        return list(self._times)

    def summary(self) -> dict:
        if not self._times:
            return {}
        arr = np.asarray(self._times)
        return {
            "steps": len(arr),
            "mean_s": float(arr.mean()),
            "p50_s": float(np.percentile(arr, 50)),
            "p95_s": float(np.percentile(arr, 95)),
            "steps_per_sec": float(1.0 / arr.mean()),
        }
