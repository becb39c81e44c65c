"""The traced span of a run and its reduction: device intervals, the idle
share from their union, kernel time by name, and the breakdown.

The profiler (``torch.profiler`` with CPU and CUDA activities, the port's
``utils/profiling.py::trace_context`` kept here as the benchmark's own copy)
holds its events in memory; nothing is written to disk.  The harness's own
host spans (``record_function("portbench.<what>")``) name what the host was
doing in each idle gap."""

import contextlib

SPAN_PREFIX = "portbench."


def union_seconds(intervals):
    """Seconds covered by the union of (start, end) intervals: kernels that
    overlap count once."""
    total = 0.0
    end = None
    start = None
    for a, b in sorted(intervals):
        if end is None or a > end:
            if end is not None:
                total += end - start
            start, end = a, b
        else:
            end = max(end, b)
    if end is not None:
        total += end - start
    return total


def gaps(intervals, lo, hi):
    """The idle (start, end) gaps in [lo, hi] between the union of
    ``intervals``."""
    out = []
    cursor = lo
    for a, b in sorted(intervals):
        if a > cursor:
            out.append((cursor, min(a, hi)))
        cursor = max(cursor, b)
        if cursor >= hi:
            break
    if cursor < hi:
        out.append((cursor, hi))
    return [(a, b) for a, b in out if b > a]


def short_name(name, limit=100):
    """A kernel's name without its return type and argument list."""
    n = name.replace("(anonymous namespace)::", "")
    if n.startswith("void "):
        n = n[5:]
    depth = 0
    for i, ch in enumerate(n):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            n = n[:i]
            break
    return n[:limit]


class Trace:
    """Device events (name, start_s, end_s) and host spans of one traced
    span, on the profiler's clock, with the span's bounds."""

    def __init__(self, device, host, lo, hi):
        self.device = device
        self.host = host
        self.lo, self.hi = lo, hi

    @property
    def window_s(self):
        return self.hi - self.lo

    def clipped(self):
        return [(max(a, self.lo), min(b, self.hi)) for _, a, b in self.device
                if b > self.lo and a < self.hi]

    @property
    def busy_s(self):
        return union_seconds(self.clipped())

    def matching(self, patterns):
        return [(n, a, b) for n, a, b in self.device
                if any(p in n for p in patterns)]

    def kernel_seconds(self, patterns):
        """Summed device time of the events whose name holds a pattern."""
        return sum(b - a for _, a, b in self.matching(patterns))

    def kernel_count(self, patterns):
        return len(self.matching(patterns))

    def breakdown(self, top=10):
        by_name = {}
        for n, a, b in self.device:
            k = short_name(n)
            by_name[k] = by_name.get(k, 0.0) + (b - a)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        longest = sorted(gaps(self.clipped(), self.lo, self.hi),
                         key=lambda g: g[0] - g[1])[:top]
        spans = [h for h in self.host if h[0].startswith(SPAN_PREFIX)
                 and h[0] != SPAN_PREFIX + "traced"]
        idle = [[_doing(spans, a, b), b - a] for a, b in longest]
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": idle}


def _doing(spans, a, b):
    """The innermost harness span open at the middle of the gap [a, b], or
    "host" where none is."""
    mid = (a + b) / 2
    open_ = [(hb - ha, name) for name, ha, hb in spans if ha <= mid <= hb]
    return min(open_)[1][len(SPAN_PREFIX):] if open_ else "host"


def _annotation(ev):
    """A user annotation (a ``record_function`` range mirrored on the
    device's timeline), not an operation of the card."""
    if hasattr(ev, "is_user_annotation") and ev.is_user_annotation():
        return True
    kind = str(ev.activity_type()).lower() if hasattr(
        ev, "activity_type") else ""
    return "annotation" in kind or ev.name().startswith(SPAN_PREFIX)


def _events(prof):
    """(device operations, host events) as (name, start_s, end_s) from the
    profiler's raw Kineto results: kernels, copies and sets on the card;
    everything on the host."""
    import torch

    cpu = torch.autograd.DeviceType.CPU
    device, host = [], []
    for ev in prof.profiler.kineto_results.events():
        start = ev.start_ns() * 1e-9
        rec = (ev.name(), start, start + ev.duration_ns() * 1e-9)
        if ev.device_type() == cpu:
            host.append(rec)
        elif not _annotation(ev):
            device.append(rec)
    return device, host


class Tracer:
    """Start and stop a profile inside a run; ``trace`` after ``stop``."""

    def __init__(self, enabled):
        self.enabled = enabled
        self.prof = None
        self.trace = None
        self._span = None

    def start(self):
        if not self.enabled or self.prof is not None:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()
        self._span = torch.profiler.record_function(SPAN_PREFIX + "traced")
        self._span.__enter__()

    def warm(self):
        """Profile a moment in set-up: the profiler's first start (CUPTI's
        set-up, seconds) then falls outside the window."""
        if not self.enabled:
            return
        self.start()
        self.stop()
        self.trace = None

    @property
    def active(self):
        return self.prof is not None and self.trace is None

    def stop(self):
        if not self.active:
            return
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._span.__exit__(None, None, None)
        self.prof.stop()
        device, host = _events(self.prof)
        marks = [(a, b) for n, a, b in host if n == SPAN_PREFIX + "traced"]
        lo, hi = marks[0] if marks else (
            min((a for _, a, _ in host), default=0.0),
            max((b for _, _, b in host), default=0.0))
        self.trace = Trace(device, host, lo, hi)
        self.prof = None


@contextlib.contextmanager
def span(name):
    """A host span of the harness, named in the trace."""
    import torch

    with torch.profiler.record_function(SPAN_PREFIX + name):
        yield
