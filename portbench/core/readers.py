"""What the metric readers share: rates over the window, tails over all
samples, medians of host spans, a roofline share from the trace, a share of
the peak from counted work over the window, and the device's idle share.
Each ``metrics/<name>.py`` calls one of these; a reader that finds nothing
to read returns None."""

import importlib

from portbench.core.peaks import PEAK_FLOPS, bound_seconds
from portbench.core.stats import median, percentile


def window_rate(run):
    """Frames (or images) handed back inside the window over its seconds."""
    return run.frames / run.window_s if run.frames else None


def sample_rate(run):
    """Samples of the steps completed in the window over its seconds."""
    return run.samples / run.window_s if run.samples else None


def latency_p95_ms(run):
    """The 95th percentile of every latency of the window, in ms."""
    return 1e3 * percentile(run.latencies_s, 95) if run.latencies_s else None


def median_ms(seconds):
    """The median of host spans, in ms."""
    return 1e3 * median(seconds) if seconds else None


def counts(run):
    return importlib.import_module(f"portbench.counts.{run.cell['config']}")


def roofline(run, patterns, unit_pattern, per_unit, calls):
    """Bound time over device time, in %.  ``calls`` are the (FLOPs, bytes)
    of one unit of work (a forward or a step), which launches
    ``unit_pattern`` ``per_unit`` times; the device time is that of every
    launch whose name holds one of ``patterns``.  None where the trace
    holds none."""
    if run.trace is None:
        return None
    spent = run.trace.kernel_seconds(patterns)
    units = run.trace.kernel_count((unit_pattern,)) / per_unit
    if not spent or not units:
        return None
    dtype = run.work["dtype"]
    return 100.0 * units * sum(bound_seconds(f, b, dtype)
                               for f, b in calls) / spent


def peak_share(run, flops_per_unit, units):
    """Counted FLOPs of the window over the window and the peak, in %."""
    if not units or not run.window_s:
        return None
    return (100.0 * flops_per_unit * units / run.window_s
            / PEAK_FLOPS[run.work["dtype"]])


def forward_mfu(run):
    """The forward's counted FLOPs times the frames (or images) handed back
    in the window, over the window and the peak of the served dtype."""
    h, w = run.work["frames"]
    return peak_share(run, counts(run).forward_flops(run.config, h, w),
                      run.frames)


def step_mfu(run):
    """The step's counted FLOPs times the steps completed in the window."""
    return peak_share(run, counts(run).step_flops(run.config), run.steps)


def idle_share(run):
    """None where the trace holds no operation of the card."""
    if run.trace is None or run.trace.window_s <= 0 or not run.trace.busy_s:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
