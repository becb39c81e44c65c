"""Median host time of one batch call, from call to return (the enqueue),
from the benchmark's wrapper around the function it hands the port."""

from portbench.core.readers import median_ms


def read(run):
    return median_ms(run.dispatch_s)
