"""Median host time the loop waits in ``next()`` on ``device_prefetch``."""

from portbench.core.readers import median_ms


def read(run):
    return median_ms(run.data_wait_s)
