"""The 95th percentile of the latency of every image handed back inside
the window: from the call that takes its batch to the styled image on the
host."""

from portbench.core.readers import latency_p95_ms


def read(run):
    return latency_p95_ms(run)
