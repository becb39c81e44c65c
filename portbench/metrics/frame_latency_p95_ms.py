"""The 95th percentile of the latency of every frame handed back inside
the window: from the source's hand-off to the styled frame on the host."""

from portbench.core.readers import latency_p95_ms


def read(run):
    return latency_p95_ms(run)
