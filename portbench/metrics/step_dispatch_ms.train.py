"""Median host time of one ``step(state, batch)`` call, from call to
return: the step returns before the card finishes."""

from portbench.core.readers import median_ms


def read(run):
    return median_ms(run.step_dispatch_s)
