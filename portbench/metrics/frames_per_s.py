"""Styled frames handed back on the host inside the window, over the
window's seconds."""

from portbench.core.readers import window_rate


def read(run):
    return window_rate(run)
