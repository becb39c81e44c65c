"""The forward's counted FLOPs (``counts/<config>.py``) times the frames
handed back in the window, over the window and the card's peak in the
served dtype, in %."""

from portbench.core.readers import forward_mfu


def read(run):
    return forward_mfu(run)
