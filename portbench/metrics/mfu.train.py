"""The step's counted FLOPs (``counts/<config>.py``) times the steps
completed in the window, over the window and the card's peak (float32
against TF32's), in %."""

from portbench.core.readers import step_mfu


def read(run):
    return step_mfu(run)
