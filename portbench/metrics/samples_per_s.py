"""Samples of the train steps completed in the window, over the window's
seconds (the window ends with ``torch.cuda.synchronize()``)."""

from portbench.core.readers import sample_rate


def read(run):
    return sample_rate(run)
