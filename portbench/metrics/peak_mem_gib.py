"""``torch.cuda.max_memory_allocated()``, reset before set-up and read at
the window's end, before the reference runs."""


def read(run):
    return run.peak_bytes / 2**30 if run.peak_bytes else None
