"""From the start of the process to the start of the window: imports, the
CUDA context, the kernels' build (first run of a checkout only), seeded
weights and inputs on the card, the warm-up of the cell's shapes."""


def read(run):
    return run.setup_s
