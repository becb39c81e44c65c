"""The run's guards: a card present, and no JAX in the process."""

import sys

BANNED = ("jax", "jaxlib", "flax", "vst_tpu")


def banned_modules(modules=None):
    """Top-level names in ``sys.modules`` (or ``modules``) that are JAX's or
    the JAX package's, compared whole: ``vst_tpu_torch`` is not
    ``vst_tpu``."""
    names = sys.modules if modules is None else modules
    return sorted({n.split(".")[0] for n in names} & set(BANNED))


def card_count():
    import torch

    if not torch.cuda.is_available():
        return 0
    return torch.cuda.device_count()
