"""Rematerialization of model segments: ``torch.utils.checkpoint`` where
the JAX package puts ``jax.checkpoint`` (the VGG inter-tap segments, each
AdaAttN attention module, the decoder, the conv-free loss target)."""

from torch.utils.checkpoint import checkpoint


def segment(fn, remat: bool):
    """``fn`` itself, or ``fn`` checkpointed (non-reentrant): only its
    inputs and outputs survive the forward, and the backward recomputes
    what lies between."""
    if not remat:
        return fn
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)
