"""The train state: float32 master model, Adam, step count.

Counterpart of ``vst_tpu/train/state.py``.  ``torch.optim.Adam(lr,
betas=(0.9, 0.999), eps=1e-8)`` is the same update as the JAX package's
``optax.adam`` and the reference's ``optim.Adam``: bias-corrected moments,
eps added to the corrected root.  Unlike JAX's immutable state, this one
is updated in place: ``apply_gradients`` steps the optimizer on the
masters' ``.grad``.
"""

import dataclasses

import torch


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module            # float32 master parameters
    optimizer: torch.optim.Optimizer
    step: int = 0


def make_optimizer(params, lr: float) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def create(model: torch.nn.Module, lr: float) -> TrainState:
    """A state at step 0 around ``model``, whose parameters must be
    float32 (the masters mixed precision casts from)."""
    bad = [k for k, p in model.named_parameters() if p.dtype != torch.float32]
    if bad:
        raise TypeError(f"master parameters must be float32: {bad[:3]}")
    return TrainState(model, make_optimizer(model.parameters(), lr))


def apply_gradients(state: TrainState) -> TrainState:
    """One optimizer update from the gradients accumulated in ``.grad``."""
    state.optimizer.step()
    state.step += 1
    return state
