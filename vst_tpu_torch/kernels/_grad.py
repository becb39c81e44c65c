"""The guard of the kernels that have no backward yet (K1, K2).

Their wrappers fill a plain buffer through ctypes, which autograd does
not track: a forward that needs a gradient would run and leave the
parameters before the kernel without one.  ``refuse_grad`` raises there
instead, before the launch.
"""

import torch


def refuse_grad(kernel: str, *tensors) -> None:
    """Raises a ``RuntimeError`` naming ``kernel`` when grad mode is on and
    any of ``tensors`` (``None`` allowed) requires a gradient."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel} has no backward yet: its forward on the card cannot "
            "carry a gradient; run it under torch.inference_mode() or "
            "torch.no_grad(), or on CPU tensors, whose plain version is "
            "differentiable")
