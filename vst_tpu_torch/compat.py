"""Weights carried across: JAX ``.npz`` parameters (both ways), reference
``.pth`` state_dicts.

Counterpart of ``vst_tpu/compat/torch_params.py`` and
``vst_tpu/train/checkpoint.py::load_params``.  Both packages key their
parameters by the reference's torch ``state_dict`` names; only the conv
weight layout differs (JAX HWIO, torch OIHW).  Neither the ReCoNet family
nor AdaAttN and its VGG19 has a transposed convolution, so every 4-D array
(1×1 convs included) is a Conv2d weight.
"""

import numpy as np
import torch


def params_from_jax(params: dict) -> dict:
    """JAX-layout parameters (name → array, conv weights HWIO) → torch
    ``state_dict`` layout (name → CPU tensor, conv weights OIHW)."""
    out = {}
    for key, val in params.items():
        arr = np.asarray(val)
        if arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        out[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def params_to_jax(state_dict: dict) -> dict:
    """The inverse of ``params_from_jax``: a torch ``state_dict`` →
    JAX-layout numpy arrays (conv weights HWIO), in the state's dtype."""
    out = {}
    for key, val in state_dict.items():
        arr = val.detach().cpu().numpy()
        if arr.ndim == 4:
            arr = arr.transpose(2, 3, 1, 0)
        out[key] = np.ascontiguousarray(arr)
    return out


def load_weights(path: str) -> dict:
    """A torch ``state_dict`` from a reference ``.pth``/``.pt`` (read as
    it is) or from a JAX ``.npz`` (through ``params_from_jax``)."""
    if path.endswith(".npz"):
        with np.load(path) as data:
            return params_from_jax({k: data[k] for k in data.files})
    if path.endswith((".pth", ".pt")):
        return torch.load(path, map_location="cpu", weights_only=True)
    raise ValueError(f"unsupported weight format: {path}")


def save_pth(state, path: str) -> None:
    """Write a module's (or a state_dict's) parameters as a reference-layout
    ``.pth`` of contiguous CPU tensors."""
    if isinstance(state, torch.nn.Module):
        state = state.state_dict()
    torch.save({k: v.detach().cpu().contiguous() for k, v in state.items()},
               path)
