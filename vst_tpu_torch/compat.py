"""Weights carried across: JAX ``.npz`` parameters (both ways), reference
``.pth`` state_dicts, and a JAX AdaAttN train state (Adam moments and
count) for a port run that continues it.

Counterpart of ``vst_tpu/compat/torch_params.py`` and
``vst_tpu/train/checkpoint.py::load_params``.  Both packages key their
parameters by the reference's torch ``state_dict`` names; only the conv
weight layout differs:

- Conv2d weights (every 4-D array but the ones below, 1×1 convs
  included): JAX HWIO, torch OIHW;
- ConvTranspose2d weights, the keys holding ``.deconv.`` (RTNSTV's two
  Deconv blocks, RTNSTV/network.py:48-60, the only transposed convs of
  the suite): JAX HWIO spatially flipped (the input-dilated conv form of
  ``vst_tpu/ops/conv.py::conv_transpose2d``), torch (I, O, kh, kw).
"""

import numpy as np
import torch


def _is_transpose(key: str) -> bool:
    return ".deconv." in key


def params_from_jax(params: dict) -> dict:
    """JAX-layout parameters (name → array, conv weights HWIO) → torch
    ``state_dict`` layout (name → CPU tensor, conv weights OIHW,
    transposed-conv weights (I, O, kh, kw) unflipped)."""
    out = {}
    for key, val in params.items():
        arr = np.asarray(val)
        if arr.ndim == 4:
            arr = (arr.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
                   if _is_transpose(key) else arr.transpose(3, 2, 0, 1))
        out[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def params_to_jax(state_dict: dict) -> dict:
    """The inverse of ``params_from_jax``: a torch ``state_dict`` →
    JAX-layout numpy arrays (conv weights HWIO, transposed-conv weights
    HWIO flipped), in the state's dtype."""
    out = {}
    for key, val in state_dict.items():
        arr = val.detach().cpu().numpy()
        if arr.ndim == 4:
            arr = (arr[:, :, ::-1, ::-1].transpose(2, 3, 0, 1)
                   if _is_transpose(key) else arr.transpose(2, 3, 1, 0))
        out[key] = np.ascontiguousarray(arr)
    return out


def train_state_from_jax(params: dict, mu: dict, nu: dict, count, lr: float,
                         device="cuda"):
    """A JAX AdaAttN train state carried across: the port's ``TrainState``
    holding ``params`` with the Adam moments ``mu`` / ``nu`` and update
    ``count`` of JAX's ``TrainState(params, (ScaleByAdamState(count, mu,
    nu), EmptyState()), step)``, all given as numpy dicts (conv weights and
    moments HWIO → OIHW).  ``step`` becomes ``count``.

    torch's Adam keeps the update count per parameter as a tensor and its
    bias correction reads it, so every parameter's state gets ``step`` =
    ``count``: a state without it would resume with other updates."""
    from vst_tpu_torch.models.adaattn import build
    from vst_tpu_torch.train.state import create

    # copies: the state is updated in place, and from_numpy shares memory
    weights = {k: v.clone() for k, v in params_from_jax(params).items()}
    state = create(build(weights, device), lr)
    exp_avg, exp_avg_sq = params_from_jax(mu), params_from_jax(nu)
    for name, p in state.model.named_parameters():
        state.optimizer.state[p] = {
            "step": torch.tensor(float(np.asarray(count)), dtype=torch.float32),
            "exp_avg": exp_avg[name].to(p.device, copy=True),
            "exp_avg_sq": exp_avg_sq[name].to(p.device, copy=True)}
    state.step = int(np.asarray(count))
    return state


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
