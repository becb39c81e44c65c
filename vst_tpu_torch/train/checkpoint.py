"""Checkpoints: parameters, the full train state, reference ``.pth``
interop.  Counterpart of ``vst_tpu/train/checkpoint.py``.

- ``save_params`` / ``load_params``: parameters as ``.npz`` in the JAX
  layout (conv weights HWIO, through ``compat.params_to_jax``), so an epoch
  ``.npz`` written by either package loads into the other.
- ``save_state`` / ``load_state``: the whole ``TrainState`` (model and
  optimizer ``state_dict``, ``step``) in one versioned ``torch.save`` file,
  written beside the target and renamed over it, so a crash mid-save never
  destroys the only checkpoint.  JAX's orbax directories are not read.
- ``snapshot`` / ``restore``: a host copy of the state and its load back
  into the live model and optimizer (the loop's rollback).
- ``export_pth`` / ``import_pth``, ``partial_init_from`` and
  ``epoch_checkpoint_name``, as in JAX.
"""

import os

import numpy as np
import torch

from vst_tpu_torch.compat import load_weights, params_to_jax, save_pth
from vst_tpu_torch.train.state import TrainState

# Bumped when the saved layout changes, so a layout change fails loudly
# instead of silently orphaning old checkpoints.
STATE_VERSION = 1


def _makedirs_for(path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)


def _state_dict(params) -> dict:
    return params.state_dict() if isinstance(params, torch.nn.Module) \
        else params


def save_params(params, path: str) -> None:
    """A module's (or a state_dict's) parameters as a JAX-layout ``.npz``."""
    _makedirs_for(path)
    np.savez(path, **params_to_jax(_state_dict(params)))


def load_params(path: str) -> dict:
    """A JAX-layout ``.npz`` as a torch ``state_dict`` (CPU tensors)."""
    return load_weights(path)


def _host_copy(tree):
    """Tensors of a nested dict/list/tuple cloned to host memory; other
    leaves as they are.  ``state_dict()`` returns views of the live
    tensors, which the next optimizer step overwrites in place."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_copy(v) for v in tree)
    return tree


def snapshot(state: TrainState) -> dict:
    """The state's payload (what ``save_state`` writes), cloned to host
    memory."""
    return {"model": _host_copy(state.model.state_dict()),
            "optimizer": _host_copy(state.optimizer.state_dict()),
            "step": int(state.step)}


def restore(state: TrainState, snap: dict) -> TrainState:
    """Load a ``snapshot`` into the live model and optimizer.  The step
    counter is kept: it counts batches consumed, the resume position.
    The optimizer takes a fresh copy, since ``load_state_dict`` keeps
    tensors that are already on the parameters' device, and the next
    step would update the snapshot in place."""
    state.model.load_state_dict(snap["model"])
    state.optimizer.load_state_dict(_host_copy(snap["optimizer"]))
    return state


def save_state(state, path: str) -> None:
    """Write a resumable full-state checkpoint of a ``TrainState`` (or of
    its ``snapshot``) to ``path``: one ``torch.save`` file, written to
    ``path + ".tmp"`` and then renamed over ``path``."""
    payload = state if isinstance(state, dict) else snapshot(state)
    _makedirs_for(path)
    tmp = path + ".tmp"
    torch.save({"__vst_state_version__": STATE_VERSION, **payload}, tmp)
    os.replace(tmp, path)


def load_state(path: str, like: TrainState) -> TrainState:
    """Load a ``save_state`` checkpoint into ``like`` (a freshly created
    ``TrainState`` of the same model and optimizer) and return it."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    version = obj.get("__vst_state_version__")
    if not isinstance(version, int) or version > STATE_VERSION:
        raise ValueError(f"checkpoint {path} has state version {version}; "
                         f"this build reads ≤{STATE_VERSION}")
    like.model.load_state_dict(obj["model"])
    like.optimizer.load_state_dict(obj["optimizer"])
    like.step = int(obj["step"])
    return like


def export_pth(params, path: str) -> None:
    """Write parameters as a torch state_dict loadable by the reference
    models."""
    _makedirs_for(path)
    save_pth(params, path)


def import_pth(path: str, strict_keys: set[str] | None = None) -> dict:
    """Load a reference ``.pth`` checkpoint as a state_dict.

    ``strict_keys``: if given, the checkpoint must cover exactly these
    keys (torch ``strict=True``, ReCoNet/utilities.py:190); otherwise all
    its entries are returned (``strict=False`` teacher → student init,
    train_Flow_SD1.py:45, through ``partial_init_from``)."""
    params = torch.load(path, map_location="cpu", weights_only=True)
    if strict_keys is not None:
        missing = strict_keys - set(params)
        unexpected = set(params) - strict_keys
        if missing or unexpected:
            raise ValueError(
                f"strict load failed: missing={sorted(missing)[:5]} "
                f"unexpected={sorted(unexpected)[:5]}")
    return params


def partial_init_from(params: dict, donor: dict) -> dict:
    """Copy name-matching, shape-matching entries of ``donor`` into a copy of
    ``params`` (torch ``load_state_dict(strict=False)`` semantics used for
    teacher → student initialization)."""
    out = dict(params)
    for k, v in donor.items():
        if k in out and tuple(out[k].shape) == tuple(v.shape):
            out[k] = v
    return out


def epoch_checkpoint_name(model_name: str, epoch: int, batch_size: int) -> str:
    """Reference naming convention (e.g. train_candy.py:170)."""
    return f"{model_name}_epoch_{epoch}_batchSize_{batch_size}"
