"""Shared CLI helpers: weight loading and checking, image input and
output.  Counterpart of ``vst_tpu/cli/common.py``."""

import os

import numpy as np
import torch

from vst_tpu_torch.compat import load_weights
from vst_tpu_torch.models import adaattn, vgg
from vst_tpu_torch.models.reconet import FAMILIES

__all__ = ["check_weights_match", "list_files", "load_image_255",
           "load_vgg_weights", "load_weights", "save_image_255"]


def _expected_keys(model: str, input_frame_num: int) -> set:
    with torch.device("meta"):   # the keys, without allocating the weights
        if model == "adaattn":
            return set(adaattn.StylizingNetwork().state_dict())
        return set(FAMILIES[model](input_frame_num).state_dict())


def check_weights_match(state: dict, model: str, path: str,
                        input_frame_num: int = 1) -> None:
    """Fail fast with a readable message when a checkpoint does not belong
    to the requested model family."""
    missing = sorted(_expected_keys(model, input_frame_num) - set(state))
    if missing:
        raise SystemExit(
            f"error: {path} does not look like a '{model}' checkpoint "
            f"(missing keys e.g. {missing[:3]}); pass the matching --model")


def load_vgg_weights(path: str | None, device="cuda",
                     dtype: torch.dtype = torch.float32,
                     seed: int = 0) -> torch.nn.Module:
    """AdaAttN's VGG19 trunk from a ``.pth``/``.npz`` (a torchvision
    state_dict works), or, without a path, the JAX package's seeded init
    (smoke runs: the repository holds no pretrained weights)."""
    if path is None:
        return vgg.init_vgg19_adaattn(seed, device, dtype)
    return vgg.build_vgg19_adaattn(load_weights(path), device, dtype)


def load_image_255(path, size_wh=None) -> np.ndarray:
    """PIL load as RGB (+ a BILINEAR resize to ``size_wh`` = (W, H)) → HWC
    float32 0–255, as ``vst_tpu/data/datasets.py::load_image``."""
    from PIL import Image

    img = Image.open(path).convert("RGB")
    if size_wh is not None and img.size != tuple(size_wh):
        img = img.resize(tuple(size_wh), Image.BILINEAR)
    return np.asarray(img, dtype=np.float32)


def list_files(directory) -> list:
    return sorted(f.path for f in os.scandir(directory) if f.is_file())


def save_image_255(arr, path):
    from PIL import Image

    Image.fromarray(np.clip(np.asarray(arr), 0, 255).astype(np.uint8)).save(path)
