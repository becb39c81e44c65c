"""Shared CLI helpers: weight loading and checking, image output.
Counterpart of ``vst_tpu/cli/common.py``."""

import numpy as np

from vst_tpu_torch.compat import load_weights
from vst_tpu_torch.models.reconet import FAMILIES

__all__ = ["check_weights_match", "load_weights", "save_image_255"]


def check_weights_match(state: dict, model: str, path: str,
                        input_frame_num: int = 1) -> None:
    """Fail fast with a readable message when a checkpoint does not belong
    to the requested model family."""
    expected = set(FAMILIES[model](input_frame_num).state_dict())
    missing = sorted(expected - set(state))
    if missing:
        raise SystemExit(
            f"error: {path} does not look like a '{model}' checkpoint "
            f"(missing keys e.g. {missing[:3]}); pass the matching --model")


def save_image_255(arr, path):
    from PIL import Image

    Image.fromarray(np.clip(np.asarray(arr), 0, 255).astype(np.uint8)).save(path)
