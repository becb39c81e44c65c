"""Shared CLI helpers: weight loading and checking (the stylizers, VGG,
and the evaluation trunks: LPIPS, Inception, RAFT), image input and
output.  Counterpart of ``vst_tpu/cli/common.py``."""

import sys

import numpy as np
import torch

from vst_tpu_torch.compat import load_weights, params_from_jax
from vst_tpu_torch.data.datasets import list_files, load_image
from vst_tpu_torch.device import resolve_device
from vst_tpu_torch.models import adaattn, rtnstv, vgg
from vst_tpu_torch.models.reconet import FAMILIES

__all__ = ["check_weights_match", "list_files", "load_image_255",
           "load_inception_weights", "load_lpips_weights",
           "load_raft_weights", "load_vgg_weights", "load_weights",
           "save_image_255"]


def _expected_keys(model: str, input_frame_num: int) -> set:
    with torch.device("meta"):   # the keys, without allocating the weights
        if model == "adaattn":
            return set(adaattn.StylizingNetwork().state_dict())
        if model == "rtnstv":
            return set(rtnstv.StylizingNetwork().state_dict())
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


_VGG = {"vgg19_adaattn": (vgg.init_vgg19_adaattn, vgg.build_vgg19_adaattn),
        "vgg19_rtnstv": (vgg.init_vgg19_rtnstv, vgg.build_vgg19_rtnstv),
        "vgg16": (vgg.init_vgg16_reconet, vgg.build_vgg16_reconet)}


def load_vgg_weights(path: str | None, device="cuda",
                     dtype: torch.dtype = torch.float32, seed: int = 0,
                     flavor: str = "vgg19_adaattn") -> torch.nn.Module:
    """A VGG trunk, ``flavor`` "vgg19_adaattn" (AdaAttN's), "vgg19_rtnstv"
    (RTNSTV's) or "vgg16" (ReCoNet's), from a ``.pth``/``.npz`` (a
    torchvision state_dict works), or, without a path, the JAX package's
    seeded init (smoke runs: the repository holds no pretrained weights)."""
    init, build = _VGG[flavor]
    if path is None:
        return init(seed, device, dtype)
    return build(load_weights(path), device, dtype)


def _on(state: dict, device) -> dict:
    dev = resolve_device(device)
    return {k: torch.as_tensor(v).to(dev) for k, v in state.items()}


def load_lpips_weights(vgg16_path: str | None, heads_path: str | None,
                       device="cuda", net: str = "vgg") -> dict:
    """LPIPS parameters on ``device``: a torchvision trunk state_dict
    (``.pth``, or a JAX ``.npz``) with the vendored linear heads, or,
    without a trunk path, the JAX package's seeded ``random_lpips_params``
    with its warning on stderr."""
    from vst_tpu_torch.eval.lpips import load_linear_heads, random_lpips_params

    if vgg16_path:
        params = dict(load_weights(vgg16_path))
        params.update(load_linear_heads(heads_path, net))
    else:
        print("warning: no --vgg16-weights/--lpips-weights given; "
              "using RANDOM weights (distance is meaningless)",
              file=sys.stderr)
        params = params_from_jax(random_lpips_params(0, net))
    return _on(params, device)


def load_inception_weights(path: str | None, device="cuda") -> dict:
    """InceptionV3 parameters on ``device`` from a torchvision/pytorch-fid
    ``.pth`` or a JAX ``.npz``, or, without a path, the JAX package's
    seeded ``init_inception()`` with its warning on stderr."""
    from vst_tpu_torch.eval.inception import init_inception

    if path:
        return _on(load_weights(path), device)
    print("warning: no --inception-weights; SIFID uses RANDOM "
          "Inception features", file=sys.stderr)
    return init_inception(0, device)


def load_raft_weights(path: str, device="cuda") -> dict:
    """RAFT parameters on ``device`` from a JAX ``.npz``, a ``.pth`` keyed
    as the JAX package keys them, or a torchvision ``raft_large``
    checkpoint (through the key table of ``compat_raft``)."""
    from vst_tpu_torch.compat_raft import raft_params

    return _on(raft_params(load_weights(path)), device)


def load_image_255(path, size_wh=None) -> np.ndarray:
    """PIL load as RGB (+ a BILINEAR resize to ``size_wh`` = (W, H)) → HWC
    float32 0–255."""
    return load_image(path, size_wh)


def save_image_255(arr, path):
    from PIL import Image

    Image.fromarray(np.clip(np.asarray(arr), 0, 255).astype(np.uint8)).save(path)
