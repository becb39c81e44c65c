"""Batch stylization: the ReCoNet family, RTNSTV and AdaAttN.

Counterpart of ``vst_tpu/infer/image.py`` (``stylize_reconet``,
``stylize_rtnstv``, ``_finish``, ``stylize_adaattn``,
``adaattn_style_state``, ``stylize_adaattn_cached``; parity:
ReCoNet/inference/infer.py, RTNSTV/infer.py, AdaAttN/infer_image.py,
AdaAttN/infer_image_all.py).  Inputs may be
numpy arrays or tensors, uint8 or float 0–255; they are copied to the
model's device (without blocking from pinned host memory) and cast there
to the parameters' dtype.
"""

import numpy as np
import torch

from vst_tpu_torch.models import adaattn as adaattn_m
from vst_tpu_torch.ops.yuv import rgb_to_i420


def _finish(styled, uint8_out, wire="rgb"):
    """Clamp to 0–255, then optionally the truncating uint8 cast (the
    reference's numpy conversion, ReCoNet/utilities.py:217-219) or, with
    ``wire="i420"``, YUV 4:2:0 packing on the device (1.5 B/px)."""
    styled = torch.clamp(styled, 0, 255)
    if wire == "i420":
        return rgb_to_i420(styled)
    return styled.to(torch.uint8) if uint8_out else styled


@torch.inference_mode()
def stylize_reconet(model, x, uint8_out: bool = False, wire: str = "rgb"):
    """x: (N, H, W, 3·frames) 0–255, uint8 or float, numpy or tensor →
    clamped styled frames on the model's device.

    The input is copied to the model's device (without blocking when it
    is pinned host memory) and cast there to the parameters' dtype, so a
    host can ship raw uint8 frames."""
    _check_wire(wire)
    return _finish(model(_on_model(model, x))[-1], uint8_out, wire)


@torch.inference_mode()
def stylize_rtnstv(model, x, uint8_out: bool = False, wire: str = "rgb"):
    """``stylize_reconet`` for an RTNSTV ``StylizingNetwork``, whose
    forward returns the styled frames alone: x (N, H, W, 3) 0–255 →
    clamped styled frames (uint8, or I420 with ``wire="i420"``) on the
    model's device."""
    _check_wire(wire)
    return _finish(model(_on_model(model, x)), uint8_out, wire)


def _check_wire(wire):
    if wire not in ("rgb", "i420"):
        raise ValueError(f"wire must be 'rgb' or 'i420', got {wire!r}")


def _on_model(model, x):
    """``x`` on the model's device in the parameters' dtype."""
    p = next(model.parameters())
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    return x.to(p.device, non_blocking=True).to(p.dtype)


@torch.inference_mode()
def stylize_adaattn(vgg, model, content, style, activation: str = "softmax"):
    """Arbitrary-style transfer (AdaAttN/infer_image.py:55-60): content and
    style (N, H, W, 3) 0–255 → styled (N, H, W, 3) clamped to 0–255, in the
    parameters' dtype on the model's device."""
    fc = vgg(_on_model(vgg, content))
    fs = vgg(_on_model(vgg, style))
    return torch.clamp(adaattn_m.stylizing_network(model, fc, fs, activation),
                       0, 255)


@torch.inference_mode()
def adaattn_style_state(vgg, model, style, activation: str = "softmax"):
    """One style (batch 1) encoded into the reusable per-style attention
    state (``models/adaattn.py::style_state``): one VGG pass and the g/h
    convs, however many contents it then serves."""
    return adaattn_m.style_state(model, vgg(_on_model(vgg, style)), activation)


@torch.inference_mode()
def stylize_adaattn_cached(vgg, model, content, state,
                           activation: str = "softmax"):
    """``stylize_adaattn`` against a precomputed ``adaattn_style_state``:
    the same output without the per-call style-side work."""
    fc = vgg(_on_model(vgg, content))
    return torch.clamp(
        adaattn_m.stylizing_network_cached(model, fc, state, activation), 0, 255)
