"""Batch stylization: the ReCoNet family, RTNSTV and AdaAttN.

Counterpart of ``vst_tpu/infer/image.py`` (``stylize_reconet``,
``stylize_rtnstv``, ``_finish``, ``stylize_adaattn``,
``adaattn_style_state``, ``stylize_adaattn_cached``, and the H-sharded
``stylize_spatial_sharded`` and ``stylize_adaattn_sharded``; parity:
ReCoNet/inference/infer.py, RTNSTV/infer.py, AdaAttN/infer_image.py,
AdaAttN/infer_image_all.py).  Inputs may be
numpy arrays or tensors, uint8 or float 0–255; they are copied to the
model's device (without blocking from pinned host memory) and cast there
to the parameters' dtype (the span "vst::serve.to_model"); the clamp and
the output's packing run in "vst::serve.finish".
"""

import numpy as np
import torch

from vst_tpu_torch.models import adaattn as adaattn_m
from vst_tpu_torch.ops.yuv import rgb_to_i420
from vst_tpu_torch.utils.profiling import span


def _finish(styled, uint8_out, wire="rgb"):
    """Clamp to 0–255, then optionally the truncating uint8 cast (the
    reference's numpy conversion, ReCoNet/utilities.py:217-219) or, with
    ``wire="i420"``, YUV 4:2:0 packing on the device (1.5 B/px)."""
    with span("vst::serve.finish"):
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
    with span("vst::serve.to_model"):
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
    return _finish(adaattn_m.stylizing_network(model, fc, fs, activation),
                   False)


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
    return _finish(
        adaattn_m.stylizing_network_cached(model, fc, state, activation),
        False)


# ------------------------------------------------ H-sharded (spatial) serving

def _spatial_setup(model, mesh, axis):
    from vst_tpu_torch.parallel.spatial import SpatialContext

    ctx = SpatialContext(mesh, axis)
    dev = next(model.parameters()).device
    if dev != mesh.device:
        raise ValueError(f"the model is on {dev}, this rank's mesh device "
                         f"is {mesh.device}")
    return ctx


@torch.inference_mode()
def stylize_spatial_sharded(model, x, mesh, axis: str = "space"):
    """High-resolution stylization with the frame's H axis sharded over
    ``axis`` of ``mesh`` (``parallel/mesh.py``), for frames beyond one
    card's comfortable working set (4K).  Every rank calls it with the full
    frame x (N, H, W, 3·frames) 0–255, as JAX's callers pass it, and gets
    back **its own rows** of the clamped styled frames on its device: its
    shard of JAX's H-sharded result (``parallel.spatial.gather_rows``
    assembles the frame).

    ``model`` is a ReCoNet-family model or an RTNSTV ``StylizingNetwork``
    on this rank's device.  H must divide by the axis size D, as JAX's
    placement asks.  The model runs on ``row_layout(H, D, 4)``: blocks of
    whole 4-row units (its two stride-2 layers line up in each), any
    remainder on the last, each rank's rows taken straight from x (only
    they cross to the device); where 4·D divides H that is the H/D rows
    of JAX's placement.  Otherwise the styled rows move back to JAX's
    placement in one ``relayout_rows`` before the clamp.  The layers
    exchange their halo rows over the axis and K1 runs in its halo-rows
    mode (``parallel/spatial.py``).  A block needs at least 8 rows (the
    9×9 stem's reflect): ``ValueError`` below that, naming the least H
    for this D (8·D).  A frame whose H is not a multiple of 4 comes out
    4·⌈H/4⌉ rows high, as the unsharded model's does, in JAX's placement
    of those rows (``parallel.spatial.placement``: ⌈4·⌈H/4⌉/D⌉ a rank, the
    last ones shorter where D does not divide them; pass their rows to
    ``gather_rows`` as ``sizes``)."""
    from vst_tpu_torch.parallel import spatial as sp

    ctx = _spatial_setup(model, mesh, axis)
    x = torch.from_numpy(x) if isinstance(x, np.ndarray) else x
    ctx.bounds = sp.layout_for(ctx, x.shape[1], 4, "stylize_spatial_sharded")
    start, end = ctx.bounds[ctx.index]
    out = model(_on_model(model, x[:, start:end]), spatial=ctx)
    out = out[-1] if isinstance(out, tuple) else out
    # every block but the last holds whole units, so keeps its rows; the
    # last ends at the output's 4·⌈H/4⌉
    h_out = -(-x.shape[1] // 4) * 4
    src = ctx.bounds[:-1] + ((ctx.bounds[-1][0], h_out),)
    out = sp.relayout_rows(ctx, out, src, sp.placement(h_out, ctx.size))
    return _finish(out, False)


@torch.inference_mode()
def stylize_adaattn_sharded(vgg, model, content, style, mesh,
                            activation: str = "cosine", axis: str = "space"):
    """AdaAttN with the content's H axis sharded over ``axis`` of ``mesh``:
    VGG19 encode, attention and decoder on each rank's row block.  Every
    rank passes the full content (N, H, W, 3) and style, and gets back its
    own rows of the clamped styled frames on its device.

    The style (batch 1 is broadcast to the content batch) is encoded whole
    on every rank, as JAX replicates it; each rank's queries, a contiguous
    token range, meet the whole style's K/V in one ``attention_moments``
    call a level (K3 for softmax, the linear form for cosine), so the
    attention needs no collective.  H must divide by 16 times the axis
    size (every VGG tap's rows split evenly).  Defaults as JAX's:
    ``activation="cosine"``, ``axis="space"``."""
    from vst_tpu_torch.parallel.mesh import shard_spatial

    ctx = _spatial_setup(vgg, mesh, axis)
    h = content.shape[1]
    if h % (16 * ctx.size):
        raise ValueError(f"stylize_adaattn_sharded: content H {h} must "
                         f"divide by 16·{ctx.size} = {16 * ctx.size}")
    fc = vgg(_on_model(vgg, shard_spatial(mesh, content, axis)),
             spatial=ctx)
    fs = vgg(_on_model(vgg, style))
    n = content.shape[0]
    fs = {k: v.expand(n, *v.shape[1:]) for k, v in fs.items()}
    return _finish(adaattn_m.stylizing_network(model, fc, fs, activation,
                                               spatial=ctx), False)
