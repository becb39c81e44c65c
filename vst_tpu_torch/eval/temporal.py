"""Temporal-consistency metrics.

Counterpart of ``vst_tpu/eval/temporal.py``:

- ``temporal_mse`` — video frame-delta MSE (ReCoNet/utilities.py:126-176,
  RTNSTV/utilities.py:243-293): mean over adjacent pairs of
  MSE(content_delta, styled_delta).
- ``temporal_error_sintel`` — Et: per-pair mean of occlusion-masked squared
  error between styled frame t and GT-flow-warped styled frame t+1, averaged
  over pairs, then sqrt (RTNSTV/utilities.py:194-240).
- ``warping_error_step`` — RAFT/precomputed-flow warping error contribution
  per frame pair (AdaAttN/exps_video.py:106-111): Σ mask·(cs2−warp(cs1))² /
  (C·H·W); callers accumulate and finish with sqrt(total/count).
  ``flow_mse`` is the flow-MSE term (exps_video.py:114).

``model_fn`` takes and returns what the port's ``stylize_*`` functions do:
a host batch (numpy) in, clamped styled frames (a tensor on the model's
device) out.  The pair terms run in float32 on the styled frames' device
(``ops/warp.py::warp``), whatever the model's dtype.
"""

import numpy as np
import torch

from vst_tpu_torch.ops.warp import warp


def _f32(x, device=None):
    """A float32 tensor of ``x`` (numpy or tensor) on ``device``."""
    x = torch.as_tensor(x)
    return x.to(device if device is not None else x.device, torch.float32)


def temporal_mse(model_fn, frames, input_frame_num: int = 1) -> float:
    """model_fn: (1, H, W, 3·f) → styled (1, H, W, 3), clamped.
    frames: iterator of HWC RGB float 0–255 arrays."""
    frames = iter(frames)
    window = []
    for _ in range(input_frame_num):
        window.append(next(frames))

    prev = None
    terms = []
    with torch.inference_mode():
        while True:
            inp = np.concatenate(window, axis=-1)[None]
            styled = _f32(model_fn(inp))[0]
            content = _f32(window[-1], styled.device)
            if prev is not None:
                x = content - prev[0]
                y = styled - prev[1]
                terms.append(torch.mean((x - y) ** 2))
            prev = (content, styled)
            try:
                nxt = next(frames)
            except StopIteration:
                break
            window.pop(0)
            window.append(nxt)
    # one read-back; the terms summed on the host in pair order, as JAX's
    total = 0.0
    for t in torch.stack(terms).tolist():
        total += t
    return total / len(terms)


def _pair(a, b, flow, mask):
    """A frame pair's inputs as float32 tensors on ``a``'s device, the
    mask broadcast over the channels."""
    a = _f32(a)
    b, flow, mask = (_f32(t, a.device) for t in (b, flow, mask))
    return a, b, flow, mask[..., None].expand(a.shape)


@torch.inference_mode()
def _et_pairs(styled0, styled1, flow, mask):
    """Per-pair Et terms over a batch of frame pairs → (B,) means."""
    styled0, styled1, flow, cmask = _pair(styled0, styled1, flow, mask)
    err = cmask * torch.square(styled0 - warp(styled1, flow))
    return torch.mean(err, dim=(1, 2, 3))


def _pad_tail(c, pad):
    if isinstance(c, torch.Tensor):
        return torch.cat([c, c[-1:].expand(pad, *c.shape[1:])])
    return np.concatenate([c, np.repeat(c[-1:], pad, axis=0)])


def map_batched(fn, stacked, batch_size: int):
    """Apply a batch fn over ``stacked`` in FIXED-size chunks.

    The tail chunk is padded by repeating the last element, so every call
    sees one shape (the JAX package's one compiled shape; here, one
    cuDNN plan and one kernel tiling); padded outputs are dropped.
    ``stacked`` may be a tuple of arrays or tensors sharing the leading
    dim.  Tensor outputs are concatenated on their device, others as
    numpy."""
    args = stacked if isinstance(stacked, tuple) else (stacked,)
    n = args[0].shape[0]
    outs = []
    for i in range(0, n, batch_size):
        chunk = [a[i:i + batch_size] for a in args]
        pad = batch_size - chunk[0].shape[0]
        if pad:
            chunk = [_pad_tail(c, pad) for c in chunk]
        out = fn(*chunk)
        if not isinstance(out, torch.Tensor):
            out = np.asarray(out)
        outs.append(out[:batch_size - pad] if pad else out)
    if isinstance(outs[0], torch.Tensor):
        return torch.cat(outs)
    return np.concatenate(outs)


def temporal_error_sintel(model_fn, frames, flows, occlusion_masks,
                          batch_size: int = 8) -> float:
    """frames: list of HWC RGB 0–255; flows[i]: (H, W, 2) GT flow t→t+1;
    occlusion_masks[i]: (H, W) with 1 = non-occluded (mask==0 pixels of the
    Sintel occlusion PNG, RTNSTV/utilities.py:228-230).

    All frames are stylized in ``batch_size`` chunks and all Et pair terms
    evaluated in batched calls on the card (the reference loops batch-1
    per frame, RTNSTV/utilities.py:208-236)."""
    n = len(flows)
    styled = _f32(map_batched(model_fn, np.stack(frames).astype(np.float32),
                              batch_size))
    dev = styled.device
    per_pair = map_batched(
        _et_pairs,
        (styled[:-1], styled[1:], _f32(np.stack(flows), dev),
         _f32(np.stack(occlusion_masks), dev)),
        batch_size)
    return float(np.sqrt(float(per_pair.sum()) / n))


@torch.inference_mode()
def warping_error_step(cs1, cs2, flow_10, mask) -> torch.Tensor:
    """Frame-pair contribution(s): masked-SSE/(C·H·W), summed over batch.

    cs1/cs2: (B, H, W, 3) styled frames; flow_10: (B, H, W, 2) backward flow;
    mask: (B, H, W).  The sum over the batch equals the reference's
    accumulation of B per-pair terms (exps_video.py:106-111), so callers may
    batch pairs freely.
    """
    return torch.sum(warping_error_terms(cs1, cs2, flow_10, mask))


@torch.inference_mode()
def warping_error_terms(cs1, cs2, flow_10, mask) -> torch.Tensor:
    """Per-pair warping-error terms → (B,) (batchable via map_batched)."""
    cs1, cs2, flow_10, cmask = _pair(cs1, cs2, flow_10, mask)
    n, h, w, c = cs1.shape
    loss = torch.sum(cmask * torch.square(cs2 - warp(cs1, flow_10)),
                     dim=(1, 2, 3))
    return loss / (c * h * w)


@torch.inference_mode()
def sintel_optical_loss_step(cs1_01, cs2_01, flow_10, mask,
                             use_mae=True) -> torch.Tensor:
    """One AdaAttN-Sintel frame-pair term (AdaAttN/exps_sintel.py:91-101).

    cs1_01/cs2_01: (B, H, W, 3) stylized frames scaled to 0–1;
    flow_10 backward flow; mask (B, H, W).  Accumulate the returned values
    (the batch is summed, equal to B accumulated per-pair terms) and finish
    with sqrt(total)/count (exps_sintel.py:110).
    ``use_mae=False`` selects the commented MSE variant.
    """
    return torch.sum(sintel_optical_loss_terms(cs1_01, cs2_01, flow_10, mask,
                                               use_mae))


@torch.inference_mode()
def sintel_optical_loss_terms(cs1_01, cs2_01, flow_10, mask,
                              use_mae=True) -> torch.Tensor:
    """Per-pair AdaAttN-Sintel terms → (B,) (batchable via map_batched)."""
    cs1_01, cs2_01, flow_10, cmask = _pair(cs1_01, cs2_01, flow_10, mask)
    diff = cs2_01 - warp(cs1_01, flow_10)
    err = torch.abs(diff) if use_mae else torch.square(diff)
    n, h, w, c = cs1_01.shape
    return torch.sum(cmask * err, dim=(1, 2, 3)) / (c * h * w)


def flow_mse(flow_a, flow_b) -> float:
    """MSE between two flow fields (AdaAttN/exps_video.py:114)."""
    return float(np.mean((np.asarray(flow_a, np.float32) -
                          np.asarray(flow_b, np.float32)) ** 2))
