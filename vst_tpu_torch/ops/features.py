"""Multi-scale feature pyramid.  Counterpart of ``vst_tpu/ops/features.py``
(parity: AdaAttN/utilities.py:98-109)."""

from collections.abc import Sequence

import torch

from vst_tpu_torch.ops.resize import resize_bilinear


def feature_down_sample(feats: Sequence[torch.Tensor],
                        last_feat_idx: int, spatial=None) -> torch.Tensor:
    """feats[0..last_feat_idx] bilinearly resized to feats[last_feat_idx]'s
    spatial size and concatenated along channels (NHWC).

    ``spatial``: the feats are row blocks of an H-sharded frame; each
    factor (2–16 on AdaAttN's VGG19 taps) must divide its block's rows,
    so every source row lies in the block (``resize_bilinear`` raises
    otherwise)."""
    target = feats[last_feat_idx]
    size = tuple(target.shape[1:3])
    parts = [resize_bilinear(feats[i], size, spatial)
             for i in range(last_feat_idx)]
    return torch.cat(parts + [target], dim=-1)
