"""Evaluation suite: the quantitative metrics of AdaAttN/eval.py plus the
temporal metrics of the ReCoNet/RTNSTV utilities.  Counterpart of
``vst_tpu/eval``, with the same exported names.

The network metrics (SSIM, Gram, LPIPS, Inception/SIFID statistics) and
the temporal pair terms run on the card in float32 with TF32 off, the
histogram metrics and the Fréchet distance on the host."""

from vst_tpu_torch.eval.ssim import ssim
from vst_tpu_torch.eval.histogram import (
    compute_histogram,
    kl_divergence_rgb,
    nth_order_moment,
    uniformity,
    average_entropy,
)
from vst_tpu_torch.eval.gram import gram_loss_5tap
from vst_tpu_torch.eval.temporal import (
    flow_mse,
    sintel_optical_loss_terms,
    temporal_mse,
    temporal_error_sintel,
    warping_error_step,
    warping_error_terms,
)
from vst_tpu_torch.eval.lpips import (
    image_to_lpips_input,
    load_linear_heads,
    lpips_distance,
    lpips_vgg,
)
from vst_tpu_torch.eval.lpips_trainer import bce_ranking_loss, score_2afc
from vst_tpu_torch.eval.inception import inception_blocks, init_inception
from vst_tpu_torch.eval.sifid import frechet_distance, sifid

__all__ = [
    "ssim",
    "compute_histogram",
    "kl_divergence_rgb",
    "nth_order_moment",
    "uniformity",
    "average_entropy",
    "gram_loss_5tap",
    "temporal_mse",
    "temporal_error_sintel",
    "warping_error_step",
    "warping_error_terms",
    "sintel_optical_loss_terms",
    "flow_mse",
    "image_to_lpips_input",
    "load_linear_heads",
    "lpips_distance",
    "lpips_vgg",
    "bce_ranking_loss",
    "score_2afc",
    "inception_blocks",
    "init_inception",
    "frechet_distance",
    "sifid",
]
