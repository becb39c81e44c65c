"""Loss functions of the port (counterparts of ``vst_tpu/losses``): the
AdaAttN trainers' losses, and ReCoNet's and RTNSTV's perceptual and
temporal losses."""

from vst_tpu_torch.losses.adaattn import (
    cosine_distance,
    global_stylized_loss,
    image_similarity_loss,
    local_feature_loss,
)
from vst_tpu_torch.losses.perceptual import (
    mse,
    reconet_content_loss,
    reconet_reg_loss,
    reconet_style_loss,
    rtnstv_spatial_loss,
)
from vst_tpu_torch.losses.temporal import (
    reconet_feature_temporal_loss,
    reconet_output_temporal_loss,
    rtnstv_temporal_loss,
)

__all__ = [
    "cosine_distance",
    "global_stylized_loss",
    "image_similarity_loss",
    "local_feature_loss",
    "mse",
    "reconet_content_loss",
    "reconet_feature_temporal_loss",
    "reconet_output_temporal_loss",
    "reconet_reg_loss",
    "reconet_style_loss",
    "rtnstv_spatial_loss",
    "rtnstv_temporal_loss",
]
