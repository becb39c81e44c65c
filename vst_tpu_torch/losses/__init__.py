"""Loss functions of the port (counterparts of ``vst_tpu/losses``): the
AdaAttN trainers' losses and ``mse``.  ReCoNet's and RTNSTV's come with
their slices."""

from vst_tpu_torch.losses.adaattn import (
    cosine_distance,
    global_stylized_loss,
    image_similarity_loss,
    local_feature_loss,
)
from vst_tpu_torch.losses.perceptual import mse

__all__ = [
    "cosine_distance",
    "global_stylized_loss",
    "image_similarity_loss",
    "local_feature_loss",
    "mse",
]
