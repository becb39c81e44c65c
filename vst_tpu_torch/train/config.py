"""Trainer configurations.  Counterpart of ``vst_tpu/train/config.py``:
the AdaAttN configs, with the same fields and defaults (parity:
AdaAttN/train_image.py, train_video.py).  The other trainers' configs
come with their slices."""

import dataclasses


@dataclasses.dataclass(frozen=True)
class AdaAttNImageConfig:
    lr: float = 1e-4
    lambda_g: float = 10.0
    lambda_l: float = 3.0
    batch_size: int = 8
    epochs: int = 10
    activation: str = "softmax"
    crop_size: tuple[int, int] = (256, 256)
    dtype: str = "float32"
    remat: bool = False
    # attention evaluation for both the stylizer and the conv-free loss
    # targets (models/adaattn.py::attention_moments): "train" (softmax
    # through K3 forward and K4/K5 backward on the card), "exact", or any
    # other mode the model takes
    attention_mode: str = "train"


@dataclasses.dataclass(frozen=True)
class AdaAttNVideoConfig:
    lr: float = 1e-4
    lambda_g: float = 10.0
    lambda_l: float = 3.0
    lambda_is: float = 100.0
    batch_size: int = 4
    epochs: int = 10
    activation: str = "cosine"
    frame_size: tuple[int, int] = (256, 512)
    dtype: str = "float32"
    remat: bool = False
    attention_mode: str = "train"
