"""Trainer configurations.  Counterpart of ``vst_tpu/train/config.py``:
the ReCoNet, RTNSTV and AdaAttN configs, with the same fields and defaults
(parity: ReCoNet/train_single/train_candy.py:19-29, train_coco2014.py:
19-25, train_Flow_SD1.py:19-30, train_multiple/train_Flow.py:22;
RTNSTV/train.py:21-33; AdaAttN/train_image.py, train_video.py).
``img_size`` is (H, W).
"""

import dataclasses


@dataclasses.dataclass(frozen=True)
class ReCoNetFlowConfig:
    """The full ReCoNet objective with temporal losses."""
    lr: float = 1e-3
    alpha: float = 1e5          # content
    beta: float = 2e10          # style
    gamma: float = 1e-2         # total variation (raw sum)
    lambda_f: float = 1e12      # feature temporal
    lambda_o: float = 1e7       # output temporal
    batch_size: int = 2
    epochs: int = 3
    input_frame_num: int = 1
    img_size: tuple[int, int] = (360, 640)
    use_ftl: bool = True
    dtype: str = "float32"
    remat: bool = False


RECONET_CANDY = ReCoNetFlowConfig()
RECONET_STARRY_NIGHT = ReCoNetFlowConfig(beta=1e11, epochs=6)
RECONET_NOFTL = ReCoNetFlowConfig(beta=1e10, epochs=2, use_ftl=False)
RECONET_MULTIFRAME = ReCoNetFlowConfig(input_frame_num=4, epochs=10)


@dataclasses.dataclass(frozen=True)
class ReCoNetCocoConfig:
    """Image-only (content + style) ReCoNet training."""
    lr: float = 1e-3
    alpha: float = 1e5
    beta: float = 1e10
    batch_size: int = 4
    epochs: int = 10
    img_size: tuple[int, int] = (256, 256)
    dtype: str = "float32"
    remat: bool = False


@dataclasses.dataclass(frozen=True)
class ReCoNetDistillConfig:
    """Teacher → student distillation (the SD1 and SD2 stages).

    The symmetric distillation loss is computed and logged but left out
    of the total, as the reference does (train_Flow_SD1.py:155-162), unless
    ``include_sd_in_total``.  ``teacher``/``student`` are ReCoNet family
    names ("reconet", "sd1", "sd2"); the tap indices pick the forward
    output each side feeds the SD loss (train_Flow_SD1.py:83-86,
    train_Flow_SD2.py:83-86).  The SD1 stage pairs a 96-channel teacher
    tap with a 64-channel student tap, which cannot broadcast: the step
    reports that SD loss as NaN."""
    teacher: str = "reconet"
    student: str = "sd1"
    teacher_tap: int = 0
    student_tap: int = 1
    lr: float = 1e-3
    alpha: float = 1e5
    beta: float = 1e10
    gamma: float = 1e-2
    lambda_f: float = 1e11
    lambda_o: float = 1e7
    sd_weight_scale: float = 0.01   # sd_loss *= sd_weight_scale * beta
    include_sd_in_total: bool = False
    batch_size: int = 2
    epochs: int = 20
    input_frame_num: int = 1
    img_size: tuple[int, int] = (360, 640)
    dtype: str = "float32"
    remat: bool = False


DISTILL_SD1 = ReCoNetDistillConfig()
DISTILL_SD2 = ReCoNetDistillConfig(
    teacher="sd1", student="sd2", teacher_tap=0, student_tap=0, epochs=10)


@dataclasses.dataclass(frozen=True)
class RTNSTVConfig:
    lr: float = 1e-3
    alpha: float = 1e7          # content
    beta: float = 5e7           # style
    gamma: float = 5e-1         # sqrt-TV
    lam: float = 1e6            # temporal
    batch_size: int = 2
    epochs: int = 10
    img_size: tuple[int, int] = (360, 640)
    dtype: str = "float32"
    remat: bool = False


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
