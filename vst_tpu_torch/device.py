"""Device resolution and the float32 precision policy.

Counterpart of ``vst_tpu/ops/_precision.py``.  The port computes at the
dtype of its parameters: bfloat16 on the card for serving, float32 for
parity.  Float32 means true float32: the JAX package runs f32 matmuls and
convs at HIGHEST precision, while cuDNN runs f32 convolutions in TF32 by
default, so f32 work turns TF32 off for both cuDNN and cuBLAS.
"""

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU.  Never falls back to the CPU silently."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (or "
            "--device cpu) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def apply_precision(dtype: torch.dtype) -> None:
    """Float32 compute runs at full float32: TF32 off for convs and
    matmuls (JAX's Precision.HIGHEST).  bfloat16 needs no switch."""
    if dtype == torch.float32:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
