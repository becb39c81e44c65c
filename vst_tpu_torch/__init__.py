"""vst_tpu_torch — the PyTorch + CUDA port of vst_tpu for NVIDIA Hopper.

Mirrors ``vst_tpu``'s module layout.  Imports torch and numpy only: never
JAX and nothing of ``vst_tpu``.  Activations are NHWC at the public
functions, as in the JAX package; parameters keep the reference's torch
``state_dict`` names and layouts (OIHW convolution weights).

The main path (ReCoNet streaming stylization) runs two hand-written
CUDA kernels on the card: ``kernels/res_block.py`` (K1, the residual
stack) and ``kernels/head_conv.py`` (K2, the packed 9×9 stem and head).
"""
