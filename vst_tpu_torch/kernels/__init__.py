"""Hand-written Hopper kernels (CUDA C++ in ``csrc/``, built by
``_build.py``) and their plain PyTorch versions.

- K1 ``res_block.conv3x3_in_stats``: the residual stack's conv with
  instance-norm statistics (replaces ``vst_tpu/kernels/res_block.py``).
- K2 ``head_conv.conv3x3_valid``: the packed 3×3 conv of the 9×9 stem and
  head (replaces ``vst_tpu/kernels/head_conv.py``).

Each wrapper counts its launches in ``<wrapper>.launches``.
"""
