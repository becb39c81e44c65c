"""Hand-written Hopper kernels (CUDA C++ in ``csrc/``, built by
``_build.py``) and their plain PyTorch versions.

- K1 ``res_block.conv3x3_in_stats``: the residual stack's conv with
  instance-norm statistics (replaces ``vst_tpu/kernels/res_block.py``).
- K2 ``head_conv.conv3x3_valid``: the packed 3×3 conv of the 9×9 stem and
  head (replaces ``vst_tpu/kernels/head_conv.py``).
- K3 ``adaattn_attention.softmax_attention_moments``: AdaAttN's softmax
  attention moments M1, M2 and the row logsumexp (replaces the forward of
  ``vst_tpu/kernels/adaattn_attention.py``), as the forward of the
  autograd Function ``SoftmaxAttentionMoments``.
- K4 ``adaattn_attention.softmax_attention_dq`` and K5
  ``adaattn_attention.softmax_attention_dkv``: that Function's backward
  (replace ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel`` there).

Each wrapper counts its launches in ``<wrapper>.launches``.  K1 and K2
are autograd Functions too (``res_block.Conv3x3InStats``,
``head_conv.Conv3x3Valid``): the kernel forward on the card, and a
backward of library conv-gradient calls on both devices, as the JAX
package differentiates these convs with XLA's.
"""
