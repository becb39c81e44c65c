"""vst_tpu_torch — the PyTorch + CUDA port of vst_tpu for NVIDIA Hopper.

Mirrors ``vst_tpu``'s module layout.  Imports torch and numpy only: never
JAX and nothing of ``vst_tpu``.  Activations are NHWC at the public
functions, as in the JAX package; parameters keep the reference's torch
``state_dict`` names and layouts (OIHW convolution weights).

Three serving paths run hand-written CUDA kernels on the card: ReCoNet
streaming stylization through ``kernels/res_block.py`` (K1, the residual
stack) and ``kernels/head_conv.py`` (K2, the packed 9×9 stem and head),
RTNSTV through K1, and AdaAttN arbitrary-style image, cached-style and
video serving through ``kernels/adaattn_attention.py`` (K3, the softmax
attention moments).  AdaAttN trains through K3 forward and K4/K5
backward, ReCoNet (with its SD1/SD2 students) through K1 and K2 forward
and their library conv-gradient backward, and RTNSTV through K1 the
same way, end to end from the training CLI (``cli/train.py``,
``train/loop.py``).  Evaluation (``eval/``, ``models/raft.py``,
``cli/evaluate.py``, ``cli/experiments.py``) runs its metrics and RAFT
in float32 on the card and its experiment stylizers through K1, K2 and
K3.
"""
