"""Training of the port (counterpart of ``vst_tpu/train``): the AdaAttN
image and video step builders, their configs and the train state.  The
loop, checkpoints and the other trainers come with later slices."""
