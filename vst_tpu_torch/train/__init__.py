"""Training of the port (counterpart of ``vst_tpu/train``): the AdaAttN
image and video step builders, their configs, the train state, the loop
(``loop.py``), checkpoints (``checkpoint.py``) and the supervisor
(``supervisor.py``).  The other trainers come with later slices."""
