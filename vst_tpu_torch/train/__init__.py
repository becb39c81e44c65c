"""Training of the port (counterpart of ``vst_tpu/train``): the ReCoNet
flow, coco and distillation step builders, RTNSTV's and the AdaAttN image
and video ones, their configs, the train state, the loop (``loop.py``),
checkpoints (``checkpoint.py``) and the supervisor (``supervisor.py``)."""
