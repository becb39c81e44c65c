"""The benchmark of vst_tpu_torch on one NVIDIA H100 (``run.py``)."""
