"""Host-side utilities.  Counterpart of ``vst_tpu/utils``."""
