"""Host-side utilities.  Counterpart of ``vst_tpu/utils``: profiling and
tracing hooks (``profiling.py``) and flow visualization."""

from vst_tpu_torch.utils.profiling import StepTimer, trace_context

__all__ = ["StepTimer", "trace_context"]
