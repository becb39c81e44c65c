"""Host-side utilities.  Counterpart of ``vst_tpu/utils``: profiling and
tracing hooks (``profiling.py``: the gated ``span`` every range of the
package goes through, ``trace_context``, ``StepTimer``) and flow
visualization."""

from vst_tpu_torch.utils.profiling import StepTimer, span, trace_context

__all__ = ["StepTimer", "span", "trace_context"]
