"""Small constants of the ops, kept on the device.

``torch.tensor(values, device=cuda)`` copies from pageable host memory,
and torch ends that copy with a stream synchronize: a constant made on
every call drains the card on every call.  ``device_constant`` makes each
one once for its (values, dtype, device) and hands the same tensor back
afterwards, so a forward that reads it enqueues work and never waits.

``device_constant.builds`` counts the tensors made, as the kernel
wrappers count ``.launches``; each build is a "vst::ops.const_build" span
(``utils/profiling.py::span``).  After warm-up a caller's constants all
exist, and the count stands still."""

import threading

import torch

from vst_tpu_torch.utils.profiling import span

_made = {}
_lock = threading.Lock()


def device_constant(values: tuple, dtype: torch.dtype, device) -> torch.Tensor:
    """``torch.tensor(values, dtype=dtype, device=device)``, the same
    conversion and so the same bits, made on the first call for this
    (values, dtype, device) and returned by every later one.  The tensor
    is shared: callers read it and never write into it.  It is made
    outside inference mode, so autograd may save it for a backward
    whether or not the first call ran under ``torch.inference_mode``."""
    key = (values, dtype, torch.device(device))
    t = _made.get(key)
    if t is None:
        with _lock:
            t = _made.get(key)
            if t is None:
                with span("vst::ops.const_build"), \
                        torch.inference_mode(False):
                    t = torch.tensor(values, dtype=dtype, device=device)
                _made[key] = t
                device_constant.builds += 1
    return t


device_constant.builds = 0
