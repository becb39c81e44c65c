"""K1 and K2 in the bfloat16 forward: the bound time of their work (the
residual convs, the packed stem and head, ``counts/<config>.py``) over the
device time of their launches in the trace (the conv, ``finalize_stats``
and the other launches of each call), in %."""

from portbench.core.readers import counts, roofline

PATTERNS = ("conv3x3_wgmma", "finalize_stats", "prologue_params")
UNIT_PATTERN = "conv3x3_wgmma"   # one launch a K1 or K2 call


def read(run):
    h, w = run.work["frames"]
    calls = counts(run).kernel_calls(run.config, run.work["batch"], h, w,
                                     run.work["dtype"])
    return roofline(run, PATTERNS, UNIT_PATTERN, len(calls), calls)
