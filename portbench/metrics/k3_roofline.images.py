"""K3 (bfloat16) at relu3_1, relu4_1 and relu5_1 of the served forward:
the bound time of the softmax moments' work over the device time of its
launches, in %."""

from portbench.core.readers import counts, roofline

PATTERNS = ("attn_fwd_bf16",)


def read(run):
    h, w = run.work["frames"]
    calls = counts(run).k3_calls(run.config, run.work["batch"], h, w,
                                 run.work["dtype"])
    return roofline(run, PATTERNS, PATTERNS[0], len(calls), calls)
