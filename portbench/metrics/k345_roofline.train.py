"""The float32 (3xTF32) K3 (6 launches a step), K4 (3) and K5 (3) of the
AdaAttN image step with their ``split_tf32`` passes: the bound time of a
step's attention work over the device time of those launches, in %."""

from portbench.core.readers import counts, roofline

PATTERNS = ("attn_fwd_tf32", "attn_dq_tf32", "attn_dkv_tf32", "split_tf32")
UNIT_PATTERN = "attn_fwd_tf32"
K3_PER_STEP = 6


def read(run):
    return roofline(run, PATTERNS, UNIT_PATTERN, K3_PER_STEP,
                    counts(run).step_kernel_calls(run.config))
