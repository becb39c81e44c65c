"""K1 and K2 in the float32 (3xTF32) forward of the flow step, over both
frames of each pair: the bound time of their work over the device time of
their launches (conv, weight split, statistics), in %.  Their backward is
the library's and is not counted."""

from portbench.core.readers import counts, roofline

PATTERNS = ("conv3x3_tf32", "split_tf32", "finalize_stats",
            "prologue_params")
UNIT_PATTERN = "conv3x3_tf32"   # one launch a call (narrow body included)


def read(run):
    t = run.config["train"]
    h, w = t["img_size"]
    calls = counts(run).kernel_calls(run.config, 2 * t["batch_size"], h, w,
                                     t["dtype"])
    return roofline(run, PATTERNS, UNIT_PATTERN, len(calls), calls)
