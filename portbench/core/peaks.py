"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the 700 W limit).  Float32 work is held against the TF32 tensor-core peak:
the port computes its float32 products as 3xTF32 on the tensor cores, and
no true-float32 product runs faster, so no share can pass 100%."""

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12}
PEAK_BYTES_PER_S = 3.35e12
ELEMENT_BYTES = {"bfloat16": 2, "float32": 4}


def bound_seconds(flops: float, nbytes: float, dtype: str) -> float:
    """The least time the card could take: the larger of the operations
    over the peak rate of ``dtype`` and the bytes over HBM's rate."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S)
