"""Operations the card runs a served frame: every kernel, copy and set that
starts inside the traced span, over the frames of the batch calls that
start inside it.

A batch call is a ``vst::stream.call`` span
(``vst_tpu_torch/utils/profiling.py::span``) and holds the cell's batch of
frames.  In a host-bound stream this is the count that a cheaper enqueue
has to lower.  None without a trace, or where the program opens no such
span."""

PER = "vst::stream.call"


def read(run):
    tr = run.trace
    if tr is None:
        return None
    calls = sum(1 for n, a, _ in tr.host if n == PER and tr.lo <= a <= tr.hi)
    ops = sum(1 for _, a, _ in tr.device if tr.lo <= a <= tr.hi)
    frames = calls * run.work.get("batch", 0)
    return ops / frames if frames and ops else None
