"""Host ms a train step's batch spends loading on the consumer's thread: the
pool's samples and their stack.

The summed host seconds of the program's spans ``vst::data.load``
(``vst_tpu_torch/utils/profiling.py::span``), each clipped to the traced
span, over the ``vst::step.optimizer`` spans that start inside it (one a
step), in ms.  None without a trace, or where the program opens none of
these spans."""

SPANS = ("vst::data.load",)
PER = "vst::step.optimizer"


def read(run):
    tr = run.trace
    if tr is None:
        return None
    units = sum(1 for n, a, _ in tr.host if n == PER and tr.lo <= a <= tr.hi)
    spent = sum(min(b, tr.hi) - max(a, tr.lo) for n, a, b in tr.host
                if n in SPANS and b > tr.lo and a < tr.hi)
    return 1e3 * spent / units if units and spent else None
