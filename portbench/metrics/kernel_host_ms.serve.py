"""Host ms a served batch spends in K1's and K2's launch paths: checks,
allocations, the ctypes call.

The summed host seconds of the program's spans ``vst::k1``, ``vst::k2``
(``vst_tpu_torch/utils/profiling.py::span``), each clipped to the traced
span, over the ``vst::stream.call`` spans that start inside it (one a
batch), in ms.  None without a trace, or where the program opens none of
these spans."""

SPANS = ("vst::k1", "vst::k2")
PER = "vst::stream.call"


def read(run):
    tr = run.trace
    if tr is None:
        return None
    units = sum(1 for n, a, _ in tr.host if n == PER and tr.lo <= a <= tr.hi)
    spent = sum(min(b, tr.hi) - max(a, tr.lo) for n, a, b in tr.host
                if n in SPANS and b > tr.lo and a < tr.hi)
    return 1e3 * spent / units if units and spent else None
