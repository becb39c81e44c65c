"""Host ms a served batch spends in the stream's own copies: the windows'
stack, the pinned upload, the copy back enqueued and the frames handed out.

The summed host seconds of the program's spans ``vst::stream.assemble``,
``vst::stream.upload``, ``vst::stream.download``, ``vst::stream.hand_out``
(``vst_tpu_torch/utils/profiling.py::span``), each clipped to the traced
span, over the ``vst::stream.call`` spans that start inside it (one a
batch), in ms.  None without a trace, or where the program opens none of
these spans."""

SPANS = ("vst::stream.assemble", "vst::stream.upload", "vst::stream.download",
         "vst::stream.hand_out")
PER = "vst::stream.call"


def read(run):
    tr = run.trace
    if tr is None:
        return None
    units = sum(1 for n, a, _ in tr.host if n == PER and tr.lo <= a <= tr.hi)
    spent = sum(min(b, tr.hi) - max(a, tr.lo) for n, a, b in tr.host
                if n in SPANS and b > tr.lo and a < tr.hi)
    return 1e3 * spent / units if units and spent else None
