"""The share of the card's idle time that the host spends loading or uploading
a batch: the ``vst::data.*`` spans.

The device's idle seconds in the traced span (the gaps between the union of
its operations) that fall under the union of these spans
(``vst_tpu_torch/utils/profiling.py::span``), over all its idle seconds, in
%: the idle time the program puts down to that layer, on the profiler's one
clock.  None without a trace, or where the program opens none of these
spans."""

from portbench.core.trace import gaps

PREFIX = "vst::data."
LEAVE_OUT = ()


def _merged(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _overlap(xs, ys):
    """Seconds inside both of two sorted lists of disjoint intervals."""
    i = j = 0
    total = 0.0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def read(run):
    tr = run.trace
    if tr is None:
        return None
    spans = [(a, b) for n, a, b in tr.host if n.startswith(PREFIX)
             and n not in LEAVE_OUT and b > tr.lo and a < tr.hi]
    idle = gaps(tr.clipped(), tr.lo, tr.hi)
    total = sum(b - a for a, b in idle)
    if not spans or not total:
        return None
    return 100.0 * _overlap(idle, _merged(spans)) / total
