"""A span's share of the bytes roofline: the bytes its calls read and wrote
(inputs once, outputs once, from the calls' shapes, each member counted)
over the published HBM rate, divided by the device time inside the span."""

from qbench.peaks import PEAK_BYTES_PER_S


def roofline(run, names):
    tr = run.trace
    if tr is None or run.spans is None:
        return None
    present = [n for n in names if n in tr.spans and run.spans.bytes.get(n)]
    if not present:
        return None
    ops = tr.inside(present)
    busy = sum((o.end - o.start) for o in ops) * 1e-9
    if busy <= 0:
        return None
    least = sum(run.spans.bytes[n] for n in present) / PEAK_BYTES_PER_S
    return 100.0 * least / busy
