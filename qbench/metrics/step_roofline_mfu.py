"""The step's share of the chip's roofline: the least time of the traced
window's steps, each the bytes of the state leaves that its kind of step
changes (the configuration's ``changed_leaves``, found on the CPU) read
once and written once over the published HBM rate (bytes bound; no FLOP
term), over the traced window's time."""

from qbench.peaks import PEAK_BYTES_PER_S


def read(run):
    tr = run.trace
    if tr is None or not tr.ops:
        return None
    changed = run.cell.config["changed_leaves"]
    least = 0.0
    for kind in tr.step_kinds:
        least += 2 * sum(run.leaf_bytes[k] for k in changed[kind]) / PEAK_BYTES_PER_S
    return 100.0 * least / tr.window_s
