"""1 − the union of device activity over the traced window, in %."""


def read(run):
    tr = run.trace
    if tr is None or not tr.ops:
        return None
    return 100.0 * (1.0 - tr.busy_ns() * 1e-9 / tr.window_s)
