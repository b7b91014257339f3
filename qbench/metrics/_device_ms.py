"""Device ms a step inside spans: the shared arithmetic of the
``device_ms.*`` readers."""


def device_ms(run, names):
    tr = run.trace
    if tr is None or not tr.ops:
        return None
    present = [n for n in names if n in tr.spans]
    if not present:
        return None
    ops = tr.inside(present)
    return 1e3 * sum((o.end - o.start) * 1e-9 for o in ops) / tr.n_steps
