"""Device kernels, memsets and copies a step, from the trace; the harness's
copies for the check (launched inside the ``trace.RECORD`` span) left out."""

from qbench.trace import RECORD


def read(run):
    tr = run.trace
    if tr is None or not tr.ops:
        return None
    harness = {id(o) for o in tr.inside([RECORD])}
    return sum(1 for o in tr.ops if o.start >= tr.t0 and id(o) not in harness) / tr.n_steps
