"""The measured package's own spans (its ``telemetry`` module) over a traced
window: the shared arithmetic of the readers of program spans.

The package records each span on the profiler's clock (``time.time_ns()``,
the clock of the kineto events), with the index of its parent. A device
operation belongs to the innermost program span open at the host time of
its launch; one with no launch time (-1) belongs to none. Only the records
that lie within the trace's window count, so the first attempt of a
retried profile is left out. A package without the module, or a window
without its records, gives None.
"""

import importlib.util

from qbench import cell

# the program's roots of a step: an op whose innermost span is one of these
# was launched in a step but in none of its stages
ROOTS = ("ensemble.step", "step")


def records(run):
    """The program's records within the traced window, as a dict of
    index → record, or None."""
    tr = run.trace
    if tr is None or not tr.ops:
        return None
    name = cell.PACKAGE + ".telemetry"
    if importlib.util.find_spec(name) is None:
        return None
    telemetry = importlib.import_module(name)
    inside = {i: r for i, r in enumerate(telemetry.records())
              if tr.t0 <= r.start_ns and 0 < r.end_ns <= tr.t1}
    return inside or None


def placed(run):
    """[(op, path of span names from the root to its innermost program span,
    or None)] for the trace's operations that have a launch time, in
    launch order; None without a trace or without program spans in it."""
    recs = records(run)
    if recs is None:
        return None
    # the spans nest: a sweep in time order keeps the open ones on a stack,
    # innermost on top (a child opens at or after its parent, and after it
    # in index order)
    order = sorted(recs, key=lambda i: (recs[i].start_ns, i))
    ops = sorted((o for o in run.trace.ops if o.launch >= 0), key=lambda o: o.launch)
    path_of, stack, j, out = {}, [], 0, []
    for o in ops:
        while j < len(order) and recs[order[j]].start_ns <= o.launch:
            i = order[j]
            while stack and recs[stack[-1]].end_ns <= recs[i].start_ns:
                stack.pop()
            stack.append(i)
            j += 1
        while stack and recs[stack[-1]].end_ns < o.launch:
            stack.pop()
        path = None
        if stack:
            top = stack[-1]
            if top not in path_of:
                path_of[top] = _path(recs, top)
            path = path_of[top]
        out.append((o, path))
    return out


def paths(run):
    """{path of span names, root first: device ns of the operations whose
    innermost program span ends that path} over the traced window, or
    None."""
    ops = placed(run)
    if ops is None:
        return None
    out = {}
    for o, path in ops:
        if path is not None:
            out[path] = out.get(path, 0) + (o.end - o.start)
    return out


def _path(recs, i):
    names = []
    while i in recs:
        names.append(recs[i].name)
        i = recs[i].parent
    return tuple(reversed(names))


def layer(name: str) -> str:
    return name.split(".", 1)[0]


def device_ms(run, keep):
    """Device ms a step of the operations whose span path ``keep(path)``
    accepts, or None."""
    by_path = paths(run)
    if by_path is None:
        return None
    ns = sum(v for p, v in by_path.items() if keep(p))
    return 1e-6 * ns / run.trace.n_steps


def layer_ms(run, name: str):
    """Device ms a step of the operations whose innermost program span
    belongs to layer ``name``."""
    return device_ms(run, lambda p: layer(p[-1]) == name)
