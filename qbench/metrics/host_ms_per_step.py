"""Host ms a step call takes (the ensemble's ``run_steps`` and
``_vmap_step``: dispatch), mean over the traced window."""


def read(run):
    if run.trace is None or not run.trace.host_s:
        return None
    return 1e3 * sum(run.trace.host_s) / len(run.trace.host_s)
