"""The 95th percentile over all steps of the window of the interval between
consecutive step-end CUDA events (the first from the window's start)."""

import statistics


def read(run):
    if len(run.step_ms) < 20:
        return None
    return statistics.quantiles(run.step_ms, n=20, method="inclusive")[-1]
