"""The median of positives' (batched K1's, three calls a step) share of the
bytes roofline, over its calls at each caller's name."""

from qbench.metrics._roofline import roofline


def read(run):
    return roofline(run, ["K1.model", "K1.dynamics", "K1.clouds"])
