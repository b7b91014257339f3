"""Device ms a step of the operations launched with a ``diag.*`` span of the
measured package innermost (the energy diagnostics, the water closure and
the other diagnostic reductions, the chunk's diag rows), averaged over the
traced window's steps."""

from qbench.metrics._program import layer_ms


def read(run):
    return layer_ms(run, "diag")
