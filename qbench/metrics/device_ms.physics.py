"""Device ms a step of the operations launched with a ``physics.*`` span of
the measured package innermost (precipitation, clouds, insolation, snow,
albedo, surface fluxes, SST feedback, land bucket), averaged over the
traced window's steps."""

from qbench.metrics._program import layer_ms


def read(run):
    return layer_ms(run, "physics")
