"""Device ms a step inside the ``routing.routing_step`` span, averaged over the traced
window's steps."""

from qbench.metrics._device_ms import device_ms


def read(run):
    return device_ms(run, ["routing.routing_step"])
