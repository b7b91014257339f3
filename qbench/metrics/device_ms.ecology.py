"""Device ms a step inside the ecology's spans (the daily blocks, the
individual pool, phytoplankton), averaged over the traced window's steps."""

from qbench.metrics._device_ms import device_ms
from qbench.trace import SPANS


def read(run):
    return device_ms(run, [name for _, _, name in SPANS if name.startswith("ecology.")])
