"""Device ms a step of the operations launched inside the measured
package's ``ensemble.step`` span but in none of its stages (the innermost
span is the step's root, ``ensemble.step`` or ``step``): what the stage
spans leave uncovered, averaged over the traced window's steps."""

from qbench.metrics._program import ROOTS, device_ms


def read(run):
    return device_ms(run, lambda p: p[-1] in ROOTS and "ensemble.step" in p)
