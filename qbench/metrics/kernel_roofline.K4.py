"""The ocean substeps' (batched K4's) share of the bytes roofline."""

from qbench.metrics._roofline import roofline


def read(run):
    return roofline(run, ["K4.ocean_substeps"])
