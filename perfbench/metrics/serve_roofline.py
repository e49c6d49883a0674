"""serve_roofline: the model's op-count bound over the device's busy time in
the traced sub-window, %."""

from perfbench.metrics._read import roofline


def read(obs, trace):
    return roofline(obs, trace)
