"""train.host_ms: the host time of the port's `train.step` span, the mean a step
over the traced sub-window, on the profiler's clock."""

from perfbench.metrics._spans import per


def read(obs, trace):
    return per("train.step", "host_ms", "train.step")
