"""idle.train: the share of the traced sub-window with no device operation, %."""

from perfbench.metrics._read import idle


def read(obs, trace):
    return idle(trace)
