"""mfu.embed: model FLOPs of the window's work a second, % of 989 TFLOP/s."""

from perfbench.metrics._read import mfu


def read(obs, trace):
    return mfu(obs)
