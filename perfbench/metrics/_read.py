"""Arithmetic the per-layer readers share. Each reader returns None where
its run has nothing to read (no sound trace, no observation)."""

from perfbench.counts import PEAK_FLOPS


def mfu(obs: dict):
    """Model FLOPs of the window's completed work over its seconds, as a
    percentage of the bf16 peak of the chips it ran on."""
    if "flops" not in obs or not obs.get("window_s"):
        return None
    return 100.0 * obs["flops"] / obs["window_s"] / (PEAK_FLOPS * obs.get("chips", 1))


def roofline(obs: dict, trace):
    """The sub-window's least time by the op counts over the device's busy
    time in it, as a percentage."""
    if trace is None or "bound_s" not in obs or trace.busy_s <= 0:
        return None
    return 100.0 * obs["bound_s"] / trace.busy_s


def idle(trace):
    """The share of the traced sub-window in which nothing ran on the
    device, as a percentage."""
    if trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
