"""dp.comm_ms: the device time of the NCCL kernels (the feature gathers and
the gradient all-reduce) a step on rank 0, in the traced sub-window."""


def read(obs, trace):
    return obs.get("comm_ms") if trace is not None else None
