"""train.optimizer_ms: the device time of one optimizer step (CUDA events
at the optimizer's step hooks), the mean over the window's steps of a
traced run."""


def read(obs, trace):
    return obs.get("optimizer_ms")
