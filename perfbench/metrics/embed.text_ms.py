"""embed.text_ms: the device time of the port's `model.encode_text` span (CUDA
events at its ends), the mean a call over the traced sub-window. The events
read the device's wall time across the call: kernel time in the embedding
cell, whose work is dispatched ahead so that the device leads the host."""

from perfbench.metrics._spans import per


def read(obs, trace):
    return per("model.encode_text", "device_ms", "model.encode_text")
