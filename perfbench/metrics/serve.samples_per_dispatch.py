"""serve.samples_per_dispatch: samples the daemon took over the window
over its device dispatches (``ClipService.stats``): how far dynamic
batching coalesces."""


def read(obs, trace):
    return obs.get("samples_per_dispatch")
