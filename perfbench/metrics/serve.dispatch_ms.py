"""serve.dispatch_ms: the daemon's own time a device dispatch over the
window (``ClipService.stats`` ``device_ms_total`` over
``device_dispatches``: the host clock around a graph replay that ends in
``.cpu()``)."""


def read(obs, trace):
    return obs.get("dispatch_ms")
