"""What the readers of the port's spans share
(``nans_clip_tpu_torch/utils/profiling.py``): the spans of a run are those
of its traced sub-window, the only part of it with the profiler on. A
program without the recorder, or a run that recorded none of the spans a
reader wants, reads None."""


def per(name: str, field: str, unit: str):
    """The summed ``field`` ("host_ms" or "device_ms") of the spans named
    ``name`` over the number of spans named ``unit``: a step's root for a
    mean a step, ``name`` itself for a mean a call."""
    try:
        from nans_clip_tpu_torch.utils.profiling import span_totals, spans
    except ImportError:
        return None
    totals = span_totals(spans())
    if name not in totals or unit not in totals or totals[name][field] is None:
        return None
    return totals[name][field] / totals[unit]["calls"]
