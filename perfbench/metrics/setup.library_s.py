"""setup.library_s: the seconds the port took to build (where a source was newer
than the library) and load its kernel library in this process
(`nans_clip_tpu_torch/ops/_build.py::LOAD`)."""


def read(obs, trace):
    try:
        from nans_clip_tpu_torch.ops._build import LOAD
    except ImportError:
        return None
    return LOAD.seconds
