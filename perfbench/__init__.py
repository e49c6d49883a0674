"""The benchmark of the PyTorch/CUDA port (``nans_clip_tpu_torch``): cells
of ``BENCHMARK.json`` run by ``python3 -m perfbench.run``."""
