"""Fixed-shape towers (counterpart of ``nans_clip_tpu/deploy/aot.py``).

The JAX package compiles a tower at one batch size ahead of time
(``jax.jit(...).lower(...).compile()``) and serializes it with
``jax.export`` (the ONNX-file analog). On the card the counterpart of a
compiled, fixed-shape program is a captured CUDA graph:

* :func:`compile_tower` warms a tower up on a side stream (the kernel
  library built, the tower kernel's pointer table, the packed q|k|v weights
  and ``tower_kernel.max_grid`` cached), captures one ``torch.cuda.CUDAGraph``
  of it at that batch into a static input and a static output, and replays
  it at each call. The routes are decided on the host from shape and device
  (``ops/gates.py``), so a graph is fixed per (tower, batch), as in JAX.
  The graphs of one model share one memory pool; their callers run them one
  at a time (the daemon's lock). A capture that fails raises: there is no
  eager fallback. On the CPU, asked for explicitly, the tower runs live.
* :func:`export_program` writes a ``torch.export`` archive (``.pt2``) of a
  tower at one batch size whose weights are inputs, not constants (the
  ``export_stablehlo`` counterpart); :func:`load_program` reads it back as
  ``fn(params, x)``. The program's weights are :func:`tower_params`: the
  compute dtype's tensors in the layout the kernels read (q|k|v packed, the
  patch projection flattened), so no weight is cast or concatenated in a
  call. On the card the program calls the kernels as the registered
  operators of ``ops/library.py``. The example inputs that
  ``torch.export.save`` would store (the weights among them) are dropped
  before saving. The ``--attn-impl pallas`` route (the flash kernels are
  not registered operators) and tensor parallelism are not exported.
"""

from __future__ import annotations

import os
import weakref
from typing import Optional

import torch

from nans_clip_tpu_torch.ops import library  # registers nans_clip::*

_POOLS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def example_input(cfg, tower: str, batch_size: int, context_length: int = 52,
                  device="cpu") -> torch.Tensor:
    """A zero input of the tower's calling convention: images fp32 [B, R, R,
    3] NHWC, texts int64 [B, context_length]."""
    if tower == "image":
        r = cfg.vision.image_resolution
        return torch.zeros(batch_size, r, r, 3, dtype=torch.float32, device=device)
    if tower == "text":
        return torch.zeros(batch_size, context_length, dtype=torch.long, device=device)
    raise ValueError(f"tower must be 'image' or 'text', got {tower!r}")


def normalized(f: torch.Tensor) -> torch.Tensor:
    """fp32 features, L2-normalised in fp32 (JAX aot.py:39-51)."""
    f = f.float()
    return f / torch.linalg.vector_norm(f, dim=-1, keepdim=True)


def graphed(fn, example: torch.Tensor, pool=None, warmup: int = 2):
    """``run(x)``: ``fn`` captured in one CUDA graph at ``example``'s shape.
    ``fn`` runs ``warmup`` times on a side stream first (everything a call
    builds or caches once, and any host-to-device copy, happens there), then
    once under capture into a static output; each call copies ``x`` into the
    static input, replays the graph and returns a copy of the output.
    ``pool``: a ``torch.cuda.graph_pool_handle()`` shared with other graphs
    that never run at the same time. ``fn`` and the tower op's pointer
    tables that it uses (``ops/library.py::keep_tables``) live as long as
    ``run``. A capture that fails raises."""
    dev = example.device
    static_in = example.clone()
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    graph = torch.cuda.CUDAGraph()
    with library.keep_tables() as tables:
        with torch.cuda.stream(side):
            for _ in range(warmup):
                fn(static_in)
        torch.cuda.current_stream(dev).wait_stream(side)
        try:
            with torch.cuda.graph(graph, pool=pool):
                static_out = fn(static_in)
        except Exception as e:
            raise RuntimeError(f"CUDA graph capture at input {tuple(example.shape)} failed "
                               f"(no eager fallback): {e}") from e

    def run(x) -> torch.Tensor:
        x = torch.as_tensor(x)
        if tuple(x.shape) != tuple(static_in.shape):
            raise ValueError(f"this graph takes input {tuple(static_in.shape)}, got "
                             f"{tuple(x.shape)} (a graph is fixed per shape)")
        static_in.copy_(x)
        graph.replay()
        return static_out.clone()

    # what the graph reads lives as long as it: the tensors fn holds (an
    # engine's weights) and the tower op's pointer tables
    run.graph, run.fn, run.tables = graph, fn, tables
    return run


def _pool(module):
    """(the memory pool of ``module``'s graphs, the set of its live graphs).
    The allocator releases a pool once no graph uses it, and a released pool
    takes no new capture, so a new one is made then."""
    entry = _POOLS.get(module)
    if entry is None or not entry[1]:
        entry = _POOLS[module] = (torch.cuda.graph_pool_handle(), weakref.WeakSet())
    return entry


def compile_tower(model, tower: str, batch_size: int, context_length: int = 52,
                  normalize_out: bool = True):
    """One tower of a ``CLIPModel`` at a fixed batch size: ``run(x) -> fp32
    [B, E]`` (L2-normalised in fp32 with ``normalize_out``). On the card a
    CUDA graph (module docstring); on the CPU the live forward with the same
    calling convention. ``run`` carries ``.batch_size`` and ``.graph``
    (None on the CPU)."""
    encode = model.encode_image if tower == "image" else model.encode_text
    fn = (lambda x: normalized(encode(x))) if normalize_out else (lambda x: encode(x).float())
    example = example_input(model.cfg, tower, batch_size, context_length, model.device)
    if model.device.type == "cuda":
        pool, graphs = _pool(model.module)
        with torch.cuda.device(model.device):
            run = graphed(fn, example, pool)
        graphs.add(run.graph)
    else:
        def run(x) -> torch.Tensor:
            return fn(x)
        run.graph = None
    run.batch_size = batch_size
    return run


@torch.no_grad()
def tower_params(model, tower: str) -> dict:
    """The exported program's weight inputs for ``model``'s ``tower``
    (``models/clip.py::serving_weights``), on the model's device."""
    from nans_clip_tpu_torch.models.clip import serving_weights

    return {k: v.detach().contiguous() for k, v in
            serving_weights(model.module, tower, model.options).items()}


def tower_function(cfg, options, tower: str, normalize_out: bool = True):
    """``fn(params, x) -> fp32 [B, E]``: the tower's inference forward from
    :func:`tower_params` (``models/clip.py::serve``)."""
    from nans_clip_tpu_torch.models.clip import serve

    def fn(params, x):
        f = serve(cfg, tower, params, x, options)
        return normalized(f) if normalize_out else f.float()

    return fn


class _Program(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, params, x):
        return self.fn(params, x)


def export_tower(cfg, options, tower: str, params: dict, example: torch.Tensor,
                 normalize_out: bool = True):
    """The ``torch.export`` program of :func:`tower_function` at
    ``example``'s shape, ``params`` and ``example`` its inputs (real or fake
    tensors; the routes follow their device). Its example inputs are
    dropped, so that saving it stores no weight."""
    if options.tp > 1 or options.attn_impl == "pallas":
        raise ValueError(f"export: attn_impl={options.attn_impl!r}, tp={options.tp} is not "
                         "exported (the flash kernels are not registered operators; tensor "
                         "parallelism spans processes)")
    fn = tower_function(cfg, options, tower, normalize_out)
    with torch.no_grad():
        program = torch.export.export(_Program(fn), (params, example))
    program.example_inputs = None
    return program


def export_program(model, tower: str, batch_size: int, path: str, context_length: int = 52,
                   extra_files: Optional[dict] = None) -> str:
    """Serialize ``model``'s ``tower`` at ``batch_size`` to a ``.pt2`` archive
    with its weights as inputs (the ``export_stablehlo`` counterpart)."""
    program = export_tower(model.cfg, model.options, tower, tower_params(model, tower),
                           example_input(model.cfg, tower, batch_size, context_length,
                                         model.device))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        torch.export.save(program, f, extra_files=extra_files)
    return path


def load_program(path: str, extra_files: Optional[dict] = None):
    """Read an exported tower; returns ``fn(params, x)`` (``load_stablehlo``'s
    counterpart). ``extra_files`` names the archive's extra files to read
    into it. The program carries ``.program``, the ``ExportedProgram``, and
    keeps the tower op's pointer tables of its last call."""
    with open(path, "rb") as f:   # a file object: the name need not end in .pt2
        program = torch.export.load(f, extra_files=extra_files)
    module = program.module()

    def fn(params, x):
        with library.keep_tables() as tables:
            out = module(params, x)
        fn.tables = tables   # built for the next call with the same weights
        return out

    fn.program = program
    fn.tables = []
    return fn
