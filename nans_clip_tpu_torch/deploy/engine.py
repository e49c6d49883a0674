"""Engine files: a tower's exported program with a compatibility header
(counterpart of ``nans_clip_tpu/deploy/engine.py``, the TensorRT
engine-file analog).

An engine is one ``torch.export`` archive (``deploy/aot.py::export_tower``:
one tower at one batch size, its weights inputs and not baked in, so one
engine serves any checkpoint of the same architecture) with the header
stored in it as an extra file, :data:`HEADER_FILE` (JSON). It holds no
pickle of this package's own; loading the program still unpickles what
``torch.export`` wrote, so load engines only from paths you built, as a
TensorRT engine or a torch checkpoint.

The header holds a magic string, the torch version, ``torch.version.cuda``,
the device's type, name and compute capability, a digest of the kernel
library (:func:`kernel_digest`), the batch size and the JAX meta keys
(tower, model, vision/text model, precision, attn_impl, quantize,
context_length, batch_stats_digest). :func:`read_header` reads it out of the
zip without loading the program. :func:`load_engine` refuses weights on
another device type than the engine's, and a mismatch of the torch, CUDA,
device or kernel fields (``strict=False`` warns instead of the latter),
checks the weights against the program's inputs by name, shape and dtype,
and, on the card, captures the program on their device in a CUDA graph
(``aot.graphed``). Loading runs no trace and no
compile: a fresh process imports this module and ``ops/library.py`` (the
operators the program calls), not the model-building modules.

    python -m nans_clip_tpu_torch.deploy.engine build --out-dir engines \\
        [--resume ckpt.pt] [--towers image,text] [--batch-sizes 1,64] [--device cuda]
    python -m nans_clip_tpu_torch.deploy.engine inspect engines/text_bs1.engine
"""

from __future__ import annotations

import hashlib
import json
import logging
import warnings
import zipfile
from typing import Optional

import torch

from nans_clip_tpu_torch.deploy import aot
from nans_clip_tpu_torch.ops import _build

logger = logging.getLogger(__name__)

MAGIC = "nans-clip-tpu-torch-engine-v1"
HEADER_FILE = "nans_clip_engine.json"
# the fields load_engine holds against this process
CHECKED = ("torch", "cuda", "device_type", "device_name", "capability", "kernels")


def kernel_digest() -> str:
    """sha256 over ``csrc/*.cu``, ``csrc/*.cuh`` (by name, then bytes) and
    ``ops/_build.py::NVCC_FLAGS``: the kernels an engine's operators launch."""
    h = hashlib.sha256()
    for path in sorted(list(_build.CSRC.glob("*.cu")) + list(_build.CSRC.glob("*.cuh"))):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(json.dumps(_build.NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _device_fields(device_type: str) -> dict:
    if device_type == "cuda" and torch.cuda.is_available():
        cap = torch.cuda.get_device_capability()
        return {"device_type": "cuda", "device_name": torch.cuda.get_device_name(),
                "capability": f"{cap[0]}.{cap[1]}"}
    if device_type == "cuda":
        return {"device_type": "none", "device_name": "no CUDA device", "capability": None}
    return {"device_type": device_type, "device_name": device_type, "capability": None}


def environment(device_type: str) -> dict:
    """The header's environment fields for a program on ``device_type``."""
    return {"torch": torch.__version__, "cuda": torch.version.cuda,
            **_device_fields(device_type), "kernels": kernel_digest()}


def batch_stats_digest(batch_stats) -> Optional[str]:
    """Fingerprint of a tower's BatchNorm running statistics (a dict or list
    of tensors), which a ResNet engine would bake in; None for stat-less
    (ViT) models, whose engines hold none."""
    if not batch_stats:
        return None
    leaves = list(batch_stats.values()) if isinstance(batch_stats, dict) else list(batch_stats)
    h = hashlib.sha256()
    for leaf in leaves:
        h.update(torch.as_tensor(leaf).detach().float().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def save_engine(path: str, program, batch_size: int, meta: Optional[dict] = None) -> str:
    """Write ``program`` (``aot.export_tower``'s) with its header to ``path``."""
    header = {"magic": MAGIC, **environment(_program_inputs(program)[1].device.type),
              "batch_size": batch_size, "meta": meta or {}}
    with open(path, "wb") as f:   # a file object: the name need not end in .pt2
        torch.export.save(program, f, extra_files={HEADER_FILE: json.dumps(header)})
    logger.info("engine saved: %s", path)
    return path


def read_header(path: str) -> dict:
    """The engine's header, read out of the zip without loading the program."""
    try:
        with zipfile.ZipFile(path) as z:
            name = next((n for n in z.namelist() if n.endswith("/extra/" + HEADER_FILE)), None)
            header = json.loads(z.read(name)) if name else None
    except (zipfile.BadZipFile, OSError) as e:
        raise ValueError(f"{path}: not a nans-clip-tpu-torch engine file ({e})") from e
    if not header or header.get("magic") != MAGIC:
        raise ValueError(f"{path}: not a nans-clip-tpu-torch engine file")
    return header


def _check_environment(path: str, header: dict, strict: bool) -> None:
    now = environment(header.get("device_type", "cpu"))
    for key in CHECKED:
        if header.get(key) != now[key]:
            msg = (f"{path}: engine built for {key}={header.get(key)!r}, this process has "
                   f"{now[key]!r}; rebuild the engine (python -m "
                   f"nans_clip_tpu_torch.deploy.engine build)")
            if strict:
                raise ValueError(msg)
            warnings.warn(msg)


def _program_inputs(program):
    """([(weight name, its fake value)], the input's fake value) of a tower
    program: its user inputs in the order of the ``params`` dict it was
    exported with, then ``x``."""
    vals = {n.name: n.meta.get("val") for n in program.graph.nodes if n.op == "placeholder"}
    names = [vals[s.arg.name] for s in program.graph_signature.input_specs]
    child = lambda spec, i: spec.child(i) if hasattr(spec, "child") else spec.children_specs[i]
    keys = child(child(program.call_spec.in_spec, 0), 0).context   # args[0], the dict
    return list(zip(keys, names[:-1])), names[-1]


def _check_params(path: str, program, params: dict) -> None:
    """The weights against the program's inputs, by name, shape and dtype."""
    weights, _ = _program_inputs(program)
    missing = sorted(set(k for k, _ in weights) ^ set(params))
    if missing:
        raise ValueError(f"{path}: the engine's weights and the given ones differ in "
                         f"{missing[:4]} (another tower, depth or quantize mode?)")
    for key, v in weights:
        t = params[key]
        if tuple(t.shape) != tuple(v.shape) or t.dtype != v.dtype:
            raise ValueError(f"{path}: weight {key!r} is {tuple(t.shape)} {t.dtype}, the engine "
                             f"takes {tuple(v.shape)} {v.dtype} (built at another width or "
                             "precision?)")


def _params_device(path: str, header: dict, params: dict) -> torch.device:
    """The device of the weights, which must be the one the engine was built
    for: a program exported on one device type took the routes of that one
    and would run them on the other."""
    devices = {v.device for v in params.values()}
    if len(devices) != 1:
        raise ValueError(f"{path}: the weights lie on several devices {sorted(map(str, devices))}")
    device = devices.pop()
    if device.type != header.get("device_type"):
        raise ValueError(f"{path}: engine built for device_type={header.get('device_type')!r}, "
                         f"the weights lie on {device}; rebuild the engine with --device "
                         f"{device.type} (python -m nans_clip_tpu_torch.deploy.engine build)")
    return device


def load_engine(path: str, params: Optional[dict] = None, strict: bool = True,
                payload: Optional[dict] = None):
    """Restore an engine: ``run(x)`` with ``params`` (``aot.tower_params``)
    bound when given, else the raw ``fn(params, x)``. The result carries
    ``.batch_size`` and ``.meta``. ``payload``: the header, when the caller
    has read it already. The weights must lie on the device type the engine
    was built for (refused even with ``strict=False``), and the program runs
    on their device; on the card a bound engine runs as a CUDA graph."""
    header = payload if payload is not None else read_header(path)
    device = None if params is None else _params_device(path, header, params)
    _check_environment(path, header, strict)
    fn = aot.load_program(path)
    if params is None:
        def run(params, x):
            _params_device(path, header, params)
            return fn(params, x)
        run.program = fn.program
    else:
        _check_params(path, fn.program, params)

        def bound(x):
            return fn(params, x)

        _, val = _program_inputs(fn.program)
        if device.type == "cuda":
            with torch.cuda.device(device):
                run = aot.graphed(bound, torch.zeros(val.shape, dtype=val.dtype, device=device))
        else:
            def run(x):
                return bound(torch.as_tensor(x, dtype=val.dtype, device=device))
            run.graph = None
    run.batch_size = header.get("batch_size")
    run.meta = header.get("meta", {})
    return run


def engine_path(out_dir: str, tower: str, batch_size: int) -> str:
    """The ``build`` CLI's naming: one engine per tower x batch."""
    return f"{out_dir.rstrip('/')}/{tower}_bs{batch_size}.engine"


def main(argv=None):
    """``build``: export fixed-shape tower engines and save them; ``inspect``:
    print an engine's header. Consumed by ``eval.extract_features --backend
    engine``, ``deploy.speed_benchmark --backend engine`` and the daemon's
    ``--engine-dir``."""
    import argparse
    import os
    import time

    from nans_clip_tpu_torch.models.common import PRECISIONS
    from nans_clip_tpu_torch.ops import gates

    p = argparse.ArgumentParser(prog="nans_clip_tpu_torch.deploy.engine")
    sub = p.add_subparsers(dest="cmd", required=True)
    b = sub.add_parser("build", help="export + save tower engines")
    b.add_argument("--vision-model", default="ViT-B-16")
    b.add_argument("--text-model", default="RoBERTa-wwm-ext-base-chinese")
    b.add_argument("--resume", default=None)
    b.add_argument("--precision", default="bf16", choices=PRECISIONS)
    b.add_argument("--attn-impl", default="auto", choices=gates.IMPLS,
                   help="the route the program is exported on (not pallas)")
    b.add_argument("--towers", default="image,text")
    b.add_argument("--batch-sizes", default="1")
    b.add_argument("--context-length", type=int, default=52)
    b.add_argument("--quantize", default=None, choices=[None, "int8", "int8-text"],
                   help="weight-only int8 serving (utils/quantize.py) in the engine's calling "
                        "convention: pass the same quantized weights at load time")
    b.add_argument("--out-dir", required=True)
    b.add_argument("--tiny-model", action="store_true",
                   help="2-layer debug config (configs.tiny_config)")
    b.add_argument("--device", default="cuda",
                   help="the device the engines run on (default: the card; raises without one)")
    i = sub.add_parser("inspect", help="print an engine header")
    i.add_argument("path")
    args = p.parse_args(argv)

    if args.cmd == "inspect":
        for key, val in read_header(args.path).items():
            print(f"{key}: {val}")
        return

    from nans_clip_tpu_torch.eval.model_io import load_eval_model

    cfg = None
    if args.tiny_model:
        from nans_clip_tpu_torch.configs import tiny_config
        cfg = tiny_config()
    model = load_eval_model(args.vision_model, args.text_model, args.resume, args.precision,
                            attn_impl=args.attn_impl, cfg=cfg, device=args.device)
    if args.quantize:
        from nans_clip_tpu_torch.utils.quantize import towers_for_mode
        model = model.quantize("int8", towers_for_mode(args.quantize))
    os.makedirs(args.out_dir, exist_ok=True)
    for tower in args.towers.split(","):
        params = aot.tower_params(model, tower)
        for bs in [int(s) for s in args.batch_sizes.split(",")]:
            t0 = time.time()
            program = aot.export_tower(model.cfg, model.options, tower, params,
                                       aot.example_input(model.cfg, tower, bs,
                                                         args.context_length, model.device))
            path = save_engine(
                engine_path(args.out_dir, tower, bs), program, bs,
                meta={"tower": tower, "model": model.cfg.name,
                      "vision_model": args.vision_model, "text_model": args.text_model,
                      "precision": args.precision, "attn_impl": args.attn_impl,
                      "quantize": args.quantize, "context_length": args.context_length,
                      # ViT towers have no BatchNorm statistics to bake in
                      "batch_stats_digest": None})
            print(f"built {path} in {time.time() - t0:.1f}s")


if __name__ == "__main__":
    main()
