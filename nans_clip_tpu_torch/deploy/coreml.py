"""CoreML export (counterpart of ``nans_clip_tpu/deploy/coreml.py``, the
reference ``deploy/pytorch_to_coreml.py`` analog).

The reference wraps each tower in an ``nn.Module``, traces it and hands the
trace to ``coremltools.convert(..., convert_to="mlprogram")`` (reference
deploy/pytorch_to_coreml.py:16-31, 120-177). The export runs in two stages,
as the JAX package's:

1. Always (no extra dependency): each requested tower is exported as a
   self-contained ``torch.export`` archive (``*.pt2``): weights baked in as
   constants, fixed shapes, fp32, traced from CPU tensors on the plain route,
   so the graph holds only ``aten`` operators and never a ``nans_clip::``
   kernel operator (the counterpart of JAX's CPU lowering, which holds no
   Pallas/Mosaic custom call); plus a ``*.manifest.json`` with what the
   reference bakes into its CoreML artifacts: input name, shape and layout,
   output name and feature dim, the requested compute precision, the image
   normalisation mean/std, the context length and the deployment target.
   This stage is a CPU export by design and takes no device.
2. Where ``coremltools`` imports, the archive's ``ExportedProgram`` is
   converted (``ct.convert(..., convert_to="mlprogram")``) and saved as
   ``*.mlpackage``, as the reference's output files. Without it the stage
   prints a pointer and returns None: the ``.pt2`` and its manifest are the
   whole input of the conversion on a machine that has the converter.

Inputs follow the reference's CoreML artifacts: the image tower takes NCHW
fp32 ``[1, 3, R, R]`` (normalised, like the reference's traced
``preprocess`` output; transposed inside to the towers' NHWC), the text
tower int32 ``[1, context_length]`` token ids (widened inside to int64).

    python -m nans_clip_tpu_torch.deploy.coreml --model-arch ViT-B-16 \\
        --save-coreml-path out/clip_cn [--pytorch-ckpt-path ckpt.pt] \\
        [--convert-text] [--convert-vision] [--precision fp16|fp32]
    python -m nans_clip_tpu_torch.deploy.coreml --convert-only out/clip_cn.text.pt2
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional

import torch

from nans_clip_tpu_torch.configs import CLIPConfig
from nans_clip_tpu_torch.models.common import ModelOptions
from nans_clip_tpu_torch.utils.transform import OPENAI_MEAN, OPENAI_STD

#: fp32 on the plain route (JAX's ``attn_impl="xla"``): no kernel operator
#: enters the exported graph.
_EXPORT_OPTIONS = ModelOptions(attn_impl="plain")


class _ClosedTower(torch.nn.Module):
    """One tower with its weights closed over (``torch.export`` lifts them as
    constants of the archive), in the reference CoreML calling convention."""

    def __init__(self, cfg: CLIPConfig, module, tower: str):
        from nans_clip_tpu_torch.models.clip import serving_weights

        super().__init__()
        self.cfg, self.tower = cfg, tower
        self.weights = {k: v.detach().float().contiguous()
                        for k, v in serving_weights(module, tower, _EXPORT_OPTIONS).items()}

    def forward(self, x):
        from nans_clip_tpu_torch.deploy.aot import normalized
        from nans_clip_tpu_torch.models.clip import serve

        # the reference takes NCHW (torch layout); the towers take NHWC
        x = x.permute(0, 2, 3, 1) if self.tower == "image" else x.long()
        return normalized(serve(self.cfg, self.tower, self.weights, x, _EXPORT_OPTIONS))


def _example(cfg: CLIPConfig, tower: str, context_length: int) -> torch.Tensor:
    if tower == "image":
        r = cfg.vision.image_resolution
        return torch.zeros(1, 3, r, r, dtype=torch.float32)
    return torch.zeros(1, context_length, dtype=torch.int32)


def export_tower_program(cfg: CLIPConfig, module, tower: str, path: str,
                         context_length: int = 52) -> str:
    """Stage 1: write the self-contained fp32 program of ``module``'s
    ``tower`` (a ``CLIP`` on the CPU, its weights taken to fp32) to
    ``path``."""
    with torch.no_grad():
        program = torch.export.export(_ClosedTower(cfg, module, tower),
                                      (_example(cfg, tower, context_length),))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        torch.export.save(program, f)
    return path


def write_manifest(cfg: CLIPConfig, tower: str, path: str, precision: str = "fp16",
                   context_length: int = 52) -> str:
    """The deployment metadata the reference bakes into its CoreML models
    (input/output tensor specs, precision, preprocessing constants): JAX's
    keys and values, but ``format``."""
    if tower == "image":
        r = cfg.vision.image_resolution
        inp = {"name": "image", "shape": [1, 3, r, r], "dtype": "float32", "layout": "NCHW",
               "preprocessing": {"resize": r, "rescale": "1/255", "mean": list(OPENAI_MEAN),
                                 "std": list(OPENAI_STD)}}
        out_name = "image_features"
    else:
        inp = {"name": "text", "shape": [1, context_length], "dtype": "int32",
               "preprocessing": {"tokenizer": "WordPiece", "vocab_size": cfg.text.vocab_size,
                                 "context_length": context_length}}
        out_name = "text_features"
    manifest = {
        "format": "torch.export",
        "tower": tower,
        "model": cfg.name,
        "input": inp,
        "output": {"name": out_name, "shape": [1, cfg.embed_dim], "dtype": "float32",
                   "l2_normalized": True},
        "coreml": {"convert_to": "mlprogram", "compute_precision": precision,
                   "minimum_deployment_target": "iOS15"},
    }
    with open(path, "w") as f:
        json.dump(manifest, f, indent=2)
    return path


def _load_converter():
    """``coremltools``, or None where it does not import."""
    try:
        import coremltools as ct
    except ImportError:
        return None
    return ct


def convert_mlpackage(program_path: str, manifest_path: str, out_path: str) -> Optional[str]:
    """Stage 2: the archive's ``ExportedProgram`` -> ``.mlpackage`` where
    ``coremltools`` imports. Returns the saved path, or None (with a
    message) without it: the stage-1 files are the whole conversion input
    for a machine that has it."""
    ct = _load_converter()
    if ct is None:
        print("coremltools not installed — skipping .mlpackage conversion. Run where it is:\n"
              f"  python -m nans_clip_tpu_torch.deploy.coreml --convert-only {program_path}")
        return None
    with open(program_path, "rb") as f:
        program = torch.export.load(f)
    with open(manifest_path) as f:
        manifest = json.load(f)
    precision = (ct.precision.FLOAT16 if manifest["coreml"]["compute_precision"] == "fp16"
                 else ct.precision.FLOAT32)
    model = ct.convert(program, convert_to="mlprogram", compute_precision=precision,
                       minimum_deployment_target=ct.target.iOS15)
    model.save(out_path)
    print(f"{manifest['tower']} model converted to CoreML and saved at: {out_path}")
    return out_path


def export_coreml(cfg: CLIPConfig, module, save_path: str, convert_text: bool = True,
                  convert_vision: bool = True, precision: str = "fp16",
                  context_length: int = 52) -> dict:
    """Both stages for the requested towers of ``module`` (a ``CLIP`` on the
    CPU; a ResNet's BatchNorm statistics are among its weights); returns
    {tower: {"program", "manifest", "mlpackage"}}."""
    results = {}
    for tower, enabled in (("text", convert_text), ("image", convert_vision)):
        if not enabled:
            continue
        program = export_tower_program(cfg, module, tower, f"{save_path}.{tower}.pt2",
                                       context_length)
        man = write_manifest(cfg, tower, f"{save_path}.{tower}.manifest.json", precision,
                             context_length)
        pkg = convert_mlpackage(program, man, f"{save_path}.{tower}.mlpackage")
        results[tower] = {"program": program, "manifest": man, "mlpackage": pkg}
    return results


def main(argv=None):
    """The reference pytorch_to_coreml.py's flags, as the JAX CLI's."""
    ap = argparse.ArgumentParser(prog="nans_clip_tpu_torch.deploy.coreml",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--convert-only", default=None, metavar="PT2",
                    help="skip stage 1: convert an existing *.pt2 (with its sibling "
                         "*.manifest.json) to .mlpackage, the converter machine's half")
    ap.add_argument("--model-arch", default=None, help="e.g. ViT-B-16 (registry name)")
    ap.add_argument("--pytorch-ckpt-path", default=None,
                    help=".pt checkpoint (or an HF snapshot's weights); random init if absent")
    ap.add_argument("--save-coreml-path", default=None,
                    help="output path PREFIX (reference convention); required unless "
                         "--convert-only")
    ap.add_argument("--convert-text", action="store_true")
    ap.add_argument("--convert-vision", action="store_true")
    ap.add_argument("--precision", default="fp16", choices=["fp16", "fp32"])
    ap.add_argument("--context-length", type=int, default=52)
    args = ap.parse_args(argv)

    if args.convert_only:
        program = args.convert_only
        if not program.endswith(".pt2"):
            ap.error(f"--convert-only takes a stage-1 .pt2, got {program}")
        stem = program[:-len(".pt2")]
        if convert_mlpackage(program, stem + ".manifest.json", stem + ".mlpackage") is None:
            raise SystemExit("conversion toolchain unavailable")
        return
    if not args.model_arch or not args.save_coreml_path:
        ap.error("--model-arch and --save-coreml-path are required (unless --convert-only)")

    from nans_clip_tpu_torch.api import create_model
    from nans_clip_tpu_torch.configs import MODEL_INFO

    arch = args.model_arch
    if "@" not in arch:   # reference-style bare arch (ViT-B-16, RN50, ...)
        vision, text, _ = MODEL_INFO[arch]
        arch = f"{vision}@{text}"
    model = create_model(arch, args.pytorch_ckpt_path, device="cpu")
    export_coreml(model.cfg, model.module, args.save_coreml_path,
                  convert_text=args.convert_text, convert_vision=args.convert_vision,
                  precision=args.precision, context_length=args.context_length)


if __name__ == "__main__":
    main()
