"""What every driver shares: the run's context and outcome, the seeds of
its parts, the cell's files found by name, and the program under test
built from the benchmark's weights.

A cell (``BENCHMARK.json`` ``workloads``) names a configuration, found at
``perfbench/configs/<config>.json``, and a traffic mix, found at
``perfbench/traffic/<traffic>.json``; the mix's ``kind`` names the driver
(``perfbench/drivers/<kind>.py``) that runs it, and the cell's limits on
the numbers it compares are ``perfbench/limits/<cell>.json``. A
per-layer metric's reader is ``perfbench/metrics/<metric>.py``.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import os
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return load_json(HERE / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return load_json(HERE / "traffic" / f"{name}.json")


def limits(cell_name: str) -> dict:
    return load_json(HERE / "limits" / f"{cell_name}.json")


def driver(kind: str):
    return importlib.import_module(f"perfbench.drivers.{kind}")


def reader(metric: str):
    """The per-layer metric's reader module (its file name is the
    metric's name, dots and all)."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench.metrics." + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def applies(metric: dict, cell_name: str, bench: dict) -> bool:
    """Whether ``metric`` is reported in the cell: listed there, or (no
    ``workloads`` key) in every cell, or in every cell that reports the
    end-to-end metric it moves."""
    if "workloads" in metric:
        return cell_name in metric["workloads"]
    if "moves" in metric:
        moved = next(m for m in bench["end_to_end"] if m["name"] == metric["moves"])
        return applies(moved, cell_name, bench)
    return True


def subseed(seed: int, tag: int) -> int:
    """A 63-bit seed for one part of a run (weights, inputs, arrivals...)."""
    a, b = np.random.SeedSequence([seed & 0xFFFF_FFFF_FFFF_FFFF, tag]).generate_state(2)
    return ((int(a) << 31) ^ int(b)) & 0x7FFF_FFFF_FFFF_FFFF


TAG_INPUTS, TAG_ORDER, TAG_STEPS, TAG_SAMPLE = 1, 2, 3, 4


def fixed_multiset(spec: dict, n: int) -> np.ndarray:
    """``n`` integer sizes from a fixed draw (``spec["shape_seed"]``, the
    same for every run): a lognormal of median ``median`` and shape
    ``sigma``, rounded and clipped to [min, max]. Runs permute it; they
    never draw other sizes."""
    rng = np.random.default_rng(spec.get("shape_seed", 0))
    x = spec["median"] * np.exp(spec["sigma"] * rng.standard_normal(n))
    return np.clip(np.rint(x), spec["min"], spec["max"]).astype(np.int64)


@dataclasses.dataclass
class Context:
    cell: dict
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: Any
    t_start: float          # process start, on the perf_counter clock


@dataclasses.dataclass
class Outcome:
    attempted: int
    failed: int
    metrics: Dict[str, float]                   # end-to-end, by name
    checks: Dict[str, Tuple[float, float]]      # compared number -> (value, limit)
    memory_peak_bytes: int
    observations: Dict[str, Any] = dataclasses.field(default_factory=dict)
    trace: Optional[Any] = None                 # trace.Trace of the sub-window
    notes: List[str] = dataclasses.field(default_factory=list)

    @property
    def correct(self) -> bool:
        return (self.failed == 0 and self.attempted > 0 and bool(self.checks)
                and all(np.isfinite(v) and v <= lim for v, lim in self.checks.values()))


class Phases:
    """Seconds since the process started at each named point of set-up, for
    an earlier line of the run's standard error."""

    def __init__(self, t_start: float):
        self.t_start, self.marks = t_start, []

    def mark(self, name: str) -> None:
        import time

        self.marks.append((name, round(time.perf_counter() - self.t_start, 3)))

    def line(self) -> str:
        return "setup_phases " + " ".join(f"{n}={t}" for n, t in self.marks)


def program_config(cfg: dict):
    """The port's ``CLIPConfig`` of a configuration file."""
    from nans_clip_tpu_torch.configs import CLIPConfig, TextConfig, VisionConfig

    vision = VisionConfig(embed_dim=cfg["embed_dim"], image_resolution=cfg["image_resolution"],
                          layers=cfg["vision_layers"], width=cfg["vision_width"],
                          patch_size=cfg["vision_patch_size"],
                          head_width=cfg["vision_head_width"])
    text = TextConfig(vocab_size=cfg["vocab_size"], hidden_size=cfg["text_hidden_size"],
                      num_hidden_layers=cfg["text_num_hidden_layers"],
                      num_attention_heads=cfg["text_num_attention_heads"],
                      intermediate_size=cfg["text_intermediate_size"],
                      hidden_act=cfg["text_hidden_act"],
                      hidden_dropout_prob=cfg["text_hidden_dropout_prob"],
                      attention_probs_dropout_prob=cfg["text_attention_probs_dropout_prob"],
                      max_position_embeddings=cfg["text_max_position_embeddings"],
                      type_vocab_size=cfg["text_type_vocab_size"],
                      initializer_range=cfg["text_initializer_range"],
                      layer_norm_eps=cfg["text_layer_norm_eps"])
    return CLIPConfig(embed_dim=cfg["embed_dim"], vision=vision, text=text,
                      name=cfg.get("model", cfg["name"]))


def program_module(cfg: dict, seed: int, device, phases: Optional["Phases"] = None):
    """The port's fp32 ``CLIP`` on ``device`` holding the seed's weights."""
    import torch

    from nans_clip_tpu_torch.models.clip import build_clip
    from perfbench.reference import weights

    module = build_clip(program_config(cfg), device)
    if phases is not None:
        phases.mark("build_clip")
    with torch.no_grad():
        weights.fill(dict(module.named_parameters()), cfg, seed)
    if phases is not None:
        phases.mark("weights")
    return module


def compute_options(cfg: dict, **kw):
    from nans_clip_tpu_torch.models.common import ModelOptions

    dtype = None if cfg["dtype"] == "float32" else cfg["dtype"]
    return ModelOptions(compute_dtype=dtype, **kw)


def reference_weights(cfg: dict, seed: int, device, served_dtype=None):
    """The reference's fp32 copy of the seed's weights; ``served_dtype``:
    each rounded through the dtype the program serves it in (all but
    ``logit_scale``, which the program keeps in fp32)."""
    import torch

    from perfbench.reference import weights

    w = weights.make(cfg, seed, device)
    if served_dtype is not None and served_dtype != "float32":
        dt = getattr(torch, served_dtype)
        w = {k: v if k == "logit_scale" else v.to(dt).float() for k, v in w.items()}
    return w


def free(device) -> None:
    import torch

    gc.collect()
    if getattr(device, "type", "cpu") == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def steady() -> None:
    """Before a window: collect once, then move every object set-up made
    out of the collector's reach (``gc.freeze``), so that a collection in
    the window scans only what the window allocates."""
    gc.collect()
    gc.freeze()


def synchronizer(device):
    import torch

    if getattr(device, "type", "cpu") == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return lambda: None


def max_gap(a, b) -> float:
    """The largest absolute difference of two feature matrices; infinite
    where either holds a NaN (so no ``max`` over gaps can pass it by)."""
    gap = float((a.float() - b.float()).abs().max())
    return gap if gap == gap else float("inf")


def env_setup() -> None:
    """Build and kernel caches inside the checkout, at fixed paths; no
    library of the program loads JAX."""
    cache = HERE / ".cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    # one process, few threads: no CPU thread pool spinning beside the loop
    os.environ.setdefault("OMP_NUM_THREADS", "1")
