"""A copy of the benchmark in a temporary directory with one tiny cell a
driver (2-layer towers at width 64), for CPU runs of the harness: new
files and entries only, as a later change would add them. The serving and
data-parallel drivers, whose cells are not in ``BENCHMARK.json`` yet, get
tiny cells here too, from their mixes and limits."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

TINY = dict(name="tiny", image_resolution=32, vision_layers=2, vision_width=64,
            vision_patch_size=16, vision_head_width=32, embed_dim=64, text_hidden_size=64,
            text_num_hidden_layers=2, text_num_attention_heads=4, text_intermediate_size=128)

# tiny cell -> (the mix it shrinks, the limits it takes, mix overrides)
CELLS = {
    "embed-tiny": ("embed-b256", "embed-vitb16-b256", {"batch": 8, "pool": 2, "trace_iters": 2}),
    "train-tiny": ("train-muge-b128", "train-vitb16-b128",
                   {"batch": 8, "pool": 4, "trace_iters": 2, "warmup_steps": 1}),
    "train-dp-tiny": ("train-dp4-muge-b512", "train-dp4-vitb16",
                      {"batch": 8, "pool": 2, "trace_iters": 2, "warmup_steps": 1,
                       "probe_steps": 1}),
    "serve-tiny": ("serve-mixed-600", "serve-vith14-saturated",
                   {"rate": 40.0, "clients": 8, "jpeg_pool": 8, "sample": 16,
                    "trace_seconds": 0.5}),
}

# the end-to-end metrics a driver kind reports
KIND_METRICS = {"embed": {"embed_pairs_per_s": "pairs/s"},
                "train": {"train_pairs_per_s": "pairs/s", "train_peak_gib": "GiB"},
                "train_dp": {"train_pairs_per_s": "pairs/s", "train_peak_gib": "GiB"},
                "serve": {"serve_req_per_s": "req/s"}}


def write(path: Path, obj) -> None:
    path.write_text(json.dumps(obj, indent=1))


def make(root: Path, dtype: str = "float32") -> Path:
    """Copy ``BENCHMARK.json`` and ``perfbench/`` under ``root`` and add
    the tiny configuration, mixes, limits, cells and their metrics.
    Returns ``root``."""
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(REPO / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    pb = root / "perfbench"
    base = json.loads((pb / "configs" / "vitb16-rbt-base.json").read_text())
    write(pb / "configs" / "tiny.json", {**base, **TINY, "dtype": dtype})
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="tiny",
                                 file="perfbench/configs/tiny.json"))
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for name, (mix_name, limits, over) in CELLS.items():
        mix = json.loads((pb / "traffic" / f"{mix_name}.json").read_text())
        write(pb / "traffic" / f"{name}.json", {**mix, **over})
        shutil.copy(pb / "limits" / f"{limits}.json", pb / "limits" / f"{name}.json")
        chips = 4 if mix["kind"] == "train_dp" else 1
        bench["workloads"].append({"name": name, "config": "tiny", "traffic": name,
                                   "chips": chips, "why": "a tiny CPU run"})
        for metric, unit in KIND_METRICS[mix["kind"]].items():
            if metric not in e2e:
                e2e[metric] = {"name": metric, "unit": unit, "better": "higher", "bound": 0.1,
                               "source": "host_clock", "workloads": []}
                bench["end_to_end"].append(e2e[metric])
            e2e[metric]["workloads"].append(name)
        for m in bench["per_layer"]:
            if limits in m.get("workloads", []):
                m["workloads"].append(name)
    write(root / "BENCHMARK.json", bench)
    return root


def use(root: Path, monkeypatch) -> None:
    """Point the harness at the copy under ``root``."""
    from perfbench import harness

    monkeypatch.setattr(harness, "HERE", root / "perfbench")
    monkeypatch.setattr(harness, "ROOT", root)
