"""Whole runs of tiny cells on the CPU: a sound run is correct, each fault
a cell can have planted under the timed path makes it not correct, and a
configuration, mix and metric added as new files are found by name."""

from __future__ import annotations

import json
import tempfile
from pathlib import Path

import pytest
import torch

from perfbench import harness, run
from perfbench.tests import tiny


@pytest.fixture
def copy(monkeypatch):
    root = tiny.make(Path(tempfile.mkdtemp()))
    tiny.use(root, monkeypatch)
    return root


def execute(cell: str, seed: int = 2 ** 31 + 3, seconds: float = 1.0, trace: int = 0):
    args = run.parse_args(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                           "--trace", str(trace)])
    return run.execute(args, torch.device("cpu"))


@pytest.mark.parametrize("cell", ["embed-tiny", "train-tiny", "serve-tiny"])
def test_a_sound_run_is_correct(copy, cell):
    out, metrics = execute(cell)
    assert out.correct, out.checks
    assert "setup_s" in metrics and len(metrics) >= 2


def _answer_altered(monkeypatch, cell):
    if cell == "embed-tiny":
        from nans_clip_tpu_torch.api import CLIPModel

        encode = CLIPModel.encode_image

        def altered(self, images):
            out = encode(self, images).clone()
            out[0] = -out[0]
            return out

        monkeypatch.setattr(CLIPModel, "encode_image", altered)
    else:
        from nans_clip_tpu_torch.deploy import server

        norm = server.normalized

        def altered(f):
            out = norm(f).clone()
            out[:, 0] += 0.5
            return out

        monkeypatch.setattr(server, "normalized", altered)


@pytest.mark.parametrize("cell", ["embed-tiny", "serve-tiny"])
def test_an_altered_answer_is_not_correct(copy, monkeypatch, cell):
    _answer_altered(monkeypatch, cell)
    out, _ = execute(cell)
    assert not out.correct, out.checks


def test_a_step_that_leaves_the_state_unchanged_is_not_correct(copy, monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step", lambda self, closure=None: None)
    out, _ = execute("train-tiny")
    assert not out.correct
    assert out.checks["update_gap"][0] == pytest.approx(1.0)


def test_half_the_batch_left_out_is_not_correct(copy, monkeypatch):
    from nans_clip_tpu_torch.training import trainer

    loss = trainer.clip_loss

    def half(img, txt, scale, smoothing=0.0):
        h = img.shape[0] // 2
        return loss(img[:h], txt[:h], scale, smoothing)

    monkeypatch.setattr(trainer, "clip_loss", half)
    out, _ = execute("train-tiny")
    assert not out.correct, out.checks


def test_a_new_config_mix_and_metric_are_found_by_name(copy):
    pb = copy / "perfbench"
    cfg = json.loads((pb / "configs" / "tiny.json").read_text())
    (pb / "configs" / "tiny-deep.json").write_text(json.dumps({**cfg, "name": "tiny-deep",
                                                                "vision_layers": 3}))
    mix = json.loads((pb / "traffic" / "embed-tiny.json").read_text())
    (pb / "traffic" / "embed-tiny-b4.json").write_text(json.dumps({**mix, "batch": 4}))
    (pb / "limits" / "embed-deep.json").write_text(
        (pb / "limits" / "embed-tiny.json").read_text())
    (pb / "metrics" / "test.pairs_seen.py").write_text(
        "def read(obs, trace):\n    return obs['flops'] and 1.0\n")
    bench = json.loads((copy / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="tiny-deep",
                                 file="perfbench/configs/tiny-deep.json"))
    bench["workloads"].append({"name": "embed-deep", "config": "tiny-deep",
                               "traffic": "embed-tiny-b4", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if "embed-tiny" in m.get("workloads", []):
            m["workloads"].append("embed-deep")
    bench["per_layer"].append({"name": "test.pairs_seen", "unit": "pairs", "better": "higher",
                               "source": "host_clock", "layer": "Model step",
                               "moves": "embed_pairs_per_s", "workloads": ["embed-deep"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))
    out, metrics = execute("embed-deep")
    assert out.correct and out.attempted % 4 == 0
    out, metrics = execute("embed-deep", trace=1)
    assert metrics["test.pairs_seen"]["value"] == 1.0


def test_half_the_rows_left_out_of_an_embedding_is_not_correct(copy, monkeypatch):
    from nans_clip_tpu_torch.api import CLIPModel

    encode = CLIPModel.encode_text

    def half(self, texts):
        out = encode(self, texts).clone()
        out[out.shape[0] // 2:] = 0     # rows the encoder never wrote
        return out

    monkeypatch.setattr(CLIPModel, "encode_text", half)
    out, _ = execute("embed-tiny")
    assert not out.correct, out.checks


@pytest.mark.parametrize("cell", ["embed-tiny", "train-tiny", "serve-tiny"])
def test_the_fp8_control_is_not_correct(copy, cell):
    from perfbench.reference import model as ref_model

    c = harness.cell(harness.benchmark(), cell)
    ctx = harness.Context(cell=c, config=harness.config(c["config"]),
                          traffic=harness.traffic(c["traffic"]), limits=harness.limits(cell),
                          seed=2 ** 31 + 11, seconds=1.0, trace=False,
                          device=torch.device("cpu"), t_start=0.0)
    numbers = harness.driver(ctx.traffic["kind"]).control(ctx, ref_model.Precision("fp8"))
    assert any(v > ctx.limits[k] for k, v in numbers.items()), numbers
