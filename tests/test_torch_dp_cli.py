"""The port's training CLI across ranks (``training/main.py --distributed``)
on the CPU: two processes launched with torchrun's environment names and a
gloo group, against the one-process CLI, at ``tiny_config()`` in fp32 with
its text dropout (0.1), FLIP 0.5 and augmentation on.

* ``--batch-size 4`` at world 2 is the global batch 8 of one process at
  ``--batch-size 8``: the loader's ``blocks`` layout gives the two ranks the
  two halves of that global batch and every draw is made for the global
  batch, so each step's loss (``metrics.jsonl``, written by rank 0 alone)
  and the epoch's validation (``--valid-batch-size`` likewise) equal the
  one-process run's within 1e-5 (the same arithmetic, summed in another
  order), with ``--fsdp`` (``--fsdp-min-size 1024``) and with ``--tp 2``
  (world 2 is then data 1 x tp 2, the global batch 8 on both).
* Checkpoints are one process's: a ``step_2`` written at world 2 resumes at
  world 1, and one written at world 1 resumes at world 2, each continuing
  the one-process trajectory (steps 3 and 4 within 1e-5).
* SIGTERM to one rank: the ranks agree on the stop step, ``preempt_step_N``
  is saved once, every rank exits 0. A rank that raises (a missing
  ``--resume`` tag on rank 1) fails the other within ``--dist-timeout``.
* ``--pp > 1`` is refused (tests/test_torch_cli.py), and the LoRA trainer
  refuses data parallelism.
"""

import io
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from nans_clip_tpu_torch import configs
from nans_clip_tpu_torch.data.npack import NPackWriter, encode_pair
from nans_clip_tpu_torch.models.common import ModelOptions
from nans_clip_tpu_torch.training import main as tmain
from nans_clip_tpu_torch.training import train_lora

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_TOL = 1e-5


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """32 pairs of seeded noise JPEGs, 40 pixels (decoded to tiny_config's 32)."""
    from PIL import Image
    root = tmp_path_factory.mktemp("dp_split")
    rs = np.random.RandomState(1)
    with NPackWriter(str(root / "imgs.npack")) as wi, \
            NPackWriter(str(root / "pairs.npack")) as wp:
        for i in range(32):
            buf = io.BytesIO()
            Image.fromarray(rs.randint(0, 255, (40, 40, 3), dtype=np.uint8)).save(
                buf, format="JPEG")
            wi.put(i, buf.getvalue())
            wp.put(i, encode_pair(i, i, f"图{i}"))
    return str(root)


def _args(split, logs, name, batch, *extra):
    return ["--train-data", split, "--tiny-model", "--precision", "fp32", "--attn-impl", "xla",
            "--lr", "1e-3", "--warmup", "2", "--log-interval", "1", "--logs", logs, "--name",
            name, "--num-workers", "2", "--seed", "7", "--batch-size", str(batch),
            "--use-augment", "--mask-ratio", "0.5", "--save-step-frequency", "2",
            "--val-data", split, "--valid-batch-size", str(batch), "--platform", "cpu",
            *extra]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _start(argv_per_rank, out_dir):
    """The ranks as processes of ``python -m nans_clip_tpu_torch.training.main``
    with torchrun's environment names."""
    port, world = _free_port(), len(argv_per_rank)
    procs = []
    for r, argv in enumerate(argv_per_rank):
        env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(r),
                   WORLD_SIZE=str(world), LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(world),
                   OMP_NUM_THREADS="1")
        log = open(os.path.join(out_dir, f"rank{r}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "nans_clip_tpu_torch.training.main", "--distributed", *argv],
            cwd=ROOT, env=env, stdout=log,
            stderr=subprocess.STDOUT), log))
    return procs


def _wait(procs, out_dir, timeout=240.0):
    """The ranks' exit codes (each killed past ``timeout``)."""
    deadline, codes = time.monotonic() + timeout, []
    for p, log in procs:
        try:
            codes.append(p.wait(timeout=max(deadline - time.monotonic(), 1.0)))
        except subprocess.TimeoutExpired:
            p.kill()
            codes.append(p.wait())
        log.close()
    return codes


def _logs(out_dir, n):
    return "\n".join(open(os.path.join(out_dir, f"rank{r}.log")).read()[-3000:]
                     for r in range(n))


def _run_world2(argv_per_rank, out_dir):
    procs = _start(argv_per_rank, out_dir)
    codes = _wait(procs, out_dir)
    assert codes == [0, 0], _logs(out_dir, 2)


def _losses(logs, name):
    with open(os.path.join(logs, name, "metrics.jsonl")) as f:
        return {r["step"]: r["loss"] for r in map(json.loads, f) if r["kind"] == "train"}


def _valid(logs, name):
    with open(os.path.join(logs, name, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if r["kind"] == "valid"]


def _close(got: dict, want: dict, steps):
    for s in steps:
        assert abs(got[s] - want[s]) <= LOSS_TOL, (s, got, want)


@pytest.fixture(scope="module")
def one_process(split, tmp_path_factory):
    """4 steps of one process at the global batch 8, a checkpoint at step 2."""
    logs = str(tmp_path_factory.mktemp("one"))
    tmain.main(_args(split, logs, "one", 8, "--max-steps", "4"))
    return logs


@pytest.fixture(scope="module")
def world2_fsdp(split, tmp_path_factory):
    """4 steps of 2 ranks with --fsdp at --batch-size 4, a checkpoint at step 2."""
    logs = str(tmp_path_factory.mktemp("w2"))
    args = _args(split, logs, "w2", 4, "--max-steps", "4", "--fsdp", "--fsdp-min-size", "1024")
    _run_world2([args, args], logs)
    return logs


def test_world2_fsdp_matches_one_process(one_process, world2_fsdp):
    """Each step's loss at world 2 with --fsdp equals one process's at the
    same global batch; rank 0 alone wrote the logs and the checkpoints."""
    want = _losses(one_process, "one")
    got = _losses(world2_fsdp, "w2")
    assert sorted(got) == [1, 2, 3, 4]
    _close(got, want, range(1, 5))
    # the epoch-end validation over the global batch, weighted by samples
    (v2,), (v1,) = _valid(world2_fsdp, "w2"), _valid(one_process, "one")
    assert v2["samples"] == v1["samples"] == 32
    for k in ("loss", "i2t_acc", "t2i_acc"):
        assert abs(v2[k] - v1[k]) <= LOSS_TOL, (k, v2, v1)
    run = os.path.join(world2_fsdp, "w2")
    assert len([f for f in os.listdir(run) if f.startswith("params_")]) == 1
    assert len([f for f in os.listdir(run) if f.startswith("out_")]) == 1
    ckpt = os.path.join(run, "checkpoints")
    assert sorted(os.listdir(ckpt)) == sorted(os.listdir(os.path.join(one_process, "one",
                                                                      "checkpoints")))
    mine = torch.load(os.path.join(ckpt, "step_2", "state.pt"), weights_only=True)
    theirs = torch.load(os.path.join(one_process, "one", "checkpoints", "step_2", "state.pt"),
                        weights_only=True)
    assert mine["state_dict"].keys() == theirs["state_dict"].keys()
    assert len(mine["optimizer"]["state"]) == len(theirs["optimizer"]["state"])
    for k, v in mine["state_dict"].items():
        assert v.shape == theirs["state_dict"][k].shape, k


def _copy_run(src_logs, src_name, dst_logs, dst_name):
    os.makedirs(os.path.join(dst_logs, dst_name))
    shutil.copytree(os.path.join(src_logs, src_name, "checkpoints"),
                    os.path.join(dst_logs, dst_name, "checkpoints"))


def test_resume_world2_checkpoint_at_world1(split, one_process, world2_fsdp, tmp_path):
    """``step_2`` of the world-2 FSDP run resumes in one process and
    continues the one-process trajectory."""
    logs = str(tmp_path)
    _copy_run(world2_fsdp, "w2", logs, "r1")
    tmain.main(_args(split, logs, "r1", 8, "--max-steps", "4", "--resume", "step_2"))
    got = _losses(logs, "r1")
    assert sorted(got) == [3, 4]
    _close(got, _losses(one_process, "one"), (3, 4))


def test_resume_world1_checkpoint_at_world2(split, one_process, tmp_path):
    """``step_2`` of the one-process run resumes at world 2 and continues
    its trajectory."""
    logs = str(tmp_path)
    _copy_run(one_process, "one", logs, "r2")
    args = _args(split, logs, "r2", 4, "--max-steps", "4", "--resume", "step_2")
    _run_world2([args, args], logs)
    got = _losses(logs, "r2")
    assert sorted(got) == [3, 4]
    _close(got, _losses(one_process, "one"), (3, 4))


def test_tp2_matches_one_process(split, one_process, tmp_path):
    """``--tp 2`` at world 2 (data 1 x tp 2: the global batch 8 on both
    ranks) equals one process."""
    logs = str(tmp_path)
    args = _args(split, logs, "tp", 8, "--max-steps", "2", "--tp", "2")
    _run_world2([args, args], logs)
    _close(_losses(logs, "tp"), _losses(one_process, "one"), (1, 2))


def test_sigterm_to_one_rank_stops_all(split, tmp_path):
    """SIGTERM to rank 1 mid-run: both ranks stop at the same step, one
    ``preempt_step_N`` is saved (by rank 0), and every rank exits 0."""
    logs = str(tmp_path)
    args = _args(split, logs, "pre", 4, "--max-steps", "100000", "--save-step-frequency", "0")
    procs = _start([args, args], logs)
    metrics = os.path.join(logs, "pre", "metrics.jsonl")
    deadline = time.monotonic() + 180
    while time.monotonic() < deadline and not (os.path.exists(metrics)
                                               and open(metrics).read().count("\n") >= 2):
        assert all(p.poll() is None for p, _ in procs), _logs(logs, 2)
        time.sleep(0.2)
    procs[1][0].send_signal(signal.SIGTERM)
    codes = _wait(procs, logs, timeout=120)
    assert codes == [0, 0], _logs(logs, 2)
    ckpt = os.path.join(logs, "pre", "checkpoints")
    saved = [d for d in os.listdir(ckpt)
             if d.startswith("preempt_step_") and os.path.isdir(os.path.join(ckpt, d))]
    assert len(saved) == 1, os.listdir(ckpt)
    last = max(_losses(logs, "pre"))
    assert saved[0] == f"preempt_step_{last}"
    with open(os.path.join(ckpt, "LATEST")) as f:
        assert f.read() == saved[0]


def test_a_failing_rank_fails_the_run(split, tmp_path):
    """Rank 1 raises (its ``--resume`` tag does not exist); rank 0, waiting
    in a collective, fails within ``--dist-timeout`` instead of hanging."""
    logs = str(tmp_path)
    args = _args(split, logs, "bad", 4, "--max-steps", "4", "--dist-timeout", "20")
    t0 = time.monotonic()
    procs = _start([args, args + ["--resume", "no_such_tag"]], logs)
    codes = _wait(procs, logs, timeout=120)
    assert codes[0] != 0 and codes[1] != 0, _logs(logs, 2)
    assert time.monotonic() - t0 < 90
    assert "no_such_tag" in open(os.path.join(logs, "rank1.log")).read()


def test_lora_refuses_data_parallelism(tmp_path, monkeypatch):
    """The LoRA trainer runs on one rank: ``make_lora_step`` refuses
    ``data`` > 1, and the CLI refuses ``--distributed`` and a launcher's
    world of 2."""
    with pytest.raises(NotImplementedError, match="one rank"):
        train_lora.make_lora_step(configs.tiny_config(), ModelOptions(data=2), 16.0, 0.0, 1)
    argv = ["--train-data", str(tmp_path), "--tiny-model", "--platform", "cpu"]
    with pytest.raises(ValueError, match="one rank"):
        train_lora.main(argv + ["--distributed"])
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="one rank"):
        train_lora.main(argv)
