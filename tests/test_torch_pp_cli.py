"""The port's training CLI with ``--pp 2`` (``training/main.py``) on the
CPU: two processes launched with torchrun's environment names and a gloo
group (data 1 x pipe 2), against the one-process CLI, at ``tiny_config()`` in
fp32 with its text dropout (0.1), FLIP 0.5 and augmentation on (the
arguments of tests/test_torch_dp_cli.py).

* ``--pp 2 --grad-checkpointing`` at ``--batch-size 8`` is the global batch
  8 of one process: each step's loss (``metrics.jsonl``, rank 0's) and the
  epoch's validation equal the one-process run's within 1e-5; the GPipe
  bubble is logged as the JAX CLI logs it; rank 0 alone writes the
  checkpoints, one process's layout.
* ``step_2`` written at pp 2 resumes in one process, and one written by one
  process resumes at pp 2, each continuing the one-process trajectory
  (steps 3 and 4 within 1e-5).
* ``--pp 2`` on one process and ``--tp 2 --pp 2`` are refused
  (tests/test_torch_cli.py), and the LoRA trainer refuses ``pp`` > 1.
"""

import os

import pytest
import torch

from nans_clip_tpu_torch import configs
from nans_clip_tpu_torch.models.common import ModelOptions
from nans_clip_tpu_torch.training import main as tmain
from nans_clip_tpu_torch.training import train_lora

from test_torch_dp_cli import (_args, _close, _copy_run, _losses, _run_world2, _valid,  # noqa: F401
                               one_process, split)

torch.set_num_threads(2)

PP = ("--pp", "2", "--grad-checkpointing")


@pytest.fixture(scope="module")
def pipe2(split, tmp_path_factory):
    """4 steps at --pp 2 with remat, --batch-size 8, a checkpoint at step 2."""
    logs = str(tmp_path_factory.mktemp("pp2"))
    args = _args(split, logs, "pp2", 8, "--max-steps", "4", *PP)
    _run_world2([args, args], logs)
    return logs


def test_pipe2_matches_one_process(one_process, pipe2):
    """Each step's loss and the validation at --pp 2 equal one process's;
    the bubble line and one process's checkpoint layout."""
    want = _losses(one_process, "one")
    got = _losses(pipe2, "pp2")
    assert sorted(got) == [1, 2, 3, 4]
    _close(got, want, range(1, 5))
    (v2,), (v1,) = _valid(pipe2, "pp2"), _valid(one_process, "one")
    for k in ("loss", "i2t_acc", "t2i_acc"):
        assert abs(v2[k] - v1[k]) <= 1e-5, (k, v2, v1)
    run = os.path.join(pipe2, "pp2")
    log = open(os.path.join(run, [f for f in os.listdir(run) if f.startswith("out_")][0])).read()
    assert "pipeline: pp=2 microbatches=4 (2 samples each) GPipe bubble=20.0%" in log
    assert "(data 1 x tp 1 x pp 2), backend gloo" in log
    mine = torch.load(os.path.join(run, "checkpoints", "step_2", "state.pt"), weights_only=True)
    theirs = torch.load(os.path.join(one_process, "one", "checkpoints", "step_2", "state.pt"),
                        weights_only=True)
    assert mine["state_dict"].keys() == theirs["state_dict"].keys()
    assert sorted(mine["optimizer"]["state"]) == sorted(theirs["optimizer"]["state"])
    for k, v in mine["state_dict"].items():
        assert v.shape == theirs["state_dict"][k].shape, k


def test_resume_pipe2_checkpoint_at_pp1(split, one_process, pipe2, tmp_path):
    """``step_2`` of the pp 2 run resumes in one process."""
    logs = str(tmp_path)
    _copy_run(pipe2, "pp2", logs, "r1")
    tmain.main(_args(split, logs, "r1", 8, "--max-steps", "4", "--resume", "step_2"))
    got = _losses(logs, "r1")
    assert sorted(got) == [3, 4]
    _close(got, _losses(one_process, "one"), (3, 4))


def test_resume_one_process_checkpoint_at_pp2(split, one_process, tmp_path):
    """``step_2`` of the one-process run resumes at --pp 2."""
    logs = str(tmp_path)
    _copy_run(one_process, "one", logs, "r2")
    args = _args(split, logs, "r2", 8, "--max-steps", "4", "--resume", "step_2", *PP)
    _run_world2([args, args], logs)
    got = _losses(logs, "r2")
    assert sorted(got) == [3, 4]
    _close(got, _losses(one_process, "one"), (3, 4))


def test_lora_refuses_pipeline_parallelism():
    """``make_lora_step`` refuses ``pp`` > 1 (the JAX LoRA trainer has no
    mesh)."""
    with pytest.raises(NotImplementedError, match="one rank: pp=2"):
        train_lora.make_lora_step(configs.tiny_config(), ModelOptions(pp=2), 16.0, 0.0, 1)
