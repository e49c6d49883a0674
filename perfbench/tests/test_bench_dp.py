"""The data-parallel cell at a tiny size on the CPU: four gloo ranks, the
reference over the global batch in one process; leaving the exchange
between ranks out makes it not correct."""

from __future__ import annotations

import tempfile
from pathlib import Path

import pytest
import torch

from perfbench import run
from perfbench.drivers import train_dp
from perfbench.tests import tiny


@pytest.fixture
def copy(monkeypatch):
    root = tiny.make(Path(tempfile.mkdtemp()))
    tiny.use(root, monkeypatch)
    return root


def execute(trace: int = 0):
    args = run.parse_args(["--workload", "train-dp-tiny", "--seed", str(2 ** 31 + 5),
                           "--seconds", "1", "--trace", str(trace)])
    return run.execute(args, torch.device("cpu"))


def test_four_ranks_are_correct(copy):
    out, metrics = execute()
    assert out.correct, (out.checks, out.notes)
    assert set(metrics) == {"train_pairs_per_s", "train_peak_gib", "setup_s"}


def rank_without_exchange(rank, spec):
    from nans_clip_tpu_torch.parallel import fsdp

    fsdp.all_reduce_mean = lambda params, group: None
    return train_dp._rank(rank, spec)


def test_the_exchange_left_out_is_not_correct(copy, monkeypatch):
    monkeypatch.setattr(train_dp, "RANK_MAIN", rank_without_exchange)
    out, _ = execute()
    assert not out.correct, out.checks
