"""The yardstick's card-only parts: a profiled sub-window reduces to a
sound trace, and the fp8 control computes on the card. Each test skips
without a CUDA device (``python -m pytest -m cuda perfbench/tests`` on the
card)."""

from __future__ import annotations

import pytest
import torch

from perfbench import trace
from perfbench.reference import model as ref_model


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_a_profiled_kernel_loop_is_a_sound_trace():
    dev = card()
    x = torch.randn(2048, 2048, device=dev, dtype=torch.bfloat16)
    sync = lambda: torch.cuda.synchronize(dev)

    def work():
        for _ in range(20):
            with torch.profiler.record_function("bench.step"):
                x @ x

    t = trace.profiled(work, sync)
    assert t.sound
    assert t.kernel_events >= 20 and t.launches >= 20
    assert 0 < t.busy_s <= t.window_s
    assert all(name != "bench.step" for name, _ in t.device_ops)


@pytest.mark.cuda
def test_the_fp8_control_rounds_coarser_than_bf16_on_the_card():
    dev = card()
    g = torch.Generator(dev).manual_seed(0)
    a = torch.randn(256, 512, device=dev, generator=g)
    b = torch.randn(512, 256, device=dev, generator=g)
    exact = ref_model.FP32.matmul(a, b)
    fp8 = ref_model.Precision("fp8").matmul(a, b)
    bf16 = (a.bfloat16() @ b.bfloat16()).float()
    assert (fp8 - exact).abs().max() > 4 * (bf16 - exact).abs().max()
