"""The trace reduction on a made-up trace: busy time, idle gaps labelled by
the benchmark's span and the host's op, the top device operations."""

from types import SimpleNamespace

import pytest
import torch

from portbench.trace import TraceData

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


def ev(name, a, b, dev=CPU, thread=1):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=a, end=b),
                           device_type=dev, thread=thread)


EVENTS = [
    ev("bench.window", 0, 1000),
    ev("bench.window", 0, 1000, CUDA),
    ev("aten::copy_", 100, 300),
    ev("aten::empty", 150, 160),
    ev("worker op", 0, 1000, thread=2),
    ev("gemm_bf16_kernel", 0, 100, CUDA),
    ev("gemm_bf16_kernel", 300, 600, CUDA),
    ev("attention_bf16_kernel", 550, 900, CUDA),
    ev("Memcpy HtoD", 902, 903, CUDA),
]


def test_busy_and_gaps():
    t = TraceData.from_events(EVENTS, "bench.window")
    assert t.window_s == pytest.approx(1e-3)
    assert t.busy_s == pytest.approx((100 + 600 + 1) * 1e-6)
    gaps = dict(t.idle_gaps())
    assert gaps["bench.window / aten::copy_"] == pytest.approx(200e-6)
    assert gaps["bench.window / host: no traced op"] == pytest.approx(97e-6)
    assert gaps["other (gaps under 5 us)"] == pytest.approx(2e-6)
    assert t.device_seconds(["gemm_bf16"]) == pytest.approx(400e-6)
    assert t.device_ops()[0][0] == "gemm_bf16_kernel"


def test_missing_span_raises():
    with pytest.raises(RuntimeError):
        TraceData.from_events(EVENTS[1:], "bench.window")


def test_a_trace_missing_kernels_is_not_whole():
    launches = [ev("cudaLaunchKernel", 10 * i, 10 * i + 2) for i in range(3)]
    assert TraceData.from_events(EVENTS + launches, "bench.window").complete
    more = launches + [ev("cuLaunchKernel", 500, 502)]
    assert not TraceData.from_events(EVENTS + more, "bench.window").complete
