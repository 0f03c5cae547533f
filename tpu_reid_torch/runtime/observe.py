"""Observability: structured metric logging, traces and step timing (the
port of tpu_reid/runtime/observe.py).

  * MetricLogger — JSONL event stream + console lines, per-phase wall-time
    accounting (a copy of the JAX package's),
  * synced_phase — a MetricLogger phase that waits for the CUDA device
    before it ends, so the phase's seconds hold the device work it queued,
  * trace — torch.profiler around a code region, written as a Chrome trace,
  * StepTimer — EMA step timing that waits for the CUDA device at each mark.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Optional

import torch

from tpu_reid_torch.device import DeviceLike


class MetricLogger:
    def __init__(self, log_dir: Optional[str] = None, console: bool = True):
        self.console = console
        self._fh = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._fh = open(os.path.join(log_dir, "metrics.jsonl"), "a")

    def log(self, event: str, **fields: Any) -> None:
        rec = {"ts": time.time(), "event": event, **fields}
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        if self.console:
            kv = " ".join(
                f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in fields.items()
            )
            print(f"[{event}] {kv}")

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.log("phase", name=name, seconds=time.perf_counter() - t0)

    def close(self):
        if self._fh:
            self._fh.close()


@contextlib.contextmanager
def synced_phase(log, name: str, device: torch.device):
    """`log.phase(name)` around the block, synchronising `device` (when it
    is a CUDA device) before the phase ends; nothing at all when log is
    None. `log` is a MetricLogger or anything with a `phase(name)` context
    manager."""
    if log is None:
        yield
        return
    with log.phase(name):
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler around the block (CPU activity, and the CUDA device's
    when there is one), written to `log_dir/trace_<ns>.json` as a Chrome
    trace (chrome://tracing, Perfetto). Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{time.time_ns()}.json"))


class StepTimer:
    """EMA step timer. `mark()` waits for `device` when it is a CUDA device
    (launches return before the device has run them), then reads the
    clock; on the CPU it only reads the clock."""

    def __init__(self, alpha: float = 0.1, device: DeviceLike = "cpu"):
        self.alpha = alpha
        self.device = torch.device(device)
        self.ema: Optional[float] = None
        self._t0 = time.perf_counter()

    def mark(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - self._t0
        self._t0 = time.perf_counter()
        self.ema = dt if self.ema is None else self.alpha * dt + (1 - self.alpha) * self.ema
        return dt
