"""Observability: structured metric logging, spans and traces (the port of
tpu_reid/runtime/observe.py).

  * MetricLogger — JSONL event stream + console lines, per-phase wall-time
    accounting (a copy of the JAX package's); each phase is also a span,
  * synced_phase — a MetricLogger phase that waits for the CUDA device
    before it ends, so the phase's seconds hold the device work it queued,
  * span — a named range of the host's work, recorded only while a
    torch.profiler is recording (one flag check otherwise),
  * trace — torch.profiler around a code region, written as a Chrome trace.

The program's spans (names in the `reid.` namespace) mark its layers: the
extraction loop (`reid.extract.*`, `reid.embed.preprocess`,
`reid.vit.stem`) and the training loops (`reid.train.*`). They have no
clock and no file of their own: they are events of whatever profiler records, on its clock beside the
device's events, and leave with its trace.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Optional

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _profiler

_OFF = contextlib.nullcontext()


def span(name: str, **ids: int):
    """A context manager naming the block in a profiler's trace, with `ids`
    (a batch or step index, a row count) as the record's arguments (in the
    trace where the profiler records shapes). While no profiler records it
    is one flag check and a shared null context: nothing is recorded, timed
    or kept.

    The record is of the profiler's own operator kind (the form torch's
    compiled code uses), not `record_function`'s user annotation: under
    CUDA activity a user annotation also leaves an event on the device's
    timeline, which a reader of the trace would have to tell from device
    work. Its inputs must be a tuple and its arguments a dict (anything
    else aborts the process, not raises), and an argument that is not a
    Python number reaches the trace as NULL, so each id is made an int here
    (a numpy integer or a one-element tensor included)."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _RecordFunctionFast(name, (), {k: int(v) for k, v in ids.items()})


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
        """Logs the block's wall time as a "phase" event, and names it as a
        span."""
        t0 = time.perf_counter()
        try:
            with span(name):
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
    None. `log` is a MetricLogger (whose phase is a span) or anything with a
    `phase(name)` context manager."""
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
    trace (chrome://tracing, Perfetto): the program's spans on the host's
    threads, with their arguments, above the device's events. Yields the
    profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities, record_shapes=True) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{time.time_ns()}.json"))

