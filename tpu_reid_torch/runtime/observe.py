"""Observability: structured metric logging.

  * MetricLogger — JSONL event stream + console lines, per-phase wall-time
    accounting (a copy of tpu_reid/runtime/observe.py's),
  * synced_phase — a MetricLogger phase that waits for the CUDA device
    before it ends, so the phase's seconds hold the device work it queued.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Optional

import torch


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
