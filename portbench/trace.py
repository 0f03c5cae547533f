"""The traced window: a torch.profiler trace of the card and the host, and
its reduction to what the per-layer metrics and the breakdown read.

The window is the benchmark's own span (`record_function`) around its call
into the program; the device's busy time is the union of the intervals in
which a kernel, copy or memset ran inside it. An idle gap of the device is
labelled by the innermost benchmark span ("bench.*") and the innermost host
operation on the span's thread at the gap's middle: what the host was doing
while the card waited.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

TOP = 10  # entries of each breakdown list
TRIES = 3  # traced windows a cell takes before it gives up on a whole trace
SHORT_GAP_US = 5.0  # gaps below this are summed as one entry
NAME_CHARS = 90


class Tracer:
    """start() ... stop() around the window (also across callbacks: the
    training window opens in one and closes in another)."""

    def __init__(self, span: str):
        self.span = span
        self.prof = None
        self._rf = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile, record_function

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.start()
        self._rf = record_function(self.span)
        self._rf.__enter__()

    def stop(self) -> None:
        torch.cuda.synchronize()
        self._rf.__exit__(None, None, None)
        self.prof.stop()

    def reduce(self) -> "TraceData":
        return TraceData.from_events(self.prof.events(), self.span)


class TraceData:
    """Device events [(name, start_us, end_us)] and the window's host
    events, clipped to the window span."""

    def __init__(self, window: Tuple[float, float], device: list, host: list, spans: list,
                 launches: int = 0):
        self.window = window
        self.device = device
        self.host = host  # the window thread's events, (name, start, end), by start
        self.spans = spans  # the benchmark's spans on that thread
        self.launches = launches  # kernel launches the host made in the window

    @property
    def complete(self) -> bool:
        """Whether the trace holds a device event for every kernel the host
        launched in the window: the profiler has been seen to hand back short
        or empty traces, which would read low."""
        kernels = sum(1 for n, _, _ in self.device if not n.startswith(("Memcpy", "Memset")))
        return kernels >= self.launches and bool(self.device)

    @classmethod
    def from_events(cls, events, span: str) -> "TraceData":
        cuda = torch.autograd.DeviceType.CUDA
        win = [e for e in events if e.name == span and e.device_type != cuda]
        if not win:
            raise RuntimeError(f"the trace holds no {span!r} span")
        w = win[0]
        lo, hi = float(w.time_range.start), float(w.time_range.end)
        device, host, spans, launches = [], [], [], 0
        for e in events:
            a, b = float(e.time_range.start), float(e.time_range.end)
            if b < lo or a > hi:
                continue
            if e.device_type != cuda and "LaunchKernel" in e.name:
                launches += 1
            if e.device_type == cuda:
                # a span also leaves an annotation on the device's timeline:
                # no work of the card's
                if not e.name.startswith("bench."):
                    device.append((e.name, max(a, lo), min(b, hi)))
            elif e.thread != w.thread:
                continue
            elif e.name.startswith("bench."):
                spans.append((e.name, a, b))
            else:
                host.append((e.name, a, b))
        host.sort(key=lambda x: (x[1], -x[2]))
        spans.sort(key=lambda x: (x[1], -x[2]))
        return cls((lo, hi), device, host, spans, launches)

    # -- totals ------------------------------------------------------------

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        merged: List[list] = []
        for _, a, b in sorted(self.device, key=lambda x: x[1]):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def device_seconds(self, names: Optional[List[str]] = None) -> float:
        """Summed durations of the device events, or of those whose name
        holds one of `names`."""
        return sum(b - a for n, a, b in self.device
                   if names is None or any(k in n for k in names)) * 1e-6

    # -- breakdown ---------------------------------------------------------

    def device_ops(self) -> List[list]:
        by: Dict[str, float] = defaultdict(float)
        for n, a, b in self.device:
            by[n[:NAME_CHARS]] += (b - a) * 1e-6
        return [[n, s] for n, s in sorted(by.items(), key=lambda x: -x[1])[:TOP]]

    def idle_gaps(self) -> List[list]:
        lo, hi = self.window
        gaps, t = [], lo
        for a, b in self.busy_intervals():
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if hi > t:
            gaps.append((t, hi))
        by: Dict[str, float] = defaultdict(float)
        mids = [(0.5 * (a + b), b - a) for a, b in gaps]
        labels = _innermost(self.spans, [m for m, _ in mids], "bench.window")
        ops = _innermost(self.host, [m for m, _ in mids], "host: no traced op")
        for (m, d), span, op in zip(mids, labels, ops):
            key = f"other (gaps under {SHORT_GAP_US:g} us)" if d < SHORT_GAP_US \
                else f"{span} / {op}"
            by[key] += d * 1e-6
        return [[n, s] for n, s in sorted(by.items(), key=lambda x: -x[1])[:TOP]]


def _innermost(events: list, times: List[float], default: str) -> List[str]:
    """For each time (ascending), the name of the innermost event that
    covers it, else `default`. `events` are of one thread, so they nest;
    sorted by start, the longer first on a tie. One sweep with a stack of
    the open events."""
    out, stack, i = [], [], 0
    for t in times:
        while i < len(events) and events[i][1] <= t:
            while stack and stack[-1][2] < events[i][1]:
                stack.pop()
            stack.append(events[i])
            i += 1
        while stack and stack[-1][2] < t:
            stack.pop()
        out.append(stack[-1][0] if stack else default)
    return out
