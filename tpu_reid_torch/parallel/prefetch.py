"""Input prefetch for the training loops (the port of
tpu_reid/parallel/prefetch.py).

`device_prefetch` pulls batches from a (lazy) source iterator on a worker
thread and applies `place` there, `depth` batches ahead of the consumer, so
the host decode, the host-to-device copy and the batch's preprocessing are
queued while the main thread is still queuing step N. Together with the
trainers' lag-1 loss read (train/trainer.LossPipeline) this takes the input
off the step's critical path.

On CUDA, `place` is a `StreamPlacer`: the worker thread runs the source
and the placement on a copy stream of its own, copies host arrays through
pinned memory (`non_blocking`), and records an event. The consumer's
current stream waits on that event when it receives the batch, and every
CUDA tensor of the batch gets `record_stream` for the consumer's stream, so
the caching allocator does not hand its memory to the copy stream again
while the step still reads it. On the CPU the placer converts host arrays
to tensors and nothing waits.
"""

from __future__ import annotations

import contextlib
import queue
import threading
from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch

_DONE = object()


def device_prefetch(
    batches: Iterable,
    place: Optional[Callable] = None,
    depth: int = 2,
) -> Iterator:
    """Yield `place(b)` for each batch, staged `depth` ahead on a thread
    (depth 0: synchronous, on the caller's thread).

    Exceptions raised by the source iterator or by `place` re-raise in the
    consumer. Abandoning the generator (break / exception) stops the
    worker. A `place` with a `stream` attribute (StreamPlacer) runs the
    source and itself on that stream, and its `ready(item)` runs in the
    consumer before the item is yielded."""
    ready = getattr(place, "ready", None)
    if depth <= 0:
        it = iter(batches)
        while True:
            with _on_stream(place):
                b = next(it, _DONE)
                if b is _DONE:
                    return
                item = place(b) if place is not None else b
            yield ready(item) if ready is not None else item

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def worker():
        try:
            with _on_stream(place):
                for b in batches:
                    item = place(b) if place is not None else b
                    while not stop.is_set():
                        try:
                            q.put(item, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
            q.put(_DONE)
        except BaseException as e:  # surface to the consumer
            if not stop.is_set():
                q.put(e)

    t = threading.Thread(target=worker, daemon=True, name="device_prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if item is _DONE:
                return
            if isinstance(item, BaseException):
                raise item
            yield ready(item) if ready is not None else item
    finally:
        stop.set()


def _on_stream(place):
    stream = getattr(place, "stream", None)
    return torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()


def _map(fn, tree):
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


class _Staged:
    """A placed batch and the event that marks its copies done."""

    __slots__ = ("value", "event")

    def __init__(self, value, event):
        self.value = value
        self.event = event


class StreamPlacer:
    """`place` for device_prefetch: numpy arrays and CPU tensors of a batch
    (a tuple, list or dict of them; other leaves pass as they are) go to
    `device`. On CUDA through pinned memory on the placer's copy stream,
    which the source's own device work runs on too (see the module
    docstring); `ready` makes the consumer's stream wait for them."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.stream = (torch.cuda.Stream(self.device) if self.device.type == "cuda"
                       else None)

    def _leaf(self, x):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        if isinstance(x, torch.Tensor) and x.device.type != self.device.type:
            x = x.pin_memory().to(self.device, non_blocking=True)  # host -> card
        return x

    def __call__(self, batch):
        out = _map(self._leaf, batch)
        if self.stream is None:
            return out
        event = torch.cuda.Event()
        event.record(self.stream)
        return _Staged(out, event)

    def ready(self, item):
        if not isinstance(item, _Staged):
            return item
        consumer = torch.cuda.current_stream(self.device)
        consumer.wait_event(item.event)

        def keep(x):
            if isinstance(x, torch.Tensor) and x.is_cuda:
                x.record_stream(consumer)
            return x

        return _map(keep, item.value)
