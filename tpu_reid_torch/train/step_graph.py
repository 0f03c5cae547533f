"""A training step captured once as a CUDA graph and replayed: the port's
counterpart of the JAX package's `jax.jit(lax.scan(step))` chunk programs
(train/trainer.run_stage2_cached, run_stage1_live_cached and the cached
coop/adapter stage 1).

A step of the port makes ~3200-4100 kernel launches (the forward through
the hand-written kernels, the recompute-backward of every block, Adam), and
on the card the device waits on the host that launches them. A graph
replays all of them from one host call.

    step = StepGraph(body, state, device)
    loss = step()    # on the card the first call captures, every call replays

`body()` runs one step from static buffers that the caller fills in place
before each call (the index row, labels, valid mask, augmentation draws),
and returns the 0-dim loss. It must update all state in place (the trained
leaves and Adam's state through a capturable optimizer, BN statistics with
`copy_`), and make no host synchronisation and no host-to-device copy.
`state()` lists every tensor the step updates.

The first call on the card:
  * saves `state()`, runs `warmup` eager steps on a side stream (as
    PyTorch's whole-network capture requires: lazy initialisation, library
    handles and kernel attributes happen outside the capture), and writes
    the saved state back in place, so the first batch is not trained more
    than once;
  * captures one step with `torch.cuda.graph` (capture runs nothing), then
    replays it for the first batch.
A failed capture raises with its reason: nothing falls back to eager steps
on the card. Each call returns a copy of the loss, since the next replay
overwrites the graph's output while the loss pipeline still holds it.

On the CPU (the tests) every call runs `body()` eagerly: the same buffers,
the same in-place updates.

`release()` drops the graph, its private memory pool and the gradients
that live there; the runners call it when they return. `CAPTURE_HOOKS`
(callables taking "before" or "after") run around each capture: a harness
counts the kernel launches of one captured step with them, as the Python
launch counters do not see replays. `history` keeps (replays, capture
seconds, warm-up seconds) of every released graph.
"""

from __future__ import annotations

import time
from typing import Callable, List

import torch

Tensor = torch.Tensor

CAPTURE_HOOKS: List[Callable[[str], None]] = []
history: List[dict] = []


class StepGraph:
    def __init__(self, body: Callable[[], Tensor], state: Callable[[], List[Tensor]],
                 device: torch.device, warmup: int = 2, name: str = "step"):
        self.body = body
        self.state = state
        self.device = torch.device(device)
        self.warmup = warmup
        self.name = name
        self.replays = 0
        self.capture_s = 0.0
        self.warmup_s = 0.0
        self._graph = None
        self._loss = None

    def __call__(self) -> Tensor:
        if self.device.type != "cuda":
            return self.body()
        if self._graph is None:
            self._capture()
        self._graph.replay()
        self.replays += 1
        return self._loss.clone()

    def _capture(self) -> None:
        live = [t for t in self.state()]
        with torch.no_grad():
            saved = [t.detach().clone() for t in live]
        t0 = time.perf_counter()
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for _ in range(self.warmup):
                self.body()
        torch.cuda.current_stream(self.device).wait_stream(side)
        with torch.no_grad():
            for t, v in zip(live, saved):
                t.copy_(v)
        torch.cuda.synchronize(self.device)
        self.warmup_s = time.perf_counter() - t0
        del saved
        graph = torch.cuda.CUDAGraph()
        for hook in CAPTURE_HOOKS:
            hook("before")
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(graph):
                loss = self.body()
        except Exception as e:
            raise RuntimeError(f"capturing the {self.name} as a CUDA graph failed: "
                               f"{type(e).__name__}: {e}") from e
        self.capture_s = time.perf_counter() - t0
        for hook in CAPTURE_HOOKS:
            hook("after")
        if [t.data_ptr() for t in self.state()] != [t.data_ptr() for t in live]:
            raise RuntimeError(f"the {self.name} replaced a state tensor while captured; a "
                               f"graph step must update its state in place")
        self._graph, self._loss = graph, loss

    def release(self, leaves=()) -> None:
        """Drop the graph and its memory pool; `leaves`: the trained tensors,
        whose gradients live in that pool."""
        if self._graph is None:
            return
        for t in leaves:
            t.grad = None
        history.append({"name": self.name, "replays": self.replays,
                        "capture_s": self.capture_s, "warmup_s": self.warmup_s})
        self._graph.reset()
        self._graph = self._loss = None
        torch.cuda.empty_cache()
