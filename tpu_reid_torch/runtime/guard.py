"""Failure detection for long runs (the port of tpu_reid/runtime/guard.py):
divergence rollback (TrainGuard) and hang detection (StepWatchdog).

TrainGuard keeps a periodic host snapshot of the training state and, when a
step produces a non-finite loss, hands back the last good snapshot so the
trainer can restore it and skip the batch. Bounded by max_restores, so a
persistently diverging run fails loudly instead of looping. The snapshot
holds the optimizer state as well as the parameters, so a restore resumes
the optimization trajectory, not just the weights.

State is any tuple of nested dicts / lists / tuples of tensors (for example
(trainable leaves, BN statistics, optimizer.state_dict())); snapshots are
CPU copies, and a restore returns them on the devices of the live state they
replace. Host-side logic only: the trainer already reads each loss.

StepWatchdog fires a callback once when a guarded wait outlasts its
budget: a wedged device presents as a host thread blocked in a
synchronise, and the watchdog turns that silence into a recorded event.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Any, Callable, Optional

import torch


def _map(fn, tree, like=None):
    """fn(leaf, like_leaf) over nested dicts/lists/tuples; non-tensor leaves
    are kept as they are."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, None if like is None else like[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, None if like is None else like[i])
                          for i, v in enumerate(tree))
    if isinstance(tree, torch.Tensor):
        return fn(tree, like)
    return tree


def _to_host(tree):
    return _map(lambda t, _: t.detach().to("cpu", copy=True), tree)


def _to_device(tree, like):
    return _map(lambda t, ref: t.to(ref.device) if isinstance(ref, torch.Tensor) else t,
                tree, like)


class GuardTripped(RuntimeError):
    """Raised when failures exceed the guard's restore budget."""


class TrainGuard:
    """Divergence rollback guard.

        guard.maybe_snapshot(step_idx, *state)
        state, ok = guard.check(loss, *state)
        if not ok:
            ...restore `state` into the live tensors and skip the batch

    `check` treats NaN/inf losses as failures; everything else marks the
    current state good. The cost of a clean run is one host copy every
    `snapshot_every` steps."""

    def __init__(self, snapshot_every: int = 50, max_restores: int = 3,
                 log: Callable[[str], None] = print):
        self.snapshot_every = max(1, snapshot_every)
        self.max_restores = max_restores
        self.log = log
        self.restores = 0
        self.events: list[dict] = []
        self._snap: Optional[tuple] = None
        self._step = 0

    def will_snapshot(self, step: int) -> bool:
        """True when maybe_snapshot(step, ...) would capture state — lets a
        pipelined loop resolve its in-flight loss first."""
        return self._snap is None or step % self.snapshot_every == 0

    def maybe_snapshot(self, step: int, *state: Any):
        self._step = step
        if self.will_snapshot(step):
            self._snap = (step, tuple(_to_host(s) for s in state))

    def check(self, loss: float, *state: Any):
        """Returns (state_tuple, ok)."""
        if math.isfinite(float(loss)):
            return state, True
        self.restores += 1
        event = {
            "step": self._step,
            "loss": float(loss),
            "restored_to": self._snap[0] if self._snap else None,
            "restores": self.restores,
        }
        self.events.append(event)
        self.log(
            f"[guard] non-finite loss at step {self._step} "
            f"(restore {self.restores}/{self.max_restores}, "
            f"rolling back to step {event['restored_to']})"
        )
        if self.restores > self.max_restores:
            raise GuardTripped(
                f"{self.restores} non-finite losses exceed the budget "
                f"of {self.max_restores}; last events: {self.events[-3:]}"
            )
        if self._snap is None:
            raise RuntimeError("check() before any maybe_snapshot()")
        _, host_state = self._snap
        return tuple(_to_device(s, live) for s, live in zip(host_state, state)), False


class StepWatchdog:
    """Wall-clock hang detector for device work.

        with StepWatchdog(timeout_s=300, on_hang=cb) as wd:
            event.synchronize()     # if this blocks > timeout, cb fires once

    The callback runs on a daemon monitor thread with the elapsed seconds;
    it cannot unblock the wait, but it records the hang (and can write a
    marker file, emit metrics, or end the process if the caller chooses).
    On CUDA, guard a wait for the device (an event's synchronize), not a
    launch: launches return before the device has run them.

    One watchdog may guard many waits in turn (`with wd:` around each): it
    fires at most once per wait. Arming and disarming only set a deadline
    under a lock; the monitor thread starts at the first arming and ends
    when it wakes at a deadline to find the watchdog disarmed, so a sweep
    of short waits starts no thread per wait."""

    def __init__(self, timeout_s: float, on_hang: Optional[Callable[[float], None]] = None,
                 log: Callable[[str], None] = print):
        self.timeout_s = timeout_s
        self.on_hang = on_hang
        self.log = log
        self.hung = False
        self._cond = threading.Condition()
        self._deadline: Optional[float] = None  # None: disarmed, or fired
        self._t0 = 0.0
        self._thread: Optional[threading.Thread] = None

    def _watch(self):
        while True:
            with self._cond:
                if self._deadline is None:
                    self._thread = None
                    return
                remaining = self._deadline - time.monotonic()
                if remaining > 0:
                    self._cond.wait(remaining)
                    continue
                self._deadline = None
                elapsed = time.monotonic() - self._t0
            self._fire(elapsed)

    def _fire(self, elapsed: float):
        self.hung = True
        self.log(f"[watchdog] step exceeded {self.timeout_s:.0f}s (elapsed {elapsed:.0f}s) — "
                 f"device hang suspected")
        if self.on_hang is not None:
            self.on_hang(elapsed)

    def __enter__(self):
        with self._cond:
            self._t0 = time.monotonic()
            self._deadline = self._t0 + self.timeout_s
            if self._thread is None:
                self._thread = threading.Thread(target=self._watch, daemon=True,
                                                name="step-watchdog")
                self._thread.start()
        return self

    def __exit__(self, *exc):
        with self._cond:
            self._deadline = None
        return False
