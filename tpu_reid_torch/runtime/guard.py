"""Divergence rollback for long training runs (the TrainGuard of
tpu_reid/runtime/guard.py).

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
"""

from __future__ import annotations

import math
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
