"""Learning-rate schedules — plain epoch -> lr functions (a copy of
tpu_reid/train/schedules.py).

  * cosine_warmup_lr — timm-style epoch-stepped cosine with linear warmup
    (stage-1 config lr_min=1e-6, warmup_lr_init=1e-5, warmup_t=5,
    cycle_limit=1). Warmup does NOT prefix the cosine: epoch t past warmup
    evaluates cos(pi * t / t_total) on the full horizon.
  * warmup_multistep_lr — linear warmup from warmup_factor, then x gamma at
    each milestone (stage-2 config milestones=(30, 50), gamma=0.1,
    warmup_factor=0.1, warmup_iters=10).

The trainers set the value on the optimizer once per epoch
(train/optim.set_lr).
"""

from __future__ import annotations

import math
from bisect import bisect_right
from typing import Sequence


def cosine_warmup_lr(
    epoch: int,
    base_lr: float,
    total_epochs: int,
    lr_min: float = 1e-6,
    warmup_lr_init: float = 1e-5,
    warmup_t: int = 5,
    cycle_limit: int = 1,
) -> float:
    if warmup_t and epoch < warmup_t:
        step = (base_lr - warmup_lr_init) / warmup_t
        return warmup_lr_init + epoch * step
    i = epoch // total_epochs
    if cycle_limit and i >= cycle_limit:
        return lr_min
    t_curr = epoch - total_epochs * i
    return lr_min + 0.5 * (base_lr - lr_min) * (
        1 + math.cos(math.pi * t_curr / total_epochs)
    )


def warmup_multistep_lr(
    epoch: int,
    base_lr: float,
    milestones: Sequence[int] = (30, 50),
    gamma: float = 0.1,
    warmup_factor: float = 0.1,
    warmup_iters: int = 10,
) -> float:
    factor = 1.0
    if epoch < warmup_iters:
        alpha = epoch / warmup_iters
        factor = warmup_factor * (1 - alpha) + alpha
    return base_lr * factor * gamma ** bisect_right(list(milestones), epoch)
