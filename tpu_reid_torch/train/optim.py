"""Optimizer plumbing: parameter partitions, torch Adam with a bias-lr
group, GPA averaging (the port of tpu_reid/train/optim.py).

A path predicate splits the nested parameter dict into (trainable, frozen)
trees of one structure, with None at the complementary positions; the
gradient is taken over the trainable leaves only.

The optimizer is `torch.optim.Adam`: its `weight_decay` is coupled L2 (the
decay added to the gradient before the moments), which is what the JAX
package builds from `optax.add_decayed_weights` placed before
`scale_by_adam`. Leaves whose path holds the key "b" or "bias" form a second
param group with lr x `bias_lr_mult` (the JAX chain's post-scale of those
leaves' updates: Adam's update is linear in lr). `set_lr` sets the epoch's
lr on both groups.

GPA (Gaussian-weighted prompt averaging, PromptSRC) keeps a running
gauss-weighted sum of the full parameter dict and swaps it in at the end.
"""

from __future__ import annotations

from typing import Callable, Iterator, Tuple

import numpy as np
import torch

Tensor = torch.Tensor
Path = Tuple[str, ...]


def paths(tree, prefix: Path = ()) -> Iterator[Tuple[Path, object]]:
    """(path, leaf) pairs of a nested dict, in insertion order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from paths(v, prefix + (k,))
    else:
        yield prefix, tree


def partition(params: dict, predicate: Callable[[Path], bool]):
    """Split into (trainable, frozen) trees of identical structure, with None
    at the complementary positions."""

    def split(tree, prefix, keep):
        if isinstance(tree, dict):
            return {k: split(v, prefix + (k,), keep) for k, v in tree.items()}
        return tree if predicate(prefix) == keep else None

    return split(params, (), True), split(params, (), False)


def combine(trainable, frozen):
    """Inverse of partition."""
    if trainable is None:
        return frozen
    if frozen is None:
        return trainable
    if isinstance(trainable, dict):
        return {k: combine(trainable[k], frozen[k]) for k in trainable}
    raise ValueError("overlapping leaves in partition")


def count_params(tree) -> int:
    return sum(int(np.prod(tuple(x.shape))) for _, x in paths(tree) if x is not None)


def is_bias(path: Path) -> bool:
    return any(p in ("b", "bias") for p in path)


def make_stage_optimizer(trainable: dict, base_lr: float, weight_decay: float = 1e-4,
                         bias_lr_mult: float = 1.0) -> torch.optim.Adam:
    """torch.optim.Adam over the trainable leaves (each must require grad):
    one group at base_lr and, with bias_lr_mult != 1, a second group of the
    bias leaves at base_lr * bias_lr_mult. Each group records its
    multiplier as "lr_mult" for `set_lr`."""
    leaves = [(p, t) for p, t in paths(trainable) if t is not None]
    groups = []
    if bias_lr_mult != 1.0:
        main = [t for p, t in leaves if not is_bias(p)]
        bias = [t for p, t in leaves if is_bias(p)]
        groups = [g for g in ({"params": main, "lr_mult": 1.0},
                              {"params": bias, "lr_mult": bias_lr_mult}) if g["params"]]
    else:
        groups = [{"params": [t for _, t in leaves], "lr_mult": 1.0}]
    for g in groups:
        g["lr"] = base_lr * g["lr_mult"]
    return torch.optim.Adam(groups, lr=base_lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for g in optimizer.param_groups:
        g["lr"] = lr * g["lr_mult"]


def gauss_weights(mu: float, sigma: float, max_epochs: int) -> np.ndarray:
    """Normalized gaussian over epochs 1..max_epochs."""
    xs = np.arange(1, max_epochs + 1, dtype=np.float64)
    g = np.exp(-0.5 * ((xs - mu) / sigma) ** 2) / (sigma * np.sqrt(2 * np.pi))
    return g / g.sum()


def _tree_map2(fn, a, b):
    if isinstance(a, dict):
        return {k: _tree_map2(fn, a[k], b[k]) for k in a}
    return fn(a, b)


def gpa_update(gpa_sum, params: dict, weight: float):
    """Running sum += weight * params. Non-float leaves (integer buffers like
    EOT indices) pass through with their latest value."""

    def scale(p, _):
        return p.detach() * weight if p.is_floating_point() else p

    scaled = _tree_map2(scale, params, params)
    if gpa_sum is None:
        return scaled
    return _tree_map2(lambda s, p: s + p if p.is_floating_point() else p, gpa_sum, scaled)
