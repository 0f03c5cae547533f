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

A step captured as a CUDA graph (train/step_graph.py) needs
`capturable=True`, which only CUDA Adam takes, and an lr that the graph
reads from memory: with capturable=True each group's lr is a 0-dim CUDA
tensor that `set_lr` writes in place (a float would be baked into the
graph at capture). The stage runners take capturable mode on CUDA on every
path, the host loops too, so that a graph path and its host loop do the
same arithmetic (capturable Adam computes its bias corrections on the card
in fp32, the other mode on the host in double). Adam's state is made when
the optimizer is, so it has fixed addresses from the start;
`state_tensors` / `restore_state` snapshot and roll back that state in
place, and `load_state` reads a saved state dict into either kind of
optimizer, whichever kind wrote it.

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


def _groups(trainable: dict, bias_lr_mult: float) -> list:
    """[(lr_mult, [(path, leaf)])]: one group, or with bias_lr_mult != 1 the
    non-bias leaves then the bias leaves (empty groups dropped)."""
    leaves = [(p, t) for p, t in paths(trainable) if t is not None]
    if bias_lr_mult == 1.0:
        return [(1.0, leaves)]
    groups = [(1.0, [(p, t) for p, t in leaves if not is_bias(p)]),
              (bias_lr_mult, [(p, t) for p, t in leaves if is_bias(p)])]
    return [g for g in groups if g[1]]


def leaf_order(trainable: dict, bias_lr_mult: float = 1.0) -> list:
    """The "/"-joined paths of the trainable leaves in the order
    make_stage_optimizer hands them to Adam, whose state dict keys the
    moments by that position: saved beside it by the checkpoints and
    checked on restore."""
    return ["/".join(p) for _, leaves in _groups(trainable, bias_lr_mult) for p, _ in leaves]


def make_stage_optimizer(trainable: dict, base_lr: float, weight_decay: float = 1e-4,
                         bias_lr_mult: float = 1.0, capturable: bool = False) -> torch.optim.Adam:
    """torch.optim.Adam over the trainable leaves (each must require grad):
    one group at base_lr and, with bias_lr_mult != 1, a second group of the
    bias leaves at base_lr * bias_lr_mult. Each group records its
    multiplier as "lr_mult" for `set_lr`. capturable=True (CUDA leaves
    only): Adam's capturable mode, each group's lr a 0-dim fp32 tensor on
    the leaves' device."""
    groups = [{"params": [t for _, t in leaves], "lr_mult": mult}
              for mult, leaves in _groups(trainable, bias_lr_mult)]
    for g in groups:
        lr = base_lr * g["lr_mult"]
        g["lr"] = (torch.tensor(lr, dtype=torch.float32, device=g["params"][0].device)
                   if capturable else lr)
    opt = torch.optim.Adam(groups, lr=base_lr, betas=(0.9, 0.999), eps=1e-8,
                           weight_decay=weight_decay, capturable=capturable)
    # torch warns once when a capturable Adam steps outside a capture: the
    # host loops and a graph's warm-up steps do so on purpose
    opt._warned_capturable_if_run_uncaptured = True
    _init_state(opt)
    return opt


def _init_state(optimizer: torch.optim.Adam) -> None:
    """Adam's state for every leaf, as its first step would make it (step 0,
    zero moments)."""
    for g in optimizer.param_groups:
        for p in g["params"]:
            st = optimizer.state[p]
            if not st:
                st["step"] = (torch.zeros((), dtype=torch.float32, device=p.device)
                              if g["capturable"] else torch.tensor(0.0, dtype=torch.float32))
                st["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                st["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """The epoch's lr on every group (x its lr_mult); a tensor lr is written
    in place."""
    for g in optimizer.param_groups:
        if isinstance(g["lr"], Tensor):
            g["lr"].fill_(lr * g["lr_mult"])
        else:
            g["lr"] = lr * g["lr_mult"]


def state_tensors(optimizer: torch.optim.Optimizer) -> dict:
    """The optimizer's live state, for a guard snapshot: {"state": each
    leaf's state dict (step, moments) in group order, "lr": each group's
    lr}. The tensors are the optimizer's own, not copies."""
    return {"state": [optimizer.state[p] for g in optimizer.param_groups for p in g["params"]],
            "lr": [g["lr"] for g in optimizer.param_groups]}


@torch.no_grad()
def restore_state(optimizer: torch.optim.Optimizer, saved: dict) -> None:
    """Write a `state_tensors` snapshot back into the optimizer in place
    (tensors that already are the live ones are skipped)."""
    live = state_tensors(optimizer)
    for st, sv in zip(live["state"], saved["state"]):
        for k, v in sv.items():
            if st[k] is not v:
                st[k].copy_(v)
    for g, lr in zip(optimizer.param_groups, saved["lr"]):
        if isinstance(g["lr"], Tensor):
            if g["lr"] is not lr:
                g["lr"].copy_(torch.as_tensor(lr))
        else:
            g["lr"] = float(lr)


def load_state(optimizer: torch.optim.Optimizer, state_dict: dict) -> None:
    """`optimizer.load_state_dict` that keeps this optimizer's own mode: its
    capturable and foreach options and its lr tensors (filled with the saved
    lr), whichever mode wrote `state_dict`; the step counters land where
    that mode keeps them."""
    live = optimizer.param_groups
    groups = [dict(s, lr=float(s["lr"]), capturable=g["capturable"], foreach=g["foreach"])
              for s, g in zip(state_dict["param_groups"], live)]
    lr_tensors = [g["lr"] if isinstance(g["lr"], Tensor) else None for g in live]
    optimizer.load_state_dict(dict(state_dict, param_groups=groups))
    for g, t in zip(optimizer.param_groups, lr_tensors):
        if t is not None:
            t.fill_(g["lr"])
            g["lr"] = t
        for p in g["params"]:
            st = optimizer.state[p]
            if "step" in st and not g["capturable"] and st["step"].device.type != "cpu":
                st["step"] = st["step"].cpu()


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
