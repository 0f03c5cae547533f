"""The ("data", "model") mesh of the port (the counterpart of
tpu_reid/parallel/mesh.py).

JAX drives every device of a host from one process and lets XLA insert the
collectives from shardings. PyTorch's idiom is one process per device, so
here each mesh axis is a torch.distributed process group (`parallel/launch.py`
starts the ranks). A world of n_data * n_model ranks is laid out as JAX's
`devices.reshape(n_data, n_model)`: global rank g has data index
g // n_model and model index g % n_model. The "data" axis is the one every
caller knew before the "model" axis existed: `Mesh.rank`, `size` and
`group` are this rank's index in it, its size and the group of the ranks
that share this rank's model index. `model_rank`, `model_size` and
`model_group` are the tensor-parallel axis (parallel/tp.py): the ranks that
share a data index hold the same rows of every batch and split the tower's
heads and hidden units.

The layout is JAX's `P("data")`: rank r owns the contiguous rows
[r*B/n, (r+1)*B/n) of a global batch of B rows. A training step under a mesh
takes this rank's rows of the images (and SIE ids) and the GLOBAL labels and
valid mask; its encoders gather the features of every rank (`gather_rows`),
so the loss, the mining and the BNNeck statistics see the global batch, as
JAX's do. Every rank computes the same global loss, and `all_reduce_grads`
averages the gradients, so each rank applies the single-device update of the
global batch to its own copy of the parameters.

Only `all_gather`, `all_reduce` and `broadcast` are used: gloo (the CPU
backend the tests run) has them, so the CPU tests hold the code the card
runs. NCCL serves CUDA tensors, gloo CPU tensors; neither stands in for the
other.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of the mesh: its index in the "data" axis, that
    axis's size and process group, this rank's device, and the same three
    of the "model" axis."""

    rank: int
    size: int
    device: torch.device
    group: object = None
    model_rank: int = 0
    model_size: int = 1
    model_group: object = None

    @property
    def shape(self) -> dict:
        return {"data": self.size, "model": self.model_size}

    def row_range(self, rows: int) -> tuple:
        """[start, end) of this rank's share of `rows` rows (which must
        divide by the world size)."""
        if rows % self.size:
            raise ValueError(f"a batch of {rows} rows does not divide by the {self.size} "
                             f"ranks of the data axis")
        per = rows // self.size
        return self.rank * per, (self.rank + 1) * per


def require_mesh(mesh) -> Mesh:
    """`mesh`, if it is a port Mesh; anything else (a JAX Mesh) raises."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh= takes a tpu_reid_torch.parallel.mesh.Mesh (make_mesh), got "
                        f"{type(mesh).__name__}")
    return mesh


def backend_for(device: torch.device) -> str:
    """nccl for CUDA devices, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _axis_group(ranks: list, world: int):
    """A process group of `ranks` (every rank of the world must call this
    with the same lists in the same order: new_group is collective)."""
    return dist.group.WORLD if len(ranks) == world else dist.new_group(ranks)


def make_mesh(n_data: Optional[int] = None, n_model: int = 1) -> Mesh:
    """The (n_data, n_model) mesh of the initialised default process group,
    in JAX's order (global rank g at data index g // n_model, model index
    g % n_model). n_data defaults to the world size over n_model; n_data *
    n_model must be the world size. Every rank creates every group of both
    axes, in the same order."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised torch.distributed default group "
                           "(tpu_reid_torch.parallel.launch starts one per rank)")
    world = dist.get_world_size()
    if n_model < 1:
        raise ValueError(f"n_model must be at least 1, got {n_model}")
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"n_data={n_data} x n_model={n_model} = {n_data * n_model}, but the "
                         f"process group has {world} ranks")
    g = dist.get_rank()
    data_groups = [_axis_group([d * n_model + m for d in range(n_data)], world)
                   for m in range(n_model)]
    model_groups = ([_axis_group([d * n_model + m for m in range(n_model)], world)
                     for d in range(n_data)] if n_model > 1 else [None] * n_data)
    backend = dist.get_backend()
    if backend == "nccl":
        device = torch.device("cuda", torch.cuda.current_device())
    elif backend == "gloo":
        device = torch.device("cpu")
    else:
        raise ValueError(f"unsupported process-group backend {backend!r}")
    return Mesh(g // n_model, n_data, device, data_groups[g % n_model], g % n_model, n_model,
                model_groups[g // n_model])


def pad_to_multiple(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    if tree is None or np.isscalar(tree):
        return tree
    return fn(tree)


def shard_batch(mesh: Mesh, tree):
    """This rank's contiguous rows of every array / tensor leaf of a global
    batch (JAX's P("data") order); None and scalars pass through."""

    def one(x):
        s, e = mesh.row_range(x.shape[0])
        return x[s:e]

    return _map(one, tree)


def _leaves(tree) -> list:
    out = []
    _map(out.append, tree)
    return [t for t in out if isinstance(t, Tensor)]


def replicate(mesh: Mesh, tree):
    """Rank 0's values in every tensor leaf of `tree` on every rank
    (broadcast in place; the leaves must be on the mesh's device)."""
    with torch.no_grad():
        for t in _leaves(tree):
            dist.broadcast(t, 0, group=mesh.group)
    return tree


# dtypes that travel as their bytes (gloo has no bf16, fp8 or bool
# collectives; a gather only copies)
_AS_BYTES = (torch.bool, torch.bfloat16, torch.float16, torch.float8_e4m3fn)


def _wire(x: Tensor) -> Tensor:
    x = x.contiguous()
    return x.view(torch.uint8) if x.dtype in _AS_BYTES else x


def all_gather_rows(mesh: Mesh, x: Tensor) -> Tensor:
    """The rows of every rank's `x` (equal shapes), concatenated in rank
    order. No autograd (see `gather_rows`)."""
    w = _wire(x)
    parts = [torch.empty_like(w) for _ in range(mesh.size)]
    dist.all_gather(parts, w, group=mesh.group)
    return torch.cat(parts).view(x.dtype)


class _GatherRows(torch.autograd.Function):
    """all_gather whose backward sums the incoming gradient over the ranks
    and keeps this rank's rows. Every rank computes the same global loss, so
    each rank's slice comes back n times its single-device value; with the
    direct (non-gathered) paths of the loss also counted once per rank, the
    averaged all-reduce of `all_reduce_grads` gives the single-device
    gradient of the global batch."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        ctx.rows = x.shape[0]
        return all_gather_rows(mesh, x)

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        dist.all_reduce(g, group=ctx.mesh.group)
        r = ctx.mesh.rank * ctx.rows
        return g[r:r + ctx.rows], None


def gather_rows(mesh: Mesh, x: Tensor) -> Tensor:
    """all_gather_rows with the gradient rule of `_GatherRows` (a plain
    gather when `x` does not require grad)."""
    if not x.requires_grad:
        return all_gather_rows(mesh, x)
    return _GatherRows.apply(x, mesh)


def gathered(mesh: Mesh, fn):
    """fn(*args, local batch) -> features (a tensor, or a dict / tuple of
    them) of this rank's rows, as the gathered global-batch features."""

    def call(*args, **kw):
        return _map(lambda t: gather_rows(mesh, t), fn(*args, **kw))

    return call


def all_reduce_grads(mesh: Mesh, tensors) -> None:
    """Average the `.grad` of every tensor over the ranks, in place (one
    flat all-reduce per dtype)."""
    grads = [t.grad for t in tensors if t.grad is not None]
    by_dtype: dict = {}
    for g in grads:
        by_dtype.setdefault(g.dtype, []).append(g)
    for gs in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in gs])
        dist.all_reduce(flat, group=mesh.group)
        flat.div_(mesh.size)
        o = 0
        for g in gs:
            g.copy_(flat[o:o + g.numel()].view_as(g))
            o += g.numel()


def agree(mesh: Mesh, value: bool, what: str) -> bool:
    """`value`, after checking that every rank holds the same one (a rank
    that decides alone, a guard's rollback above all, would diverge from the
    others without a sign)."""
    t = torch.tensor([int(bool(value))], dtype=torch.int32, device=mesh.device)
    got = all_gather_rows(mesh, t).tolist()
    if len(set(got)) != 1:
        raise RuntimeError(f"the ranks disagree on {what}: {got}")
    return bool(value)


def check_replicated(mesh: Mesh, tree, what: str) -> None:
    """Raise unless every rank holds the same values in `tree` (a float64
    sum and sum of squares per leaf, gathered once)."""
    leaves = _leaves(tree)
    if not leaves:
        return
    with torch.no_grad():
        sums = torch.stack([torch.stack([t.double().sum(), t.double().square().sum()])
                            .to(mesh.device) for t in leaves])
        every = all_gather_rows(mesh, sums[None]).cpu()
    bad = [i for i in range(len(leaves)) if not torch.equal(every[:, i], every[:1, i].expand_as(
        every[:, i]))]
    if bad:
        raise RuntimeError(f"{what}: the ranks hold different values in {len(bad)} of "
                           f"{len(leaves)} leaves (first: leaf {bad[0]})")
