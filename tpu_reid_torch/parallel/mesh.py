"""The "data" mesh of the port (the counterpart of tpu_reid/parallel/mesh.py).

JAX drives every device of a host from one process and lets XLA insert the
collectives from shardings. PyTorch's idiom is one process per device, so
here the "data" axis is a torch.distributed process group: rank r of a world
of n owns device r's share of every batch (`parallel/launch.py` starts the
ranks). The "model" axis (tensor parallelism) is not ported: a mesh always
has `shape == {"data": n, "model": 1}`.

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

ITEM_7B = ("tensor parallelism (a 'model' mesh axis, --tp > 1) is not ported yet "
           "(ROADMAP.md queue 1 item 7b)")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of the "data" axis: its rank, the world size, the
    process group and this rank's device."""

    rank: int
    size: int
    device: torch.device
    group: object = None

    @property
    def shape(self) -> dict:
        return {"data": self.size, "model": 1}

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


def make_mesh(n_data: Optional[int] = None, n_model: int = 1) -> Mesh:
    """The mesh of the initialised default process group. n_data, when
    given, must be the world size; n_model must be 1 (item 7b)."""
    if n_model != 1:
        raise NotImplementedError(ITEM_7B)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised torch.distributed default group "
                           "(tpu_reid_torch.parallel.launch starts one per rank)")
    world = dist.get_world_size()
    if n_data is not None and n_data != world:
        raise ValueError(f"n_data={n_data}, but the process group has {world} ranks")
    backend = dist.get_backend()
    if backend == "nccl":
        device = torch.device("cuda", torch.cuda.current_device())
    elif backend == "gloo":
        device = torch.device("cpu")
    else:
        raise ValueError(f"unsupported process-group backend {backend!r}")
    return Mesh(dist.get_rank(), world, device, dist.group.WORLD)


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
