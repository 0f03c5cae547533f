"""Pairwise distance matrices, computed on the features' device.

The squared-distance expansion |q|^2 + |g|^2 - 2 q.g puts the O(QGD) work
in one fp32 matrix product. TF32 stays off whatever the caller's flags
(`full_fp32`): ranking parity, and re-ranking's neighbour lists, need true
fp32 accumulation.
"""

from __future__ import annotations

import contextlib

import torch

Tensor = torch.Tensor


@contextlib.contextmanager
def full_fp32():
    """fp32 matrix products in full fp32 (no TF32 on the card) inside the
    block, whatever the caller set; the caller's setting is restored."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def l2_normalize(x: Tensor, axis: int = -1, eps: float = 1e-12) -> Tensor:
    """Row-normalize features (torch F.normalize semantics)."""
    norm = x.square().sum(dim=axis, keepdim=True).sqrt()
    return x / norm.clamp_min(eps)


def euclidean_distmat(q: Tensor, g: Tensor) -> Tensor:
    """Squared euclidean distance matrix (Q, G) — no sqrt: ranking is
    monotonic in the squared distance."""
    q = q.float()
    g = g.float()
    q_sq = q.square().sum(dim=1, keepdim=True)  # (Q, 1)
    g_sq = g.square().sum(dim=1, keepdim=True).T  # (1, G)
    with full_fp32():
        cross = q @ g.T
    return q_sq + g_sq - 2.0 * cross


def cosine_distmat(q: Tensor, g: Tensor, eps: float = 1e-5) -> Tensor:
    """arccos of the normalized dot product."""
    with full_fp32():
        sim = l2_normalize(q.float()) @ l2_normalize(g.float()).T
    return torch.arccos(sim.clamp(-1.0 + eps, 1.0 - eps))
