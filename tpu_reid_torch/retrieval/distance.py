"""Pairwise distance matrices, computed on the features' device.

The squared-distance expansion |q|^2 + |g|^2 - 2 q.g puts the O(QGD) work
in one fp32 matrix product (TF32 stays off: ranking parity needs true fp32
accumulation).
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


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
    return q_sq + g_sq - 2.0 * (q @ g.T)


def cosine_distmat(q: Tensor, g: Tensor, eps: float = 1e-5) -> Tensor:
    """arccos of the normalized dot product."""
    sim = l2_normalize(q.float()) @ l2_normalize(g.float()).T
    return torch.arccos(sim.clamp(-1.0 + eps, 1.0 - eps))
