"""Blockwise nearest-neighbour search with bounded memory (the port of
tpu_reid/retrieval/topk.py).

`blockwise_topk(qf, gf, k)` returns each query's k smallest-distance gallery
indices and distances without materialising the (Q, G) distance matrix: the
gallery streams through in blocks and a running top-k is merged per block,
O(Q*k) state for any gallery whose features fit the device.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tpu_reid_torch.retrieval.distance import full_fp32, l2_normalize

Tensor = torch.Tensor


@torch.no_grad()
def blockwise_topk(qf, gf, k: int, block: int = 8192,
                   squared: bool = True) -> Tuple[Tensor, Tensor]:
    """(distances (Q, k), indices (Q, k) int32) of each query's k nearest
    gallery rows under euclidean distance, ascending; ties go to the lower
    gallery id (JAX's lax.top_k order). The gallery is processed in
    `block`-row chunks with a running merge."""
    q = torch.as_tensor(qf).float()
    g = torch.as_tensor(gf).float().to(q.device)
    nq, ng = q.shape[0], g.shape[0]
    k = min(k, ng)
    block = min(block, ng)
    q_sq = (q * q).sum(dim=1, keepdim=True)
    best_d = torch.full((nq, k), float("inf"), device=q.device)
    best_i = torch.zeros((nq, k), dtype=torch.long, device=q.device)
    for s in range(0, ng, block):
        g_blk = g[s:s + block]
        with full_fp32():
            cross = q @ g_blk.T
        dist = q_sq + (g_blk * g_blk).sum(dim=1)[None, :] - 2.0 * cross
        cand_d = torch.cat([best_d, dist], dim=1)
        cand_i = torch.cat([best_i, torch.arange(s, s + g_blk.shape[0],
                                                 device=q.device).expand(nq, -1)], dim=1)
        # a stable sort keeps the earlier candidate (the lower id: the running
        # list holds only ids below this block's) first among equals
        sel = torch.sort(cand_d, dim=1, stable=True).indices[:, :k]
        best_d = torch.gather(cand_d, 1, sel)
        best_i = torch.gather(cand_i, 1, sel)
    if not squared:
        best_d = best_d.clamp_min(0.0).sqrt()
    return best_d, best_i.to(torch.int32)


def retrieve(query_features, gallery_features, k: int = 100, normalize: bool = True,
             block: int = 8192) -> Tuple[Tensor, Tensor]:
    """Retrieval: L2-normalised euclidean top-k (the order of cosine
    similarity)."""
    q, g = torch.as_tensor(query_features), torch.as_tensor(gallery_features)
    if normalize:
        q, g = l2_normalize(q, axis=1), l2_normalize(g, axis=1)
    return blockwise_topk(q, g, k, block=block, squared=True)
