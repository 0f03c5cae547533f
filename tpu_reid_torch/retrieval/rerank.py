"""k-reciprocal re-ranking (CVPR'17, Zhong et al.), dense and exact.

The algorithm is reformulated with fixed-size padded neighbour sets, as in
tpu_reid/retrieval/rerank.py:

  * membership tests on padded top-k index lists replace np.where lookups,
  * the union of the expansion sets becomes a scatter of 1.0 into a dense
    row mask (duplicates write the same value, so dedup is free),
  * every V row sums to 1 (before and after query expansion), so the
    Jaccard numerator sum_k min(V_i, V_j) needs no inverted index: it is
    one min-sum contraction (ops/minsum.py) of the query rows of V against
    its gallery rows — the hand-written kernel on the card.

Neighbour lists take the k smallest distances with ties to the lower column
id (`smallest_k`), the order of `lax.top_k` in the JAX package; the integer
lists decide everything downstream.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_reid_torch.ops.minsum import minsum
from tpu_reid_torch.retrieval.distance import euclidean_distmat

Tensor = torch.Tensor


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def smallest_k(d: Tensor, k: int) -> Tensor:
    """(B, k) column ids of the k smallest entries of each row of d, in
    ascending order with ties to the lower id (a stable sort; torch.topk
    promises no order for ties)."""
    return torch.sort(d, dim=1, stable=True).indices[:, :k]


def _expansion_sets(rows: Tensor, rank_k1: Tensor, rank_kh: Tensor, n: int):
    """Candidate k-reciprocal expansion sets for a block of rows.

    Forward top-(k1+1) neighbours, the reciprocal test, each candidate's
    half-k reciprocal set and the 2/3-overlap acceptance rule. Returns
    ``(e_idx, e_val)``: candidate column ids ``(B, k1p*(kh+1))`` and their
    acceptance mask. A column may appear several times; every duplicate of
    an accepted column carries the same weight exp(-od[row, col])."""
    safe_rows = rows.clamp_max(n - 1)
    fwd = rank_k1[safe_rows]  # (B, k1+1)
    # reciprocal test: i in top-(k1+1) of each forward neighbour
    back = rank_k1[fwd]  # (B, k1+1, k1+1)
    recip = (back == rows[:, None, None]).any(dim=-1)  # (B, k1+1)

    # half-k reciprocal sets of every candidate c = fwd[b, j]
    ch_idx = rank_kh[fwd]  # (B, k1+1, kh)
    ch_back = rank_kh[ch_idx]  # (B, k1+1, kh, kh)
    recip_h = (ch_back == fwd[:, :, None, None]).any(dim=-1)  # (B, k1+1, kh)

    # |R_half(c) ∩ R(i)| > 2/3 |R_half(c)|
    eq = (ch_idx[:, :, :, None] == fwd[:, None, None, :]) & recip[:, None, None, :]
    matched = eq.any(dim=-1) & recip_h  # (B, k1+1, kh)
    inter_size = matched.sum(dim=-1)
    rh_size = recip_h.sum(dim=-1)
    accept = recip & (3 * inter_size > 2 * rh_size)

    b = fwd.shape[0]
    e_idx = torch.cat([fwd, ch_idx.reshape(b, -1)], dim=1)
    e_val = torch.cat([recip, (accept[:, :, None] & recip_h).reshape(b, -1)], dim=1)
    return e_idx, e_val


@torch.no_grad()
def _rerank_core(qf: Tensor, gf: Tensor, lambda_value: float, *, k1: int, k2: int,
                 kh: int, row_block: int, normalize_rows: bool = True) -> Tensor:
    num_q = qf.shape[0]
    feat = torch.cat([qf, gf], dim=0)
    n = feat.shape[0]
    dev = feat.device

    # Original distance, row-normalized by the per-row max (the reference
    # divides columns by their max and transposes; sharded callers disable
    # the normalization so weights stay comparable across shards).
    dist = euclidean_distmat(feat, feat)
    od = (dist / dist.max(dim=0, keepdim=True).values).T.contiguous() if normalize_rows \
        else dist
    del dist

    # top-(k1+1) neighbour lists (self included at rank 0)
    rank_k1 = torch.cat([smallest_k(od[s: s + row_block], k1 + 1)
                         for s in range(0, n, row_block)])
    rank_kh = rank_k1[:, :kh]

    # V rows, columns padded to a multiple of 16 with zeros (exact for the
    # min-sum of non-negative rows; keeps the kernel's rows 16-byte aligned)
    n_cols = _round_up(n, 16)
    v = torch.zeros(n, n_cols, dtype=torch.float32, device=dev)
    for s in range(0, n, row_block):
        e = min(s + row_block, n)
        rows = torch.arange(s, e, device=dev)
        # union(R(i), accepted R_half(c)) as a dense row mask
        e_idx, e_val = _expansion_sets(rows, rank_k1, rank_kh, n)
        scat = torch.where(e_val, e_idx, n)  # invalid -> dummy column
        mask = torch.zeros(e - s, n + 1, dtype=torch.float32, device=dev)
        mask.scatter_(1, scat, 1.0)
        w = torch.exp(-od[s:e]) * mask[:, :n]
        v[s:e, :n] = w / w.sum(dim=1, keepdim=True).clamp_min(1e-12)

    # query expansion: mean of the V rows of the k2 nearest neighbours
    if k2 != 1:
        rank_k2 = rank_k1[:, :k2]
        v_qe = torch.empty_like(v)
        for s in range(0, n, row_block):
            v_qe[s: s + row_block] = v[rank_k2[s: s + row_block]].mean(dim=1)
        v = v_qe

    # Jaccard distance of the query rows against the gallery columns (the
    # only ones kept): t = sum_k min(V_i, V_j), jaccard = 1 - t / (2 - t)
    ones = torch.ones(n, dtype=torch.float32, device=dev)
    t = minsum(v[:num_q], ones[:num_q], v[num_q:], ones[num_q:])
    jaccard = 1.0 - t / (2.0 - t)
    return jaccard * (1.0 - lambda_value) + od[:num_q, num_q:] * lambda_value


def _as_features(x) -> Tensor:
    return torch.as_tensor(x).float()


def k_reciprocal_rerank_sharded(qf, gf, k1: int = 50, k2: int = 15, lambda_value: float = 0.3,
                                shard_size: int = 16384, row_block: int = 128) -> Tensor:
    """Bounded-memory re-ranking, one gallery shard after another on one
    device: each shard re-ranks against the full query set with the
    per-row max-normalization DISABLED, so the concatenated rows stay on one
    scale. Divergence from the exact algorithm: neighbourhoods are computed
    within (queries + shard), not the full gallery. Exact when the gallery
    fits one shard (minus the normalization, a monotone per-matrix
    rescale). Callers should pass L2-normalized features."""
    qf, gf = _as_features(qf), _as_features(gf)
    num_q, num_g = qf.shape[0], gf.shape[0]
    # bound the per-shard population, not the shard width: the core holds
    # ~3 dense (num_q + shard)^2 fp32 buffers
    shard_size = min(shard_size, max(2048, 20_000 - num_q))
    out = []
    for s in range(0, num_g, shard_size):
        g_shard = gf[s: s + shard_size]
        n = num_q + g_shard.shape[0]
        k1s = min(k1, n - 1)
        out.append(_rerank_core(
            qf, g_shard, lambda_value, k1=k1s, k2=min(k2, n),
            kh=min(int(np.around(k1s / 2)) + 1, n), row_block=min(row_block, n),
            normalize_rows=False,
        ))
    return torch.cat(out, dim=1)


def k_reciprocal_rerank(qf, gf, k1: int = 50, k2: int = 15, lambda_value: float = 0.3,
                        row_block: int = 128) -> Tensor:
    """Re-ranked (Q, G) distance matrix, on the features' device. Defaults
    follow the reference eval path (k1=50, k2=15, lambda=0.3)."""
    qf, gf = _as_features(qf), _as_features(gf)
    n = qf.shape[0] + gf.shape[0]
    # tiny-gallery clamp: neighbour lists cannot exceed the population
    k1 = min(k1, n - 1)
    k2 = min(k2, n)
    kh = min(int(np.around(k1 / 2)) + 1, n)
    return _rerank_core(qf, gf, lambda_value, k1=k1, k2=k2, kh=kh,
                        row_block=min(row_block, n))
