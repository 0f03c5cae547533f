"""CMC / mAP / mINP evaluation (Market-1501 protocol), vectorized.

Protocol:
  * rank gallery by distance per query (stable sort),
  * drop gallery entries sharing BOTH pid and camid with the query,
  * a query with no remaining positive is excluded from CMC, mAP and mINP,
  * CMC[r] = fraction of valid queries whose first positive appears within
    the top-(r+1) *kept* entries,
  * AP = mean over positives of (precision at that positive's kept-rank),
  * INP = num_positives / kept-rank of the hardest (last) positive.

The whole protocol is masked cumulative sums over a (Q, G) rank matrix,
chunked over queries, on the distance matrix's device.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_reid_torch.retrieval.distance import euclidean_distmat, l2_normalize

Tensor = torch.Tensor


def _cmc_map_stats(distmat: Tensor, q_pids: Tensor, g_pids: Tensor,
                   q_camids: Tensor, g_camids: Tensor, max_rank: int):
    """Per-chunk sufficient statistics: (sum of AP over valid queries,
    valid-query count, per-rank CMC hit counts, sum of INP over valid
    queries)."""
    order = torch.argsort(distmat, dim=1, stable=True)  # (Qc, G)
    g_pid_sorted = g_pids[order]
    g_cam_sorted = g_camids[order]

    matches = g_pid_sorted == q_pids[:, None]
    keep = ~(matches & (g_cam_sorted == q_camids[:, None]))

    # 1-indexed position among kept entries; rank among kept positives
    kept_pos = torch.cumsum(keep.int(), dim=1)
    good = matches & keep
    match_rank = torch.cumsum(good.int(), dim=1)

    num_rel = good.sum(dim=1)
    valid = num_rel > 0

    precision = torch.where(good, match_rank.float() / kept_pos.float(),
                            torch.zeros((), device=distmat.device))
    ap = precision.sum(dim=1) / num_rel.clamp_min(1).float()
    ap_sum = torch.where(valid, ap, torch.zeros_like(ap)).sum()
    valid_count = valid.float().sum()

    big = torch.iinfo(torch.int32).max
    first_pos = torch.where(good, kept_pos, torch.full_like(kept_pos, big)).amin(dim=1)
    ranks = torch.arange(1, max_rank + 1, device=distmat.device)
    hits = (first_pos[:, None] <= ranks[None, :]) & valid[:, None]
    hit_counts = hits.float().sum(dim=0)

    hardest_pos = torch.where(good, kept_pos, torch.zeros_like(kept_pos)).amax(dim=1)
    inp = num_rel.float() / hardest_pos.clamp_min(1).float()
    inp_sum = torch.where(valid, inp, torch.zeros_like(inp)).sum()
    return ap_sum, valid_count, hit_counts, inp_sum


def _as_ids(x, device) -> Tensor:
    return torch.as_tensor(np.asarray(x), device=device).long()


def cmc_map_from_rows(row_fn, q_chunk: int, q_pids, g_pids, q_camids, g_camids,
                      max_rank: int = 50, with_minp: bool = False):
    """(cmc[max_rank], mAP) from lazily produced distance rows — (cmc, mAP,
    mINP) when with_minp.

    ``row_fn(start)`` returns the fp32 ``(q_chunk, num_g)`` distance block
    for queries [start, start+q_chunk); start walks multiples of q_chunk.
    Each block is reduced to per-chunk statistics at once, so the full
    (Q, G) matrix need never exist. Rows past num_q in the tail block may
    hold any value: they are excluded by a pid of -1."""
    num_q = len(q_pids)
    num_g = len(g_pids)
    max_rank = min(max_rank, num_g)
    ap_sum = valid_count = inp_sum = 0.0
    hit_counts = None
    for s in range(0, num_q, q_chunk):
        e = min(s + q_chunk, num_q)
        dm = row_fn(s)
        dev = dm.device
        qp = _as_ids(q_pids[s:e], dev)
        qc = _as_ids(q_camids[s:e], dev)
        if e - s < q_chunk:
            # padded rows use pid -1: they match nothing -> invalid -> excluded
            pad = q_chunk - (e - s)
            qp = torch.cat([qp, torch.full((pad,), -1, dtype=qp.dtype, device=dev)])
            qc = torch.cat([qc, torch.zeros((pad,), dtype=qc.dtype, device=dev)])
        a, v, h, i = _cmc_map_stats(dm, qp, _as_ids(g_pids, dev), qc,
                                    _as_ids(g_camids, dev), max_rank)
        ap_sum = ap_sum + a
        valid_count = valid_count + v
        inp_sum = inp_sum + i
        hit_counts = h if hit_counts is None else hit_counts + h

    denom = torch.clamp_min(torch.as_tensor(valid_count), 1.0)
    cmc = (hit_counts / denom).cpu().numpy()
    out = (cmc, float(ap_sum / denom))
    if with_minp:
        out = out + (float(inp_sum / denom),)
    return out


def cmc_map(distmat: Tensor, q_pids, g_pids, q_camids, g_camids, max_rank: int = 50,
            q_chunk: int = 2048, with_minp: bool = False):
    """(cmc[max_rank], mAP) — (cmc, mAP, mINP) when with_minp — chunked over
    queries so the (Q, G) sort never exists in one buffer."""
    distmat = torch.as_tensor(distmat)
    num_q, num_g = distmat.shape
    step = min(q_chunk, num_q)

    def rows(s):
        e = min(s + step, num_q)
        blk = distmat[s:e]
        if e - s < step:  # pad the tail chunk to the chunk shape
            blk = torch.cat([blk, blk.new_zeros((step - (e - s), num_g))])
        return blk

    return cmc_map_from_rows(rows, step, q_pids, g_pids, q_camids, g_camids,
                             max_rank=max_rank, with_minp=with_minp)


class Evaluator:
    """Feature accumulator + metric computation: keeps the accumulated
    features on their device and runs normalize -> distmat -> CMC/mAP there.
    Re-ranking comes with a later slice."""

    def __init__(self, num_query: int, max_rank: int = 50, feat_norm: bool = True,
                 reranking: bool = False, with_minp: bool = False):
        if reranking:
            raise NotImplementedError(
                "k-reciprocal re-ranking is not ported yet (slice 3 of the port)"
            )
        self.num_query = num_query
        self.max_rank = max_rank
        self.feat_norm = feat_norm
        self.with_minp = with_minp
        self.reset()

    def reset(self) -> None:
        self._feats: list[Tensor] = []
        self._pids: list[np.ndarray] = []
        self._camids: list[np.ndarray] = []

    def update(self, feat: Tensor, pid, camid) -> None:
        self._feats.append(torch.as_tensor(feat))
        self._pids.append(np.asarray(pid))
        self._camids.append(np.asarray(camid))

    def compute(self):
        """(cmc, mAP), or (cmc, mAP, mINP) when with_minp."""
        feats = torch.cat(self._feats, dim=0)
        self._feats = [feats]
        if self.feat_norm:
            feats = l2_normalize(feats, axis=1)
        pids = np.concatenate(self._pids)
        camids = np.concatenate(self._camids)
        qf, gf = feats[: self.num_query], feats[self.num_query:]
        distmat = euclidean_distmat(qf, gf)
        return cmc_map(
            distmat, pids[: self.num_query], pids[self.num_query:],
            camids[: self.num_query], camids[self.num_query:],
            max_rank=self.max_rank, with_minp=self.with_minp,
        )
