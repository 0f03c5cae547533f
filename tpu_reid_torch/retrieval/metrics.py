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

import warnings

import numpy as np
import torch

from tpu_reid_torch.retrieval.distance import euclidean_distmat, l2_normalize
from tpu_reid_torch.retrieval.rerank import k_reciprocal_rerank, k_reciprocal_rerank_sharded
from tpu_reid_torch.retrieval.rerank_stream import check_mesh, k_reciprocal_rerank_streamed_rows
from tpu_reid_torch.runtime.observe import synced_phase

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
    features on their device and runs the whole tail there (normalize ->
    distmat -> CMC/mAP, optionally k-reciprocal re-ranking).

    rerank_mode: "exact" (dense, `rerank.k_reciprocal_rerank`), "streamed"
    (exact neighbourhoods with sparse V and quantized V_qe,
    `rerank_stream.k_reciprocal_rerank_streamed_rows`, blended and scored
    per query chunk), "sharded" (shard-local neighbourhoods, an
    approximation) or "auto" (exact up to `rerank_exact_limit` = Q+G, then
    streamed). `mesh` (a parallel/mesh.Mesh): the streamed route shards its
    passes and the gallery side of V_qe over the ranks
    (`rerank_stream._streamed_core_sharded`); every rank holds all the
    features and computes the same metrics. `log`: an optional MetricLogger
    that gets the streamed route's passes as device-synchronised phases."""

    def __init__(self, num_query: int, max_rank: int = 50, feat_norm: bool = True,
                 reranking: bool = False, rerank_params: tuple = (50, 15, 0.3),
                 rerank_mode: str = "auto", mesh=None, with_minp: bool = False, log=None):
        if rerank_mode not in ("auto", "exact", "streamed", "sharded"):
            raise ValueError(f"rerank_mode must be auto, exact, streamed or sharded: "
                             f"{rerank_mode!r}")
        check_mesh(mesh)
        self.num_query = num_query
        self.max_rank = max_rank
        self.feat_norm = feat_norm
        self.reranking = reranking
        self.rerank_params = rerank_params
        self.rerank_mode = rerank_mode
        # the exact route holds about four dense (Q+G)^2 fp32 matrices
        # (25.6 GB at 40,000); above this population "auto" streams
        self.rerank_exact_limit = 40_000
        self.with_minp = with_minp
        self.mesh = mesh
        self.log = log
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
        nq = self.num_query
        qf, gf = feats[:nq], feats[nq:]
        ids = (pids[:nq], pids[nq:], camids[:nq], camids[nq:])
        kw = dict(max_rank=self.max_rank, with_minp=self.with_minp)

        if not self.reranking:
            return cmc_map(euclidean_distmat(qf, gf), *ids, **kw)
        k1, k2, lam = self.rerank_params
        mode = self.rerank_mode
        if mode == "auto":
            n = int(qf.shape[0]) + int(gf.shape[0])
            mode = "exact" if n <= self.rerank_exact_limit else "streamed"
        if mode == "exact":
            distmat = k_reciprocal_rerank(qf, gf, k1=k1, k2=k2, lambda_value=lam)
        elif mode == "streamed":
            row_fn, q_chunk = k_reciprocal_rerank_streamed_rows(
                qf, gf, k1=k1, k2=k2, lambda_value=lam, mesh=self.mesh, log=self.log)
            with synced_phase(self.log, "rerank.blend_metric", qf.device):
                return cmc_map_from_rows(row_fn, q_chunk, *ids, **kw)
        else:
            warnings.warn(
                "rerank_mode='sharded' uses shard-LOCAL k-reciprocal neighbourhoods, "
                "which lowers mAP against the exact protocol (the JAX package records the "
                "cost in docs/DIVERGENCES.md #15). The streamed mode runs the EXACT "
                "protocol at any population whose sparse V fits the device; use "
                "rerank_mode='streamed' (or 'auto') unless it cannot fit.",
                stacklevel=2,
            )
            distmat = k_reciprocal_rerank_sharded(qf, gf, k1=k1, k2=k2, lambda_value=lam)
        return cmc_map(distmat, *ids, **kw)
