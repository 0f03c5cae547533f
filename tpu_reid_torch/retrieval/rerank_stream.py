"""Exact-neighbourhood k-reciprocal re-ranking for large populations.

The dense path (`rerank.k_reciprocal_rerank`) holds (Q+G)^2 fp32 matrices:
~35 GB each at MSMT17 scale (n = 93,820). This module computes the same
algorithm with GLOBAL neighbourhoods without ever materialising a dense
fp32 n x n matrix, as tpu_reid/retrieval/rerank_stream.py does:

  A. global top-(k1+1) neighbour lists + per-row distance max, blockwise
     (two streamed distance passes in all),
  B. sparse V: every V row has at most E = (k1+1)*(kh+1) nonzeros, so V is
     stored as per-row (index, value) pairs — sort + first-occurrence dedup
     replaces the dense scatter of the exact path,
  C. query-expanded rows V_qe are densified by scatter-add of k2 sparse rows
     and stored row-quantized (fp8 values + one fp32 scale per row),
  D. the Jaccard min-sum contraction (`ops.minsum`: the hand-written CUDA
     kernel on the card), then a blend that tracks the TRUE
     post-quantization row sums sA/sB (jaccard = 1 - t/(sA+sB-t)).

Neighbourhoods, expansion sets and acceptance tests are exact (integer
decisions from global rank lists); the only error is value quantization
(bf16 sparse V, fp8 V_qe). Distance rows are true fp32 whatever the caller's
TF32 flags (`distance.full_fp32`): a TF32 product changes the neighbour
lists.

Over a "data" mesh (parallel/mesh.py) `_streamed_core_sharded` splits every
pass's rows across the ranks and keeps the gallery side of V_qe and the
min-sum output t sharded by gallery columns, as the JAX package's does.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from tpu_reid_torch.ops.minsum import minsum
from tpu_reid_torch.parallel.mesh import Mesh, all_gather_rows
from tpu_reid_torch.retrieval.distance import full_fp32
from tpu_reid_torch.retrieval.rerank import _as_features, _expansion_sets, _round_up, smallest_k
from tpu_reid_torch.runtime.observe import synced_phase

Tensor = torch.Tensor


def _dist_rows(feat: Tensor, sq: Tensor, rows: Tensor) -> Tensor:
    """(len(rows), n) squared-euclidean rows of feat[rows] against all of
    feat, fp32-accumulated (parity with distance.euclidean_distmat)."""
    with full_fp32():
        cross = feat[rows] @ feat.T
    return sq[rows][:, None] + sq[None, :] - 2.0 * cross


def _row_ids(s: int, e: int, start: int, n: int, dev) -> Tensor:
    """Population rows start + [s, e), rows past the end clamped to the last
    real row (a rank's padding: duplicates that the caller drops)."""
    return (start + torch.arange(s, e, device=dev)).clamp_max(n - 1)


def _global_ranks(feat: Tensor, k1p: int, row_block: int, start: int = 0,
                  n_out: int = None):
    """Pass A for rows [start, start + n_out) (all n by default): per-row
    distance max (n_out,) + top-(k1+1) lists (n_out, k1+1). The reference's
    column-max normalisation equals dividing each row by its own max for the
    symmetric all-pairs matrix, which is rank-preserving, so the ranks come
    from raw distances and the max is carried for the weights."""
    n = feat.shape[0]
    n_out = n if n_out is None else n_out
    sq = (feat * feat).sum(dim=1)
    rowmax = torch.empty(n_out, dtype=torch.float32, device=feat.device)
    rank = torch.empty(n_out, k1p, dtype=torch.int64, device=feat.device)
    for s in range(0, n_out, row_block):
        e = min(s + row_block, n_out)
        d = _dist_rows(feat, sq, _row_ids(s, e, start, n, feat.device))
        rowmax[s:e] = d.max(dim=1).values
        rank[s:e] = smallest_k(d, k1p)
    return rowmax, rank


def _sparse_v(feat: Tensor, rowmax: Tensor, rank_k1: Tensor, kh: int, row_block: int,
              val_dtype: torch.dtype, start: int = 0, n_out: int = None):
    """Pass B for rows [start, start + n_out) (all n by default): V rows in
    sparse (index, value) form.

    Per row: expansion candidates, invalid -> sentinel n, indices sorted
    ascending, first occurrences kept (the dense scatter's dedup), exp(-od)
    at the kept columns, normalised to unit sum. Returns (sidx (n_out, E)
    int32 with sentinel n, sval (n_out, E) val_dtype)."""
    n = feat.shape[0]
    n_out = n if n_out is None else n_out
    dev = feat.device
    sq = (feat * feat).sum(dim=1)
    rank_kh = rank_k1[:, :kh]
    width = rank_k1.shape[1] * (kh + 1)
    sidx = torch.empty(n_out, width, dtype=torch.int32, device=dev)
    sval = torch.empty(n_out, width, dtype=val_dtype, device=dev)
    for s in range(0, n_out, row_block):
        e = min(s + row_block, n_out)
        rows = _row_ids(s, e, start, n, dev)
        od_rows = _dist_rows(feat, sq, rows) / rowmax[rows][:, None]
        e_idx, e_val = _expansion_sets(rows, rank_k1, rank_kh, n)
        sorted_idx = torch.sort(torch.where(e_val, e_idx, n), dim=-1).values
        prev = F.pad(sorted_idx[:, :-1], (1, 0), value=-1)
        valid = (sorted_idx < n) & (sorted_idx != prev)
        w = torch.exp(-torch.gather(od_rows, 1, sorted_idx.clamp_max(n - 1)))
        w = torch.where(valid, w, torch.zeros((), device=dev))
        w = w / w.sum(dim=1, keepdim=True).clamp_min(1e-12)
        sidx[s:e] = torch.where(valid, sorted_idx, n).to(torch.int32)
        sval[s:e] = w.to(val_dtype)
    return sidx, sval


def quantize_rows(acc: Tensor, qe_dtype: torch.dtype):
    """Row quantization of non-negative fp32 rows: (values in qe_dtype, fp32
    scale per row, fp32 true row sum after quantization). The row max maps to
    the dtype's largest finite value (fp8 e4m3fn: 448), and to 1 for fp32."""
    fmax = 1.0 if qe_dtype == torch.float32 else float(torch.finfo(qe_dtype).max)
    scale = acc.max(dim=1).values.clamp_min(1e-30) / fmax
    q = (acc / scale[:, None]).to(qe_dtype)
    return q, scale, q.float().sum(dim=1) * scale


def _qe_rows_quantized(sidx: Tensor, sval: Tensor, rank_k2: Tensor, k2: int, row_block: int,
                       n_rows: int, n_rows_pad: int, row_offset: int, n_cols_pad: int,
                       qe_dtype: torch.dtype, start: int = 0):
    """Pass C: query-expanded rows of the segment [row_offset, row_offset +
    n_rows), from its row `start` on, as a dense row-quantized
    (n_rows_pad, n_cols_pad) matrix, rows pre-aligned to the contraction's
    padding. Rows past the segment's end repeat its last real row.

    V_qe[i] = mean of the V rows of i's k2 nearest neighbours (self
    included), built by scatter-adding k2 sparse rows in neighbour order;
    the sentinel column n lands in the padding (or an extra trailing
    column) and is zeroed. Returns (values, scale, the true row sums of the
    real rows: the first n_rows - start)."""
    n = rank_k2.shape[0]
    dev = sidx.device
    width = max(n_cols_pad, n + 1)
    keep = torch.arange(n_cols_pad, device=dev) < n
    q = torch.empty(n_rows_pad, n_cols_pad, dtype=qe_dtype, device=dev)
    scale = torch.empty(n_rows_pad, dtype=torch.float32, device=dev)
    qsum = torch.empty(n_rows_pad, dtype=torch.float32, device=dev)
    for s in range(0, n_rows_pad, row_block):
        e = min(s + row_block, n_rows_pad)
        rows = row_offset + _row_ids(s, e, start, n_rows, dev)
        nbrs = rank_k2[rows]  # (B, k2)
        acc = torch.zeros(e - s, width, dtype=torch.float32, device=dev)
        for j in range(k2):
            nb = nbrs[:, j]
            acc.scatter_add_(1, sidx[nb].long(), sval[nb].float())
        acc = acc[:, :n_cols_pad] * keep / k2
        q[s:e], scale[s:e], qsum[s:e] = quantize_rows(acc, qe_dtype)
    return q, scale, qsum[:max(0, n_rows - start)]


def _streamed_core(qf: Tensor, gf: Tensor, k1: int, k2: int, row_block: int, block_a: int,
                   block_b: int, block_c: int, val_dtype: torch.dtype,
                   qe_dtype: torch.dtype, log=None):
    """Passes A-D (everything but the final blend): returns
    (t, rowmax, a_sum, b_sum) — t the (na_pad, nb_pad) min-sum contraction,
    rowmax the per-row distance max over the whole population, a_sum/b_sum
    the true post-quantization V_qe row sums of queries/gallery. `log`
    (optional) gets one device-synchronised phase per pass."""
    num_q, num_g = int(qf.shape[0]), int(gf.shape[0])
    feat = torch.cat([qf, gf], dim=0)
    dev = feat.device
    n = num_q + num_g
    k1 = min(k1, n - 1)
    k2 = max(1, min(k2, n))
    kh = min(int(np.around(k1 / 2)) + 1, n)
    row_block = min(row_block, n)

    with synced_phase(log, "rerank.pass_a", dev):
        rowmax, rank_k1 = _global_ranks(feat, k1 + 1, row_block)
    with synced_phase(log, "rerank.pass_b", dev):
        sidx, sval = _sparse_v(feat, rowmax, rank_k1, kh, row_block, val_dtype)

    rank_k2 = rank_k1[:, :k2]
    n_cols_pad = _round_up(n, min(block_c, _round_up(n, 128)))

    # rows pre-aligned to the JAX kernel's blocks (the shape of t, which
    # the blend walks); padded rows repeat the last real row
    def _align(nr, blk):
        rbe = min(row_block, _round_up(nr, 8))
        pad = _round_up(nr, rbe)
        if nr >= blk:
            pad = _round_up(pad, blk)
        return pad, rbe

    na_pad, qrb = _align(num_q, block_a)
    nb_pad, grb = _align(num_g, block_b)
    with synced_phase(log, "rerank.pass_c", dev):
        a8, a_scale, a_sum = _qe_rows_quantized(sidx, sval, rank_k2, k2, qrb, num_q, na_pad,
                                                0, n_cols_pad, qe_dtype)
        b8, b_scale, b_sum = _qe_rows_quantized(sidx, sval, rank_k2, k2, grb, num_g, nb_pad,
                                                num_q, n_cols_pad, qe_dtype)
    del sidx, sval

    with synced_phase(log, "rerank.contract", dev):
        t = minsum(a8, a_scale, b8, b_scale)
    return t, rowmax, a_sum, b_sum


def _blend_rows(t_rows: Tensor, qf_rows: Tensor, gf: Tensor, g_sq: Tensor,
                rowmax_rows: Tensor, a_sum_rows: Tensor, b_sum: Tensor,
                lambda_value: float) -> Tensor:
    """jaccard = 1 - t/(sA+sB-t) blended with the row-normalized original
    distance, for a block of query rows."""
    denom = a_sum_rows[:, None] + b_sum[None, :] - t_rows
    jac = 1.0 - t_rows / denom.clamp_min(1e-12)
    with full_fp32():
        cross = qf_rows @ gf.T
    d = (qf_rows * qf_rows).sum(dim=1)[:, None] + g_sq[None, :] - 2.0 * cross
    od_q = d / rowmax_rows[:, None]
    return jac * (1.0 - lambda_value) + od_q * lambda_value


def _streamed_core_sharded(qf: Tensor, gf: Tensor, mesh: Mesh, k1: int, k2: int,
                           row_block: int, block_a: int, block_b: int, block_c: int,
                           val_dtype: torch.dtype, qe_dtype: torch.dtype, log=None):
    """`_streamed_core` over a "data" mesh: every rank holds all features;
    passes A-C split their row ranges contiguously across the ranks (rank r
    owns rows [r*loc, (r+1)*loc), padding rows clamped to the last real
    row); the small artefacts (rank lists, sparse V, the query side of
    V_qe) are gathered onto every rank, while the gallery side of V_qe stays
    sharded: each rank contracts the whole query block against its gallery
    slice through `minsum`, so its V_qe and t memory drop by the world size.

    Returns (t, rowmax, a_sum, b_sum) with t (qa_loc * ranks, gb_loc) — the
    columns of this rank's gallery slice — and the rest global; per-row math
    is the single-device path's."""
    num_q, num_g = int(qf.shape[0]), int(gf.shape[0])
    feat = torch.cat([qf, gf], dim=0)
    dev = feat.device
    n = num_q + num_g
    k1 = min(k1, n - 1)
    k2 = max(1, min(k2, n))
    kh = min(int(np.around(k1 / 2)) + 1, n)
    nd, r = mesh.size, mesh.rank
    n_loc = _round_up(-(-n // nd), 8)
    qa_loc = _round_up(-(-num_q // nd), 8)
    gb_loc = _round_up(-(-num_g // nd), 8)
    rb, rbq, rbg = (min(row_block, m) for m in (n_loc, qa_loc, gb_loc))
    n_cols_pad = _round_up(n, min(block_c, _round_up(n, 128)))

    def gather(x, rows):
        return all_gather_rows(mesh, x)[:rows]

    with synced_phase(log, "rerank.pass_a", dev):
        rowmax, rank_k1 = _global_ranks(feat, k1 + 1, rb, start=r * n_loc, n_out=n_loc)
        rowmax, rank_k1 = gather(rowmax, n), gather(rank_k1, n)
    with synced_phase(log, "rerank.pass_b", dev):
        sidx, sval = _sparse_v(feat, rowmax, rank_k1, kh, rb, val_dtype, start=r * n_loc,
                               n_out=n_loc)
        sidx, sval = gather(sidx, n), gather(sval, n)

    rank_k2 = rank_k1[:, :k2]
    with synced_phase(log, "rerank.pass_c", dev):
        a8, a_scale, a_sum = _qe_rows_quantized(sidx, sval, rank_k2, k2, rbq, num_q, qa_loc, 0,
                                                n_cols_pad, qe_dtype, start=r * qa_loc)
        b8, b_scale, b_sum = _qe_rows_quantized(sidx, sval, rank_k2, k2, rbg, num_g, gb_loc,
                                                num_q, n_cols_pad, qe_dtype, start=r * gb_loc)
        a8, a_scale = all_gather_rows(mesh, a8), all_gather_rows(mesh, a_scale)
        a_sum = gather(F.pad(a_sum, (0, qa_loc - a_sum.shape[0])), num_q)
        b_sum = gather(F.pad(b_sum, (0, gb_loc - b_sum.shape[0])), num_g)
    del sidx, sval

    with synced_phase(log, "rerank.contract", dev):
        t = minsum(a8, a_scale, b8, b_scale)
    return t, rowmax, a_sum, b_sum


def check_mesh(mesh) -> None:
    """Re-ranking takes a parallel/mesh.Mesh, or None; another object with a
    `shape` mapping (a JAX Mesh) only with a "data" axis of 1."""
    if (mesh is not None and not isinstance(mesh, Mesh)
            and dict(mesh.shape).get("data", 1) > 1):
        raise TypeError(f"re-ranking over more than one device takes a "
                        f"tpu_reid_torch.parallel.mesh.Mesh, got {type(mesh).__name__}")


def _core(qf: Tensor, gf: Tensor, mesh, *args):
    """The sharded core for a port mesh (any size: a mesh never falls back
    to the single-device core), the single-device core without one."""
    check_mesh(mesh)
    if isinstance(mesh, Mesh):
        return _streamed_core_sharded(qf, gf, mesh, *args)
    return _streamed_core(qf, gf, *args)


def _t_rows(t: Tensor, mesh, start: int, end: int, num_g: int) -> Tensor:
    """Rows [start, end) of t over the whole gallery: the column slices of
    every rank, gathered, on a mesh; t's own rows without one."""
    if not isinstance(mesh, Mesh):
        return t[start:end, :num_g]
    cols = all_gather_rows(mesh, t[start:end].T.contiguous())  # (ranks * gb_loc, rows)
    return cols[:num_g].T


@torch.no_grad()
def k_reciprocal_rerank_streamed(qf, gf, k1: int = 50, k2: int = 15, lambda_value: float = 0.3,
                                 row_block: int = 256, block_a: int = 1024, block_b: int = 1024,
                                 block_c: int = 2048, val_dtype=torch.bfloat16,
                                 qe_dtype=torch.float8_e4m3fn, mesh=None, log=None) -> Tensor:
    """(Q, G) re-ranked distances with exact global k-reciprocal
    neighbourhoods, on the features' device. Pass
    val_dtype=qe_dtype=torch.float32 for a quantization-free run (the
    parity tests against `k_reciprocal_rerank`). When only CMC/mAP are
    needed, `k_reciprocal_rerank_streamed_rows` + `metrics.cmc_map_from_rows`
    never hold a second full-size buffer. mesh: a parallel/mesh.Mesh shards
    every pass (`_streamed_core_sharded`); every rank gets the whole
    result."""
    qf, gf = _as_features(qf), _as_features(gf)
    num_q, num_g = int(qf.shape[0]), int(gf.shape[0])
    t, rowmax, a_sum, b_sum = _core(qf, gf, mesh, k1, k2, row_block, block_a, block_b,
                                    block_c, val_dtype, qe_dtype, log)
    return _blend_rows(_t_rows(t, mesh, 0, num_q, num_g), qf, gf, (gf * gf).sum(dim=1),
                       rowmax[:num_q], a_sum, b_sum, lambda_value)


@torch.no_grad()
def k_reciprocal_rerank_streamed_rows(qf, gf, k1: int = 50, k2: int = 15,
                                      lambda_value: float = 0.3, q_chunk: int = 1024,
                                      row_block: int = 256, block_a: int = 1024,
                                      block_b: int = 1024, block_c: int = 2048,
                                      val_dtype=torch.bfloat16, qe_dtype=torch.float8_e4m3fn,
                                      mesh=None, log=None):
    """Row-provider variant: returns ``(row_fn, q_chunk)`` where
    ``row_fn(start)`` yields the fp32 ``(q_chunk, num_g)`` block of
    re-ranked distances for queries [start, start+q_chunk) — start walks
    multiples of q_chunk, as `metrics.cmc_map_from_rows` does. The blend
    runs per chunk and the metric consumes each block at once, so the peak
    memory stays the pipeline's own. Rows past num_q (tail padding) repeat
    the last real query row; the metric layer masks them out via pid -1.

    On a mesh every call gathers the chunk's rows of t from the ranks'
    column slices: a collective, so every rank walks the same chunks (the
    caller's q_chunk bounds the blend's memory there too)."""
    qf, gf = _as_features(qf), _as_features(gf)
    num_q, num_g = int(qf.shape[0]), int(gf.shape[0])
    q_chunk = min(q_chunk, num_q)
    t, rowmax, a_sum, b_sum = _core(qf, gf, mesh, k1, k2, row_block, block_a, block_b,
                                    block_c, val_dtype, qe_dtype, log)
    na_pad = int(t.shape[0])
    need = _round_up(num_q, q_chunk)
    if need > na_pad:
        # only with a q_chunk that does not divide the row padding (small
        # populations); the default never pads t
        t = F.pad(t, (0, 0, 0, need - na_pad))
        na_pad = need
    qf_pad = F.pad(qf, (0, 0, 0, na_pad - num_q))
    a_sum_pad = F.pad(a_sum, (0, na_pad - num_q), value=1.0)
    rowmax_q_pad = F.pad(rowmax[:num_q], (0, na_pad - num_q), value=1.0)
    g_sq = (gf * gf).sum(dim=1)

    @torch.no_grad()
    def row_fn(start: int) -> Tensor:
        end = start + q_chunk
        return _blend_rows(_t_rows(t, mesh, start, end, num_g), qf_pad[start:end], gf, g_sq,
                           rowmax_q_pad[start:end], a_sum_pad[start:end], b_sum,
                           lambda_value)

    return row_fn, q_chunk
