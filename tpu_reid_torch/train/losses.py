"""Training losses — supervised contrastive, batch-hard triplet and
label-smoothed cross entropy (the port of tpu_reid/train/losses.py, plus
`smooth_l1` of tpu_reid/train/trainer.py).

  * supcon_loss — text<->image supervised contrastive at temperature 1.0
    with a label-equality positive mask and a detached row max for the
    log-sum-exp; applied in both directions in stage 1.
  * triplet_loss — batch-hard mining (hardest positive = max distance,
    hardest negative = min distance) over a euclidean distance matrix with
    sqrt clamped at 1e-12. margin=0.3 gives mean(relu(d_ap - d_an + m));
    margin=None mean(softplus(d_ap - d_an)).
  * cross_entropy_label_smooth — ε=0.1 smoothing, mean over the batch of
    the sum over classes.

Every loss takes an optional `valid` mask (B,) bool: padded rows
contribute nothing to the value or the gradient, with the masked mean's
denominator max(Σvalid, 1) as in JAX. Hard mining uses `amax`/`amin`, which
split the gradient of a tie evenly among the tied entries, as JAX's max and
min do (`max(dim=)` would hand all of it to one index).

  * triplet_loss_xbm — the same mining of a batch's anchors against a
    cross-batch memory bank (train/xbm.py), without each anchor's own slot
    and without the bank's unfilled or padded slots.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def _masked_mean(x: Tensor, valid: Optional[Tensor]) -> Tensor:
    if valid is None:
        return x.mean()
    v = valid.float()
    return (x * v).sum() / v.sum().clamp_min(1.0)


def euclidean_dist(x: Tensor, y: Tensor) -> Tensor:
    """Pairwise euclidean distance with a 1e-12 clamp before the sqrt."""
    x, y = x.float(), y.float()
    sq = (x * x).sum(dim=1, keepdim=True) + (y * y).sum(dim=1, keepdim=True).T - 2.0 * x @ y.T
    return torch.sqrt(sq.clamp_min(1e-12))


def batch_hard_mining(dist: Tensor, labels: Tensor, labels_cols: Optional[Tensor] = None,
                      exclude_cols: Optional[Tensor] = None) -> tuple[Tensor, Tensor]:
    """Hardest positive (max dist) and hardest negative (min dist) per row.
    exclude_cols: optional (N, M) bool mask of columns to ignore."""
    if labels_cols is None:
        labels_cols = labels
    is_pos = labels[:, None] == labels_cols[None, :]
    is_neg = ~is_pos
    if exclude_cols is not None:
        is_pos = is_pos & ~exclude_cols
        is_neg = is_neg & ~exclude_cols
    d_ap = torch.where(is_pos, dist, torch.full_like(dist, -1e30)).amax(dim=1)
    d_an = torch.where(is_neg, dist, torch.full_like(dist, 1e30)).amin(dim=1)
    return d_ap, d_an


def _ranking_loss(d_ap: Tensor, d_an: Tensor, margin: Optional[float],
                  valid: Optional[Tensor] = None) -> Tensor:
    if margin is not None:
        return _masked_mean(torch.relu(d_ap - d_an + margin), valid)
    return _masked_mean(F.softplus(d_ap - d_an), valid)


def triplet_loss(feat: Tensor, labels: Tensor, margin: Optional[float] = 0.3,
                 normalize_feature: bool = False, valid: Optional[Tensor] = None) -> Tensor:
    if normalize_feature:
        feat = feat / torch.linalg.norm(feat, dim=-1, keepdim=True)
    dist = euclidean_dist(feat, feat)
    exclude = None
    if valid is not None:
        # padded rows are neither anchors (masked mean) nor candidates
        exclude = (~valid.bool())[None, :].expand_as(dist)
    d_ap, d_an = batch_hard_mining(dist, labels, exclude_cols=exclude)
    return _ranking_loss(d_ap, d_an, margin, valid)


def triplet_loss_xbm(feat: Tensor, labels: Tensor, feat_xbm: Tensor, labels_xbm: Tensor,
                     margin: Optional[float] = None, self_cols: Optional[Tensor] = None,
                     valid_cols: Optional[Tensor] = None, normalize_feature: bool = False,
                     valid: Optional[Tensor] = None) -> Tensor:
    """Anchors (N, D) against a memory bank (M, D). self_cols: (N,) column
    of each anchor's own slot in the bank (excluded from the mining).
    valid_cols: (M,) bool mask of the usable bank slots. valid: (N,) anchor
    mask (padded anchors stay out of the mean)."""
    if normalize_feature:
        feat = feat / torch.linalg.norm(feat, dim=-1, keepdim=True)
        feat_xbm = feat_xbm / torch.linalg.norm(feat_xbm, dim=-1, keepdim=True)
    dist = euclidean_dist(feat, feat_xbm)
    m = feat_xbm.shape[0]
    exclude = None
    if self_cols is not None:
        exclude = self_cols[:, None] == torch.arange(m, device=dist.device)[None, :]
    if valid_cols is not None:
        invalid = (~valid_cols.bool())[None, :].expand_as(dist)
        exclude = invalid if exclude is None else exclude | invalid
    d_ap, d_an = batch_hard_mining(dist, labels, labels_xbm, exclude)
    return _ranking_loss(d_ap, d_an, margin, valid)


def supcon_loss(anchor_features: Tensor, contrast_features: Tensor, anchor_labels: Tensor,
                contrast_labels: Tensor, temperature: float = 1.0,
                anchor_valid: Optional[Tensor] = None,
                contrast_valid: Optional[Tensor] = None) -> Tensor:
    """Supervised contrastive loss between two feature sets. Invalid
    contrast columns drop out of both the positive mask and the
    denominator; invalid anchor rows drop out of the mean."""
    a, c = anchor_features.float(), contrast_features.float()
    mask = (anchor_labels[:, None] == contrast_labels[None, :]).float()
    logits = (a @ c.T) / temperature
    if contrast_valid is not None:
        cv = contrast_valid.bool()[None, :]
        mask = mask * cv.float()
        logits = torch.where(cv, logits, torch.full_like(logits, -1e30))
    logits = logits - logits.amax(dim=1, keepdim=True).detach()
    log_prob = logits - torch.log(torch.exp(logits).sum(dim=1, keepdim=True))
    mean_log_prob_pos = (mask * log_prob).sum(dim=1) / mask.sum(dim=1).clamp_min(1e-12)
    return -_masked_mean(mean_log_prob_pos, anchor_valid)


def cross_entropy_label_smooth(logits: Tensor, labels: Tensor, epsilon: float = 0.1,
                               valid: Optional[Tensor] = None) -> Tensor:
    """ε-smoothed CE, mean over the batch of the sum over classes."""
    n_cls = logits.shape[-1]
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    targets = F.one_hot(labels.long(), n_cls).float()
    targets = (1.0 - epsilon) * targets + epsilon / n_cls
    return _masked_mean((-targets * log_probs).sum(dim=-1), valid)


def cross_entropy(logits: Tensor, labels: Tensor, valid: Optional[Tensor] = None) -> Tensor:
    """Plain CE."""
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    per_row = -log_probs.gather(1, labels.long()[:, None])[:, 0]
    return _masked_mean(per_row, valid)


def smooth_l1(x: Tensor, y: Tensor, valid: Optional[Tensor] = None) -> Tensor:
    """F.smooth_l1_loss(beta=1, mean) for the promptsrc distillation term;
    valid: optional (B,) row mask."""
    d = (x.float() - y.float()).abs()
    e = torch.where(d < 1.0, 0.5 * d * d, d - 0.5)
    if valid is None:
        return e.mean()
    w = valid.float()[:, None]
    return (e * w).sum() / (w.sum() * e.shape[-1]).clamp_min(1.0)
