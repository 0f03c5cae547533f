"""ReID heads: BNNeck, ID classifiers, CLIP-Adapter bottleneck (a copy of
tpu_reid/models/heads.py, with `batch_norm`/`init_bn` copied from
tpu_reid/models/resnet.py).

  * BNNeck — a BatchNorm1d whose bias is frozen at zero, applied to the
    backbone feature before the ID classifier; retrieval uses the post-BN
    feature.
  * Classifier — paired (768-d and 512-d) BNNeck + bias-free linear ID heads.
  * Adapter — 768->768/4->768 ReLU MLP without biases, residual-blended at
    ratio 0.2 into the non-projected image feature.

Train-mode batch norm returns the momentum-updated running statistics
instead of writing them in place: the trainer threads them as state.
Initialisations take an explicit `torch.Generator`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

Tensor = torch.Tensor


def _normal(gen: torch.Generator, *shape: int, std: float = 1.0) -> Tensor:
    return torch.randn(*shape, generator=gen, dtype=torch.float32) * std


def init_bn(c: int) -> dict:
    return {
        "scale": torch.ones(c),
        "bias": torch.zeros(c),
        "mean": torch.zeros(c),
        "var": torch.ones(c),
    }


def batch_norm(p: dict, x: Tensor, train: bool = False, eps: float = 1e-5,
               momentum: float = 0.1, valid: Optional[Tensor] = None
               ) -> Tuple[Tensor, Optional[dict]]:
    """BatchNorm over all axes but the channel (last) axis, fp32 statistics.

    Returns (y, new_stats): new_stats is None at inference and the
    momentum-updated {mean, var} in train mode (torch convention:
    new = (1 - m) * running + m * batch, unbiased var for the update).
    valid: optional (B,) bool mask — padded rows stay out of the batch
    statistics."""
    x32 = x.float()
    if train:
        axes = tuple(range(x.dim() - 1))
        if valid is not None:
            shape = (valid.shape[0],) + (1,) * (x.dim() - 1)
            w = valid.float().reshape(shape)
            n = torch.clamp(w.sum() * (x32.numel() // x32.shape[-1] // valid.shape[0]),
                            min=1.0)
            mean = (x32 * w).sum(dim=axes) / n
            var = ((x32 - mean).square() * w).sum(dim=axes) / n
            unbiased = var * (n / torch.clamp(n - 1.0, min=1.0))
        else:
            mean = x32.mean(dim=axes)
            var = (x32 - mean).square().mean(dim=axes)
            n = x32.numel() // x32.shape[-1]
            unbiased = var * (n / max(n - 1, 1))
        new_stats = {
            "mean": (1 - momentum) * p["mean"] + momentum * mean,
            "var": (1 - momentum) * p["var"] + momentum * unbiased,
        }
    else:
        mean, var = p["mean"], p["var"]
        new_stats = None
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * p["scale"] + p["bias"]
    return y.to(x.dtype), new_stats


def init_bnneck(dim: int) -> dict:
    return init_bn(dim)


def apply_bnneck(p: dict, x: Tensor, train: bool = False, valid=None
                 ) -> Tuple[Tensor, Optional[dict]]:
    """BatchNorm1d over (B, D). The bias entry is kept frozen at zero by the
    trainer's parameter partition (models/reid_clip.stage2_trainable)."""
    return batch_norm(p, x, train=train, valid=valid)


def init_classifier_head(gen: torch.Generator, dim: int, n_classes: int) -> dict:
    """normal(std=0.001) ID head (in, out)."""
    return {"w": _normal(gen, dim, n_classes, std=0.001)}


def apply_classifier_head(p: dict, x: Tensor) -> Tensor:
    return x @ p["w"].to(x.dtype)


def init_classifier(gen: torch.Generator, n_classes: int, dim_nonproj: int = 768,
                    dim_proj: int = 512) -> dict:
    """Shared BNNeck head pair: one for the non-projected (768) feature, one
    for the projected (512) feature."""
    return {
        "bn": init_bnneck(dim_nonproj),
        "bn_proj": init_bnneck(dim_proj),
        "cls": init_classifier_head(gen, dim_nonproj, n_classes),
        "cls_proj": init_classifier_head(gen, dim_proj, n_classes),
    }


def apply_classifier(p: dict, feat: Tensor, feat_proj: Tensor, train: bool = False,
                     valid=None) -> dict:
    """Post-BN features and ID logits for both levels, and the new BN
    statistics (None outside training)."""
    bn_feat, bn_stats = apply_bnneck(p["bn"], feat, train, valid=valid)
    bn_proj, bn_proj_stats = apply_bnneck(p["bn_proj"], feat_proj, train, valid=valid)
    return {
        "bn_feat": bn_feat,
        "bn_feat_proj": bn_proj,
        "logits": apply_classifier_head(p["cls"], bn_feat),
        "logits_proj": apply_classifier_head(p["cls_proj"], bn_proj),
        "new_stats": {"bn": bn_stats, "bn_proj": bn_proj_stats},
    }


def init_adapter(gen: torch.Generator, dim: int = 768, reduction: int = 4) -> dict:
    hid = dim // reduction
    return {
        "fc1": {"w": _normal(gen, dim, hid, std=(2.0 / dim) ** 0.5)},
        "fc2": {"w": _normal(gen, hid, dim, std=(2.0 / hid) ** 0.5)},
    }


def apply_adapter(p: dict, x: Tensor, ratio: float = 0.2) -> Tensor:
    """Residual adapter blend: ratio*mlp(x) + (1-ratio)*x."""
    h = torch.relu(x @ p["fc1"]["w"].to(x.dtype))
    h = torch.relu(h @ p["fc2"]["w"].to(x.dtype))
    return ratio * h + (1.0 - ratio) * x
