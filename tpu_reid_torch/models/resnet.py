"""ModifiedResNet (CLIP RN50-style) vision tower over a plain parameter dict
(the port of tpu_reid/models/resnet.py).

  * a three-conv stem and a final 2x2 average pool,
  * bottleneck blocks whose strides are average pools: before conv3 and in
    the downsample branch,
  * layer 4 at stride 1 (the ReID variant), so the final map is input/16,
  * an attention-pool head with a mean-token query over a rectangular
    (h_grid * w_grid + 1) positional embedding, returning the whole attended
    sequence,
  * the triple output (x3, x4, xproj): the layer-3 map, the layer-4 map and
    the attention-pooled sequence projected to the embed dim.

Images come in as (B, H, W, 3), as the preprocess gives them. Inside the
tower the layout is torch's NCHW with OIHW conv weights (the converter and
`weights/convert.from_jax_params` transpose from the JAX package's HWIO);
an NHWC input permuted to NCHW is already channels_last in memory, which
cuDNN keeps. Convolutions pad as XLA's "SAME" does, which for the stride-2
stem conv on an even input is (0, 1): nothing at the top and left, one row
and column at the bottom and right (OpenAI CLIP's stem pads (1, 1)). The
attention pool is plain PyTorch, as it is plain XLA in the JAX package; it
is no kernel in either. BatchNorm runs in eval mode with fp32 statistics
(models/heads.batch_norm).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from tpu_reid_torch.configs import ResNetConfig
from tpu_reid_torch.models import heads as H
from tpu_reid_torch.models import layers as L

Tensor = torch.Tensor

EXPANSION = 4


def same_padding(n: int, k: int, stride: int) -> Tuple[int, int]:
    """(before, after) padding of one spatial axis of size n under XLA's
    "SAME" rule: the output has ceil(n / stride) positions and the odd pixel
    of the padding goes after."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def conv2d(p: dict, x: Tensor, stride: int = 1) -> Tensor:
    """(B, C, H, W) conv with an OIHW weight, padded as "SAME"."""
    w = p["w"].to(x.dtype)
    (t, b), (lft, r) = (same_padding(x.shape[2], w.shape[2], stride),
                        same_padding(x.shape[3], w.shape[3], stride))
    if t == b and lft == r:
        return F.conv2d(x, w, stride=stride, padding=(t, lft))
    return F.conv2d(F.pad(x, (lft, r, t, b)), w, stride=stride)


def batch_norm(p: dict, x: Tensor) -> Tensor:
    """Eval-mode BatchNorm over the channel axis (1) of a (B, C, H, W)
    map, fp32 statistics, cast back to the input dtype."""
    y, _ = H.batch_norm(p, x.movedim(1, -1))
    return y.movedim(-1, 1)


def avg_pool(x: Tensor, k: int) -> Tensor:
    """k x k average pool with stride k; a ragged edge is dropped, as JAX's
    VALID window does."""
    return F.avg_pool2d(x, k, k)


def apply_bottleneck(p: dict, x: Tensor, stride: int) -> Tensor:
    out = torch.relu(batch_norm(p["bn1"], conv2d(p["conv1"], x)))
    out = torch.relu(batch_norm(p["bn2"], conv2d(p["conv2"], out)))
    if stride > 1:
        out = avg_pool(out, stride)
    out = batch_norm(p["bn3"], conv2d(p["conv3"], out))
    identity = x
    if "down_conv" in p:
        if stride > 1:
            identity = avg_pool(identity, stride)
        identity = batch_norm(p["down_bn"], conv2d(p["down_conv"], identity))
    return torch.relu(out + identity)


def apply_attnpool(p: dict, x: Tensor, n_heads: int) -> Tensor:
    """(B, C, H, W) -> (B, 1 + H*W, output_dim), the whole attended
    sequence. Token 0 is the mean-pooled query token (callers take [:, 0]
    as the global feature); the scores and the softmax are fp32."""
    b, c, h, w = x.shape
    x = x.flatten(2).transpose(1, 2)  # (B, HW, C), row-major grid order
    x = torch.cat([x.mean(dim=1, keepdim=True), x], dim=1)
    x = x + p["positional_embedding"].to(x.dtype)
    s, dh = x.shape[1], c // n_heads

    def heads(name):
        return L.linear(p[name], x).reshape(b, s, n_heads, dh).transpose(1, 2)

    q, k, v = heads("q_proj"), heads("k_proj"), heads("v_proj")
    scores = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(dh)
    attn = torch.softmax(scores, dim=-1).to(x.dtype)
    out = (attn @ v).transpose(1, 2).reshape(b, s, c)
    return L.linear(p["c_proj"], out)


def layer_strides(cfg: ResNetConfig) -> Tuple[int, int, int, int]:
    return 1, 2, 2, cfg.layer4_stride


def apply_resnet(params: dict, cfg: ResNetConfig,
                 images: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """(B, H, W, 3) images -> (x3, x4, xproj): the layer-3 map
    (B, C3, h, w), the layer-4 map (B, C4, h, w) and the attention-pooled
    sequence (B, 1 + h*w, output_dim)."""
    x = images.permute(0, 3, 1, 2)
    x = torch.relu(batch_norm(params["bn1"], conv2d(params["conv1"], x, stride=2)))
    x = torch.relu(batch_norm(params["bn2"], conv2d(params["conv2"], x)))
    x = torch.relu(batch_norm(params["bn3"], conv2d(params["conv3"], x)))
    x = avg_pool(x, 2)
    feats = []
    for i, stride in enumerate(layer_strides(cfg)):
        for j, block in enumerate(params[f"layer{i + 1}"]):
            x = apply_bottleneck(block, x, stride if j == 0 else 1)
        feats.append(x)
    return feats[2], feats[3], apply_attnpool(params["attnpool"], x, cfg.heads)
