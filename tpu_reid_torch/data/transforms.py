"""Image preprocessing on the device: the eval path and the train
augmentation.

uint8 (B, H, W, 3) batches -> normalized float (B, h, w, 3): bicubic resize
when the stored size differs, then normalization (or the raw 0..255 scale
for models whose normalization is folded into the patch embed). The train
path (`train_batch`) adds a random flip, pad + random crop and random
erasing, as tpu_reid/data/transforms.py's DevicePreprocess.train_batch. It
is two functions: `train_draws` makes every random draw from a
`torch.Generator` (flip bits, crop offsets, the erasing draws, the noise),
and `train_batch` is a deterministic function of the images and those draws
— so a test can feed the JAX function's own draws to the port.

The resize reproduces `jax.image.resize(method="cubic")`, which is what the
JAX package runs: the Keys cubic kernel with a = -0.5, and antialiasing when
downsampling (the kernel is stretched by the inverse scale and each output's
weights renormalised). torch's `F.interpolate(mode="bicubic")` uses a = -0.75
and no antialias, so it is not used.

Normalization constants: ViT towers use (0.5,0.5,0.5)/(0.5,0.5,0.5); RN
towers use ImageNet stats.

The normalisation constants and the resize weights are made once per
(size, dtype, device) and reused: a training step captured as a CUDA graph
(train/step_graph.py) may make no host-to-device copy, and building them on
every call made one.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import numpy as np
import torch

VIT_MEAN = (0.5, 0.5, 0.5)
VIT_STD = (0.5, 0.5, 0.5)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

Tensor = torch.Tensor


def norm_stats(model_type: str) -> Tuple[Tuple[float, ...], Tuple[float, ...]]:
    if model_type == "vit":
        return VIT_MEAN, VIT_STD
    return IMAGENET_MEAN, IMAGENET_STD


# (in_size, out_size, device) -> weights, and (model_type, device) ->
# (mean, std): made once, reused by every later call
_WEIGHT_MATS: Dict[tuple, Tensor] = {}
_NORM_CONSTS: Dict[tuple, Tuple[Tensor, Tensor]] = {}


def _device_key(device) -> torch.device:
    dev = torch.device("cpu" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def norm_constants(model_type: str, device=None) -> Tuple[Tensor, Tensor]:
    """(mean, std) as fp32 (3,) tensors on `device`, one pair per
    (model_type, device), made at the first call: do not write into them."""
    key = (model_type, _device_key(device))
    out = _NORM_CONSTS.get(key)
    if out is None:
        mean, std = norm_stats(model_type)
        out = _NORM_CONSTS[key] = (torch.tensor(mean, dtype=torch.float32, device=key[1]),
                                   torch.tensor(std, dtype=torch.float32, device=key[1]))
    return out


def _keys_cubic(x: Tensor) -> Tensor:
    """Keys cubic kernel, a = -0.5, on non-negative distances."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def cubic_weight_mat(in_size: int, out_size: int, device=None) -> Tensor:
    """(in_size, out_size) fp32 resampling weights, the same computation as
    jax.image.scale.compute_weight_mat with the cubic kernel, antialias on
    and no translation. One tensor per (sizes, device), made at the first
    call: do not write into it."""
    key = (in_size, out_size, _device_key(device))
    w = _WEIGHT_MATS.get(key)
    if w is None:
        w = _WEIGHT_MATS[key] = _cubic_weight_mat(in_size, out_size).to(key[2])
    return w


def _cubic_weight_mat(in_size: int, out_size: int) -> Tensor:
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (torch.arange(out_size, dtype=torch.float32) + 0.5) * inv_scale - 0.5
    x = (sample_f[None, :] - torch.arange(in_size, dtype=torch.float32)[:, None]).abs()
    w = _keys_cubic(x / kernel_scale)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(
        total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
        w / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(w),
    )
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize_cubic(images: Tensor, size_hw: Tuple[int, int]) -> Tensor:
    """(B, H, W, C) float -> (B, h, w, C) float32, as
    jax.image.resize(method="cubic") (axes whose size is unchanged are left
    alone)."""
    x = images.float()
    h, w = size_hw
    if x.shape[1] != h:
        x = torch.einsum("bhwc,ho->bowc", x, cubic_weight_mat(x.shape[1], h, x.device))
    if x.shape[2] != w:
        x = torch.einsum("bhwc,wo->bhoc", x, cubic_weight_mat(x.shape[2], w, x.device))
    return x


@dataclasses.dataclass(frozen=True)
class DevicePreprocess:
    """Batched eval preprocessing on the images' device: uint8
    (B, H, W, 3) -> normalized (B, h, w, 3) in `dtype`."""

    size_hw: Tuple[int, int]
    model_type: str = "vit"
    dtype: torch.dtype = torch.float32

    def _normalize(self, x: Tensor) -> Tensor:
        mean_t, std_t = norm_constants(self.model_type, x.device)
        x = x.float() / 255.0
        return ((x - mean_t) / std_t).to(self.dtype)

    def eval_batch(self, images_u8: Tensor) -> Tensor:
        if tuple(images_u8.shape[1:3]) == tuple(self.size_hw):
            return self._normalize(images_u8)  # host already sized the crop
        return self._normalize(resize_cubic(images_u8, self.size_hw))

    def eval_batch_raw(self, images_u8: Tensor) -> Tensor:
        """Raw-scale eval path for normalization-folded models
        (models.vit.fold_visual_input_norm): 0..255-scale values in
        self.dtype, resized if needed. The bicubic resize is linear with
        weights summing to 1, so it commutes exactly with the folded affine
        normalization; uint8 values are exact in bfloat16."""
        if tuple(images_u8.shape[1:3]) == tuple(self.size_hw):
            return images_u8.to(self.dtype)
        return resize_cubic(images_u8, self.size_hw).to(self.dtype)

    def eval_flip_batch(self, images_u8: Tensor) -> Tensor:
        """Deterministic flip-TTA pass (horizontal flip, center-equivalent
        crop)."""
        return self.eval_batch(images_u8.flip(2))

    def train_draws(self, gen: torch.Generator, b: int, pad_hw: Tuple[int, int] = (10, 10),
                    erasing_prob: float = 0.5) -> Dict[str, Tensor]:
        """The random draws of one `train_batch` of b images, on `gen`'s
        device: flip bits, crop offsets, then `erasing_draws`."""
        pv, ph = pad_hw
        dev = gen.device
        draws = {
            "flip": torch.rand(b, generator=gen, device=dev) < 0.5,
            "top": torch.randint(0, 2 * pv + 1, (b,), generator=gen, device=dev),
            "left": torch.randint(0, 2 * ph + 1, (b,), generator=gen, device=dev),
        }
        draws.update(erasing_draws(gen, (b, *self.size_hw, 3), erasing_prob, self.dtype))
        return draws

    def train_batch(self, images_u8: Tensor, draws: Dict[str, Tensor],
                    pad_hw: Tuple[int, int] = (10, 10)) -> Tensor:
        """Train augmentation, deterministic given `draws` (from
        `train_draws`): resize -> flip -> zero pad + crop -> normalize ->
        random erasing."""
        h, w = self.size_hw
        b = images_u8.shape[0]
        x = resize_cubic(images_u8, self.size_hw)
        x = torch.where(draws["flip"].to(x.device)[:, None, None, None], x.flip(2), x)
        pv, ph = pad_hw
        x = torch.nn.functional.pad(x, (0, 0, ph, ph, pv, pv))
        rows = draws["top"].to(x.device)[:, None] + torch.arange(h, device=x.device)
        cols = draws["left"].to(x.device)[:, None] + torch.arange(w, device=x.device)
        bidx = torch.arange(b, device=x.device)[:, None, None]
        x = x[bidx, rows[:, :, None], cols[:, None, :]]
        return random_erasing(self._normalize(x), draws)


def erasing_draws(gen: torch.Generator, shape, prob: float = 0.5,
                  dtype: torch.dtype = torch.float32,
                  area_range=(0.02, 1 / 3),
                  aspect_range=(0.3, 10 / 3)) -> Dict[str, Tensor]:
    """The draws of `random_erasing` for a (B, h, w, C) batch: apply bits,
    the area fraction and log aspect ratio, the rectangle's position as
    uniforms in [0, 1), and the N(0, 1) noise in `dtype`."""
    b = shape[0]
    dev = gen.device

    def uniform(lo, hi):
        return torch.rand(b, generator=gen, device=dev) * (hi - lo) + lo

    return {
        "apply": torch.rand(b, generator=gen, device=dev) < prob,
        "area": uniform(*area_range),
        "log_ar": uniform(math.log(aspect_range[0]), math.log(aspect_range[1])),
        "top_u": torch.rand(b, generator=gen, device=dev),
        "left_u": torch.rand(b, generator=gen, device=dev),
        "noise": torch.randn(shape, generator=gen, device=dev).to(dtype),
    }


def random_erasing(x: Tensor, draws: Dict[str, Tensor]) -> Tensor:
    """Batched timm-style pixel-mode random erasing, deterministic given the
    draws: one rectangle per image (max_count=1) from a single sampling
    attempt with its sides clamped to the image, filled with the noise, as
    tpu_reid/data/transforms.py's random_erasing."""
    b, h, w, _ = x.shape
    dev = x.device
    target = draws["area"].to(dev).float() * (h * w)
    ar = torch.exp(draws["log_ar"].to(dev).float())
    eh = torch.round(torch.sqrt(target * ar)).clamp(1, h - 1).to(torch.int32)
    ew = torch.round(torch.sqrt(target / ar)).clamp(1, w - 1).to(torch.int32)
    top = (draws["top_u"].to(dev).float() * (h - eh + 1)).to(torch.int32)
    left = (draws["left_u"].to(dev).float() * (w - ew + 1)).to(torch.int32)
    rows = torch.arange(h, device=dev)[None, :, None]
    cols = torch.arange(w, device=dev)[None, None, :]
    in_rect = ((rows >= top[:, None, None]) & (rows < (top + eh)[:, None, None])
               & (cols >= left[:, None, None]) & (cols < (left + ew)[:, None, None])
               & draws["apply"].to(dev)[:, None, None])
    return torch.where(in_rect[..., None], draws["noise"].to(dev, x.dtype), x)
