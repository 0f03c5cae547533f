"""tpu_reid_torch.data.transforms: the eval path against tpu_reid's, and
its bicubic resize against jax.image.resize(method="cubic") (Keys a=-0.5,
antialiased when downsampling) — not torch's a=-0.75 bicubic."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tpu_reid.data.transforms import DevicePreprocess as JPre
from tpu_reid_torch.data.transforms import DevicePreprocess, norm_stats, resize_cubic

# values on the 0..255 scale (measured max|d| 2e-4): both sides compute the
# weights in fp32, and the two einsums may sum in another order
ATOL = 5e-4


@pytest.mark.parametrize("src_hw,dst_hw", [
    ((128, 64), (256, 128)),   # upsampling
    ((300, 150), (256, 128)),  # downsampling (antialiased)
    ((256, 100), (256, 128)),  # one axis unchanged, the other up
    ((97, 131), (64, 48)),     # odd sizes, strong downsampling
])
def test_resize_cubic_matches_jax_image_resize(src_hw, dst_hw):
    rng = np.random.RandomState(sum(src_hw))
    img = rng.randint(0, 256, (2, *src_hw, 3)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(img), (2, *dst_hw, 3), method="cubic")
    got = resize_cubic(torch.from_numpy(img), dst_hw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_resize_is_not_torch_bicubic_when_downsampling():
    """The trap this module avoids: torch's bicubic differs from JAX's."""
    img = np.random.RandomState(0).randint(0, 256, (1, 300, 150, 3)).astype(np.float32)
    ours = resize_cubic(torch.from_numpy(img), (256, 128))
    torch_bicubic = F.interpolate(torch.from_numpy(img).permute(0, 3, 1, 2), (256, 128),
                                  mode="bicubic", align_corners=False).permute(0, 2, 3, 1)
    assert float((ours - torch_bicubic).abs().max()) > 1.0


@pytest.mark.parametrize("src_hw", [(256, 128), (200, 90)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_device_preprocess_eval_paths_match_jax(src_hw, dtype):
    rng = np.random.RandomState(7)
    u8 = rng.randint(0, 256, (3, *src_hw, 3)).astype(np.uint8)
    jp = JPre((256, 128), "vit", dtype=getattr(jnp, dtype))
    tp = DevicePreprocess((256, 128), "vit", dtype=getattr(torch, dtype))
    atol = ATOL if dtype == "float32" else 1.0  # bf16 keeps 8 significant bits
    for name, scale in (("eval_batch", 2 / 255), ("eval_batch_raw", 1.0),
                        ("eval_flip_batch", 2 / 255)):
        want = np.asarray(getattr(jp, name)(jnp.asarray(u8)).astype(jnp.float32))
        got = getattr(tp, name)(torch.from_numpy(u8))
        assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == (3, 256, 128, 3)
        np.testing.assert_allclose(got.float().numpy(), want, atol=atol * scale, rtol=0,
                                   err_msg=name)


def test_norm_stats():
    assert norm_stats("vit") == ((0.5, 0.5, 0.5), (0.5, 0.5, 0.5))
    assert norm_stats("rn")[0] == (0.485, 0.456, 0.406)
