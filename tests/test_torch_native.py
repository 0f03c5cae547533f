"""The port's native decoder (tpu_reid_torch/native: its copy of loader.cc,
built into build/native/) against the JAX package's (tpu_reid/native) and
PIL: the same source gives the same pixels bit for bit; PIL within the JAX
package's tolerance (tests/test_native.py); a failed decode zero-fills its
row; the persistent pool equals the per-call pool; BatchLoader's "native"
and "auto" backends decode with it. Skipped, as tests/test_native.py is,
where the library cannot be built (no g++ or libjpeg)."""

import numpy as np
import pytest

from tpu_reid import native as jnative
from tpu_reid_torch import native
from tpu_reid_torch.data.loader import BatchLoader


@pytest.fixture(scope="module")
def built():
    if not native.available():
        pytest.skip("the native decoder cannot be built here (no g++ or libjpeg)")
    return native


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    from PIL import Image

    d = tmp_path_factory.mktemp("jpgs")
    rng = np.random.RandomState(0)
    paths = []
    for i, (h, w) in enumerate([(128, 64), (99, 47), (256, 128), (37, 21)]):
        base = rng.randint(0, 255, (8, 4, 3), np.uint8)
        img = np.asarray(Image.fromarray(base).resize((w, h), Image.BILINEAR), np.uint8)
        p = str(d / f"img{i}.jpg")
        Image.fromarray(img).save(p, quality=95)
        paths.append(p)
    return paths


def test_the_library_builds_under_build_native(built):
    path = built.library_path()
    assert path.exists() and path.parent.name == "native" and path.parent.parent.name == "build"


@pytest.mark.parametrize("size_hw", [(64, 32), (256, 128), (37, 21)])
def test_pixels_equal_the_jax_packages(built, jpegs, size_hw):
    if not jnative.available():
        pytest.skip("the JAX package's native decoder is not available")
    np.testing.assert_array_equal(built.decode_resize_batch(jpegs, size_hw),
                                  jnative.decode_resize_batch(jpegs, size_hw))
    for p in jpegs:
        np.testing.assert_array_equal(built.decode_jpeg(p), jnative.decode_jpeg(p))


def test_decode_and_resize_match_pil(built, jpegs):
    from PIL import Image

    ours = built.decode_jpeg(jpegs[0])
    np.testing.assert_array_equal(ours, np.asarray(Image.open(jpegs[0]).convert("RGB")))
    out = built.decode_resize_batch(jpegs, (64, 32))
    for i, p in enumerate(jpegs):
        ref = np.asarray(Image.open(p).convert("RGB").resize((32, 64), Image.BICUBIC),
                         np.float32)
        diff = np.abs(out[i].astype(np.float32) - ref)
        assert diff.mean() < 0.6 and np.percentile(diff, 99) <= 2.0, i


def test_a_failed_decode_zero_fills(built, jpegs, tmp_path):
    bad = tmp_path / "not_a_jpeg.jpg"
    bad.write_text("nope")
    out = built.decode_resize_batch([jpegs[0], str(bad)], (32, 16))
    assert out[0].any() and not out[1].any()
    with pytest.raises(ValueError, match="all 1 JPEG decodes failed"):
        built.decode_resize_batch([str(bad)], (32, 16))
    with pytest.raises(ValueError, match="decode failed"):
        built.decode_jpeg(str(bad))
    with pytest.raises(ValueError, match="C-contiguous uint8"):
        built.decode_resize_batch(jpegs, (32, 16), out=np.zeros((4, 32, 16, 3), np.float32))


def test_the_pool_equals_the_per_call_pool(built, jpegs):
    pool = built.DecodePool(2)
    try:
        for batch in (jpegs[:2], jpegs[2:], jpegs):  # workers park and wake again
            np.testing.assert_array_equal(pool.run(batch, (32, 16)),
                                          built.decode_resize_batch(batch, (32, 16)))
    finally:
        pool.close()
    with pytest.raises(RuntimeError, match="closed"):
        pool.run(jpegs, (32, 16))


@pytest.mark.parametrize("backend", ["native", "auto"])
def test_batch_loader_decodes_with_it(built, jpegs, backend):
    records = [(p, i, 0, 0, i) for i, p in enumerate(jpegs)]
    loader = BatchLoader(records, batch_size=3, size_hw=(64, 32), backend=backend)
    assert loader._native
    got = list(loader)
    assert len(got) == 2 and got[1].n_valid == 1
    np.testing.assert_array_equal(got[0].images, built.decode_resize_batch(jpegs[:3], (64, 32)))
    pil = next(iter(BatchLoader(records, batch_size=3, size_hw=(64, 32), backend="pil")))
    assert np.abs(got[0].images.astype(np.float32) - pil.images.astype(np.float32)).mean() < 0.6
    # a host transform decodes with PIL, as in the JAX package
    assert not BatchLoader(records, 3, (64, 32), transform=lambda im: im.astype(np.float32),
                           backend=backend)._native
