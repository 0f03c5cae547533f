"""The port's DeviceImageCache (tpu_reid_torch/data/device_cache.py) on the
CPU: its gathers equal the port's BatchLoader rows on a PK and on the
sequential order (valid rows, pids, camids and valid bit-equal), after
tests/test_data.py's cache case; its gathers and epoch_index_batches equal
the JAX package's DeviceImageCache on the same directory; a mesh that is not
the port's is refused, the port's shards the cache; nbytes counts the
resident split."""

import numpy as np
import pytest
import torch

from tpu_reid.data.datasets import load_market1501 as j_load_market
from tpu_reid.data.device_cache import DeviceImageCache as JCache
from tpu_reid.tools import synth_market as SM
from tpu_reid_torch.data.datasets import load_market1501
from tpu_reid_torch.data.device_cache import DeviceImageCache
from tpu_reid_torch.data.loader import BatchLoader
from tpu_reid_torch.data.sampler import PKSampler

HW = (32, 16)


@pytest.fixture(scope="module")
def market(tmp_path_factory):
    root = tmp_path_factory.mktemp("cache")
    SM.write_images(str(root / "Market1501"), np.random.RandomState(0), n_train_ids=5,
                    n_test_ids=2, n_query=2, n_gallery=4, hw=(64, 32))
    return str(root)


@pytest.fixture(scope="module")
def cache(market):
    ds = load_market1501(market)
    return ds, DeviceImageCache(ds.train, HW, chunk=7, device="cpu")


def test_cache_holds_the_split(cache):
    ds, c = cache
    assert c.n == len(ds.train) == 85 and c.images.device.type == "cpu"
    assert tuple(c.images.shape) == (85, *HW, 3) and c.images.dtype == torch.uint8
    assert c.nbytes() == 85 * HW[0] * HW[1] * 3 == c.images.numel()
    np.testing.assert_array_equal(c.pids, [r[1] for r in ds.train])
    np.testing.assert_array_equal(c.camids, [r[2] for r in ds.train])


def test_pk_batches_match_the_loader(cache):
    ds, c = cache
    order = list(PKSampler([r[1] for r in ds.train], 8, 4, seed=3).epoch())
    host = list(BatchLoader(ds.train, 8, HW, order=iter(order)))
    dev = list(c.epoch_index_batches(order, 8))
    assert len(host) == len(dev) > 0
    for hb, (sel, pids, camids, valid) in zip(host, dev):
        np.testing.assert_array_equal(hb.valid, valid)
        np.testing.assert_array_equal(hb.pids, pids)
        np.testing.assert_array_equal(hb.camids, camids)
        np.testing.assert_array_equal(hb.images[valid], c.gather(sel).numpy()[valid])


@pytest.mark.parametrize("drop_tail", [False, True])
def test_sequential_batches_match_the_loader(cache, drop_tail):
    """The sequential (epoch-0) order in batches of 6: the tail of 1 row is
    padded (zero pids and camids, valid False) or dropped, as the loader."""
    ds, c = cache
    host = list(BatchLoader(ds.train, 6, HW, drop_tail=drop_tail))
    dev = list(c.epoch_index_batches(np.arange(c.n), 6, drop_tail=drop_tail))
    assert len(host) == len(dev) == (14 if drop_tail else 15)
    for hb, (sel, pids, camids, valid) in zip(host, dev):
        np.testing.assert_array_equal(hb.valid, valid)
        np.testing.assert_array_equal(hb.pids, pids)
        np.testing.assert_array_equal(hb.camids, camids)
        np.testing.assert_array_equal(hb.images[valid], c.gather(sel).numpy()[valid])
    if not drop_tail:
        assert not dev[-1][3][1:].any() and not dev[-1][1][1:].any()


def test_gathers_and_orders_match_jax(market, cache):
    """The same directory through both packages' caches: the resident split,
    every index batch of a PK and of a shuffled order, and their gathers
    (the gather takes a numpy row or a tensor). Both decode with the same
    decoder (the native one, one C++ source, where it builds)."""
    ds, c = cache
    jc = JCache(j_load_market(market).train, HW, chunk=9)
    np.testing.assert_array_equal(c.images.numpy(), np.asarray(jc.images))
    np.testing.assert_array_equal(c.pids, jc.pids)
    np.testing.assert_array_equal(c.camids, jc.camids)
    assert c.nbytes() == jc.nbytes()
    pk = list(PKSampler([r[1] for r in ds.train], 8, 4, seed=5).epoch())
    shuffled = np.random.default_rng(2).permutation(c.n)
    for order, bs, drop in ((pk, 8, False), (shuffled, 16, False), (shuffled, 16, True)):
        got = list(c.epoch_index_batches(order, bs, drop_tail=drop))
        want = list(jc.epoch_index_batches(order, bs, drop_tail=drop))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(c.gather(torch.from_numpy(g[0])).numpy(),
                                          np.asarray(jc.gather(w[0])))


def test_mesh_is_refused(market, tmp_path):
    """A mesh that is not the port's (a JAX Mesh, any object) is refused; the
    port's mesh shards the cache: in a world of one rank it holds the whole
    split and gathers the single-device rows bit for bit
    (tests/test_torch_sharded_training.py holds two ranks)."""
    from tpu_reid_torch.parallel import launch

    ds = load_market1501(market)
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        DeviceImageCache(ds.train, HW, mesh=object(), device="cpu")
    single = DeviceImageCache(ds.train, HW, device="cpu")
    sel = np.arange(len(ds.train))[::-3][:8].copy()
    with launch.process_group("cpu", f"file://{tmp_path}/rdv", 0, 1) as mesh:
        sharded = DeviceImageCache(ds.train, HW, mesh=mesh)
        assert sharded.n_local == single.n and sharded.nbytes() == single.nbytes()
        assert torch.equal(sharded.gather(sel), single.gather(sel))


def test_cache_defaults_to_the_card(market, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceImageCache(load_market1501(market).train, HW)


def test_transform_constants_are_made_once():
    """The normalisation constants and the resize weights are made once per
    (size, device) and reused, as a captured step may copy nothing from the
    host: two calls return the same tensor object, with unchanged values."""
    from tpu_reid_torch.data import transforms as T

    a, b = T.cubic_weight_mat(64, 32, "cpu"), T.cubic_weight_mat(64, 32, "cpu")
    assert a is b and a is T.cubic_weight_mat(64, 32)
    assert T.cubic_weight_mat(32, 16) is not a
    torch.testing.assert_close(a, T._cubic_weight_mat(64, 32), rtol=0, atol=0)
    (m1, s1), (m2, s2) = T.norm_constants("vit", "cpu"), T.norm_constants("vit")
    assert m1 is m2 and s1 is s2 and T.norm_constants("rn")[0] is not m1
    assert m1.tolist() == [0.5, 0.5, 0.5] and T.norm_constants("rn")[1].dtype == torch.float32
