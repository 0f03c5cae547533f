"""Sharded extraction of the port (parallel/extract.py with mesh=,
parallel/multihost.py) against the JAX package's 2-device extractor on its
virtual CPU devices and against the port's single-device sweep, on one tiny
random CLIP (width 64, 2 layers, 32x16, stride 8, fp32, flip-TTA, folded
input norm): two gloo ranks over global batches with a padded tail batch,
and the multi-host sweep with two "hosts" (processes) meeting at a TCP
address on localhost."""

import multiprocessing as mp
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_oracle as oracle
from tests import torch_dist_workers as W
from tpu_reid.data.transforms import DevicePreprocess as JPre
from tpu_reid.models.vit import fold_visual_input_norm as jfold
from tpu_reid.parallel import extract as JX
from tpu_reid.parallel.mesh import make_mesh
from tpu_reid.pipelines import zero_shot as JZ
from tpu_reid.tools import synth_market as SM
from tpu_reid.weights import convert as JW
from tpu_reid_torch.data.datasets import get_dataset
from tpu_reid_torch.data.loader import BatchLoader
from tpu_reid_torch.parallel import launch
from tpu_reid_torch.parallel.extract import extract_embeddings


@pytest.fixture(scope="module")
def model():
    return oracle.make_clip_state_dict(
        np.random.RandomState(1), vision_width=64, vision_layers=2, patch=8, grid=4,
        text_width=128, text_layers=2, vocab=520, context=77, embed_dim=32)


def jax_extractor(sd, mesh):
    cfg, params = JW.convert_clip(sd, image_hw=(32, 16), stride=8)
    fold = lambda p: dict(p, visual=jfold(p["visual"], "vit"))  # noqa: E731
    return params, JX.make_extractor(JZ.make_zeroshot_embed(params, cfg),
                                     JPre((32, 16), "vit", dtype=jnp.float32), mesh=mesh,
                                     flip_tta=True, dtype=jnp.float32, fold=fold)


@pytest.fixture(scope="module")
def sweeps(model):
    """Three global batches of 8 (the last with 5 real rows): the port on
    two gloo ranks, the port on one device, JAX on a 2-device mesh."""
    rng = np.random.RandomState(2)
    images = rng.randint(0, 255, (3, 8, 32, 16, 3)).astype(np.uint8)
    valid = np.ones((3, 8), bool)
    valid[2, 5:] = False
    images[2, 5:] = 0
    ranks = W.spawn(W.sharded_extraction, model, images, valid)
    params, ext = W.zero_shot_extractor(model, None)
    single = extract_embeddings(ext, params, W.host_batches(images, valid), device="cpu")
    mesh = make_mesh(n_data=2)
    jparams, jext = jax_extractor(model, mesh)
    jax = JX.extract_embeddings(jext, jparams, W.host_batches(images, valid), mesh=mesh)
    return ranks, single, jax


def test_two_ranks_match_jax_and_one_device(sweeps):
    """The features of every rank, in global batch order with the padded
    rows dropped: equal on both ranks, within 1e-4 of JAX's 2-device sweep
    and 1e-5 of the port's single-device sweep (the CPU matmul sums a batch
    of 4 rows in another order than one of 8)."""
    ranks, single, jax = sweeps
    assert ranks["same"]
    assert ranks["feats"].shape == (21, 64 + 32)
    np.testing.assert_allclose(ranks["feats"].numpy(), np.asarray(jax[0]), atol=1e-4)
    np.testing.assert_allclose(ranks["feats"].numpy(), single[0].numpy(), atol=1e-5)
    np.testing.assert_array_equal(ranks["pids"], single[1])
    np.testing.assert_array_equal(ranks["pids"], jax[1])
    np.testing.assert_array_equal(ranks["camids"], jax[2])


@pytest.fixture(scope="module")
def market(tmp_path_factory):
    root = tmp_path_factory.mktemp("mh_extract")
    SM.write_images(str(root / "Market1501"), np.random.RandomState(0), n_train_ids=2,
                    n_test_ids=5, n_query=10, n_gallery=30, hw=(64, 32))
    return get_dataset(str(root), "market1501")


def test_the_multihost_sweep_over_two_hosts(model, market, tmp_path):
    """Two host processes, one rank each, meet at a TCP address: each
    decodes only its rows of every global batch of 4 (30 gallery records:
    the last batch padded by wrap-around), and both end with the same
    features on their device, those of the single-device sweep (1e-5) and
    of JAX's sweep of the same records (1e-4), with the records' metadata."""
    records = market.gallery
    addr = f"127.0.0.1:{launch.free_port()}"
    ctx = mp.get_context("spawn")
    hosts = [ctx.Process(target=W.as_host, args=(W.multihost_extraction, addr, h, 2, model,
                                                  records, str(tmp_path)))
             for h in range(2)]
    for p in hosts:
        p.start()
    for p in hosts:
        p.join(timeout=300)
    assert [p.exitcode for p in hosts] == [0, 0]
    got = [torch.load(os.path.join(tmp_path, f"rank{r}.pt"), weights_only=False)
           for r in range(2)]
    for a, b in zip(got[0], got[1]):
        np.testing.assert_array_equal(a, b)
    params, ext = W.zero_shot_extractor(model, None)
    single = extract_embeddings(ext, params, BatchLoader(records, 4, (32, 16)), device="cpu")
    feats, pids, camids, seqids = got[0]
    assert isinstance(feats, torch.Tensor) and feats.shape == (30, 96)
    feats = feats.numpy()
    np.testing.assert_allclose(feats, single[0].numpy(), atol=1e-5)
    np.testing.assert_array_equal(pids, single[1])
    np.testing.assert_array_equal(camids, single[2])
    jparams, jext = jax_extractor(model, None)
    from tpu_reid.data.loader import BatchLoader as JLoader

    jax = JX.extract_embeddings(jext, jparams, JLoader(records, 4, (32, 16)))
    np.testing.assert_allclose(feats, np.asarray(jax[0]), atol=1e-4)
