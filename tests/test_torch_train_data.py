"""The port's train-time data path and guard: the deterministic part of
train_batch fed the JAX function's own random draws (reproduced with the
same jax.random.splits as tpu_reid/data/transforms.py), the PK sampler's
orders, and TrainGuard's rollback through run_stage2's loss pipeline."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_reid_model import tiny_models
from tests.test_torch_trainer_stage1 import fixed_batches
from tpu_reid.data.sampler import PKSampler as JPK
from tpu_reid.data.transforms import DevicePreprocess as JPre
from tpu_reid_torch.data.sampler import PKSampler as TPK
from tpu_reid_torch.data.transforms import DevicePreprocess as TPre
from tpu_reid_torch.runtime.guard import GuardTripped, TrainGuard
from tpu_reid_torch.train import optim as TO
from tpu_reid_torch.train import trainer as TTR


def jax_draws(key, b, hw, pad_hw, prob, dtype):
    """The draws of tpu_reid's train_batch / random_erasing, from the same
    key splits, as the port's draw dict."""
    k_flip, k_top, k_left, k_er = jax.random.split(key, 4)
    pv, ph = pad_hw
    k_apply, k_area, k_ar, k_top2, k_left2, k_noise = jax.random.split(k_er, 6)
    d = {
        "flip": jax.random.bernoulli(k_flip, 0.5, (b,)),
        "top": jax.random.randint(k_top, (b,), 0, 2 * pv + 1),
        "left": jax.random.randint(k_left, (b,), 0, 2 * ph + 1),
        "apply": jax.random.bernoulli(k_apply, prob, (b,)),
        "area": jax.random.uniform(k_area, (b,), minval=0.02, maxval=1 / 3),
        "log_ar": jax.random.uniform(k_ar, (b,), minval=jnp.log(0.3), maxval=jnp.log(10 / 3)),
        "top_u": jax.random.uniform(k_top2, (b,)),
        "left_u": jax.random.uniform(k_left2, (b,)),
        "noise": jax.random.normal(k_noise, (b, *hw, 3), dtype),
    }
    return {k: torch.from_numpy(np.asarray(v.astype(jnp.float32) if v.dtype == jnp.bfloat16
                                           else v).copy()) for k, v in d.items()}


@pytest.mark.parametrize("prob", [0.5, 1.0])
@pytest.mark.parametrize("src_hw", [(32, 16), (40, 20)])
def test_train_batch_matches_jax_on_its_draws(prob, src_hw):
    hw, pad = (32, 16), (10, 10)
    images = np.random.RandomState(1).randint(0, 256, (8, *src_hw, 3)).astype(np.uint8)
    key = jax.random.key(7)
    want = JPre(hw, "vit", dtype=jnp.float32).train_batch(jnp.asarray(images), key,
                                                          pad_hw=pad, erasing_prob=prob)
    draws = jax_draws(key, 8, hw, pad, prob, jnp.float32)
    got = TPre(hw, "vit", dtype=torch.float32).train_batch(torch.from_numpy(images), draws,
                                                           pad_hw=pad)
    assert got.dtype == torch.float32 and tuple(got.shape) == (8, *hw, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    if prob == 1.0:  # every image got a rectangle of noise
        assert bool(draws["apply"].all())


def test_train_draws_are_seeded_and_in_range():
    pp = TPre((32, 16), "vit", dtype=torch.bfloat16)
    a = pp.train_draws(torch.Generator().manual_seed(3), 64)
    b = pp.train_draws(torch.Generator().manual_seed(3), 64)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert int(a["top"].min()) >= 0 and int(a["top"].max()) <= 20
    assert 0.02 <= float(a["area"].min()) and float(a["area"].max()) <= 1 / 3
    assert math.log(0.3) <= float(a["log_ar"].min()) <= float(a["log_ar"].max()) <= math.log(
        10 / 3)
    assert a["noise"].dtype == torch.bfloat16 and tuple(a["noise"].shape) == (64, 32, 16, 3)
    images = torch.randint(0, 256, (64, 32, 16, 3), dtype=torch.uint8)
    out = pp.train_batch(images, a)
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()


def test_pk_sampler_gives_the_same_orders():
    labels = np.repeat(np.arange(9), [5, 3, 8, 4, 4, 2, 6, 4, 9])
    for seed in (0, 3):
        j, t = JPK(labels, 16, 4, seed=seed), TPK(labels, 16, 4, seed=seed)
        for _ in range(2):  # two epochs: the generator state carries over
            jb, tb = list(j.epoch()), list(t.epoch())
            assert len(jb) == len(tb) > 0
            for x, y in zip(jb, tb):
                np.testing.assert_array_equal(x, y)
        assert t.batches_per_epoch() == j.batches_per_epoch()
    with pytest.raises(ValueError):
        TPK(labels[:5], 16, 4)


def test_guard_rolls_back_a_diverged_stage2_step():
    """A batch whose loss is NaN is rolled back and skipped: the run equals
    one that never saw it, bit for bit (parameters, BN statistics)."""
    _, _, tcfg, tp = tiny_models("coop")
    b0, b1 = fixed_batches(seed=2)
    bad = (np.full_like(b0[0], np.nan), b0[1], b0[2])
    guard = TrainGuard(snapshot_every=1, max_restores=1, log=lambda s: None)
    with_bad = TTR.run_stage2(tp, tcfg, TTR.TrainConfig(), lambda e: iter([b0, bad, b1]),
                              epochs=1, guard=guard, log=lambda s: None)
    clean = TTR.run_stage2(tp, tcfg, TTR.TrainConfig(), lambda e: iter([b0, b1]), epochs=1,
                           log=lambda s: None)
    assert guard.restores == 1 and guard.events[0]["restored_to"] == 1
    for (path, a), (_, b) in zip(TO.paths(with_bad), TO.paths(clean)):
        assert torch.equal(a, b), path


def test_guard_budget_and_snapshot_cadence():
    guard = TrainGuard(snapshot_every=2, max_restores=1, log=lambda s: None)
    w = {"w": torch.ones(3)}
    guard.maybe_snapshot(0, w)
    w["w"].add_(1.0)
    assert not guard.will_snapshot(1) and guard.will_snapshot(2)
    (state,), ok = guard.check(float("nan"), w)
    assert not ok and torch.equal(state["w"], torch.ones(3))
    assert guard.check(1.0, w)[1]
    with pytest.raises(GuardTripped):
        guard.check(float("inf"), w)
