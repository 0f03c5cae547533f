"""JPM and SIE training in the port against the JAX package's on the tiny
models of tests/test_torch_variant_models.py and the fixed batches of
tests/test_torch_trainer_stage1.py (2 epochs of 2 batches of 8, fp32), the
SIE batches carrying camera ids as a 4th element (some beyond the table,
clipped by both packages): stage 2 with JPM (four levels in the loss, the
JPM BNNeck's running statistics threaded as state), with SIE, and with both
(adapter mode); the cached coop stage 1 with SIE. Per-epoch losses and the
trained leaves within the Adam bound."""

import jax.numpy as jnp
import numpy as np
import pytest

from tests.test_torch_trainer_stage1 import (
    EPOCHS, adam_bound, compare_leaves, epoch_losses, fixed_batches,
)
from tests.test_torch_variant_models import VARIANTS, variant_models
from tpu_reid.models import reid_clip as JM
from tpu_reid.train import trainer as JTR
from tpu_reid_torch.models import reid_clip as TM
from tpu_reid_torch.train import trainer as TTR


def with_camera_ids(batches, sie_ids, seed):
    rng = np.random.RandomState(seed)
    return [(i, lab, v, rng.randint(0, sie_ids + 2, len(lab)).astype(np.int32))
            for i, lab, v in batches]


def _jax_batches(batches):
    return lambda e: iter([(jnp.asarray(b[0]), jnp.asarray(b[1]), b[2],
                            *(jnp.asarray(c) for c in b[3:])) for b in batches])


@pytest.fixture(scope="module", params=["jpm", "sie", "jpm_sie"])
def stage2(request):
    jcfg, jp, tcfg, tp = variant_models(**VARIANTS[request.param])
    batches = fixed_batches(seed=1)
    if tcfg.sie_ids:
        batches = with_camera_ids(batches, tcfg.sie_ids, seed=2)
    jlog, tlog = [], []
    jout = JTR.run_stage2(jp, jcfg, JTR.TrainConfig(), _jax_batches(batches), epochs=EPOCHS,
                          log=jlog.append)
    tout = TTR.run_stage2(tp, tcfg, TTR.TrainConfig(), lambda e: iter(batches), epochs=EPOCHS,
                          log=tlog.append)
    return jcfg, jp, jout, tcfg, tp, tout, jlog, tlog


def test_stage2_losses_match_jax(stage2):
    *_, jlog, tlog = stage2
    jl, tl = epoch_losses(jlog, "stage2"), epoch_losses(tlog, "stage2")
    assert len(tl) == len(jl) == EPOCHS and all(np.isfinite(tl))
    np.testing.assert_allclose(tl, jl, atol=2e-4)  # both logged to 4 decimals


def test_stage2_trained_leaves_and_bn_state_match_jax(stage2):
    jcfg, jp, jout, tcfg, tp, tout, *_ = stage2
    lrs = [TTR.S.warmup_multistep_lr(e, 5e-6) for e in range(EPOCHS) for _ in range(2)]
    compare_leaves(tout, jout, (lambda p: JM.stage2_trainable(p, jcfg),
                                lambda p: TM.stage2_trainable(p, tcfg)),
                   adam_bound(lrs, mult=2.0))
    heads = [("head", "bn"), ("head", "bn_proj")]
    if tcfg.use_jpm:
        heads.append(("jpm_head", "bn"))
    for top, name in heads:
        got, want, before = tout[top][name], jout[top][name], tp[top][name]
        for k in ("mean", "var"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-5,
                                       rtol=1e-4)
        assert not np.allclose(got["mean"].numpy(), before["mean"].numpy())
        np.testing.assert_array_equal(got["bias"].numpy(), 0)
    if tcfg.sie_ids:
        assert not np.allclose(tout["sie_embed"].numpy(), tp["sie_embed"].numpy())


def test_stage2_without_camera_ids_is_refused():
    _, _, tcfg, tp = variant_models(**VARIANTS["sie"])
    with pytest.raises(ValueError, match="camera ids"):
        TTR.run_stage2(tp, tcfg, TTR.TrainConfig(), lambda e: iter(fixed_batches(n_batches=1)),
                       epochs=1, log=lambda s: None)


def test_cached_stage1_with_sie_matches_jax():
    """coop's cached stage 1: the frozen encoder's sweep adds each image's
    camera embedding at its initial value, then the text side trains."""
    jcfg, jp, tcfg, tp = variant_models(**VARIANTS["sie"])
    batches = with_camera_ids(fixed_batches(), tcfg.sie_ids, seed=3)
    jlog, tlog = [], []
    jout = JTR.run_stage1(jp, jcfg, JTR.TrainConfig(), _jax_batches(batches), epochs=EPOCHS,
                          batch_size=8, log=jlog.append)
    tout = TTR.run_stage1(tp, tcfg, TTR.TrainConfig(), lambda e: iter(batches), epochs=EPOCHS,
                          batch_size=8, log=tlog.append)
    jl, tl = epoch_losses(jlog, "stage1"), epoch_losses(tlog, "stage1")
    assert len(tl) == len(jl) == EPOCHS
    np.testing.assert_allclose(tl, jl, atol=2e-4)
    lrs = [TTR.S.cosine_warmup_lr(e, 3.5e-4, EPOCHS) for e in range(1, EPOCHS + 1)]
    compare_leaves(tout, jout, (lambda p: JM.stage1_trainable(p, jcfg),
                                lambda p: TM.stage1_trainable(p, tcfg)),
                   adam_bound([lr for lr in lrs for _ in range(2)]))
    # the SIE table stays at its initial value in stage 1
    assert tout["sie_embed"] is tp["sie_embed"]
    # the camera ids reach the cached features: without them they differ
    f_ids = TTR.precompute_image_features(tp, tcfg, iter(batches[:1]))[0]
    f_zero = TTR.precompute_image_features(tp, tcfg, iter(
        [b[:3] + (np.zeros_like(b[3]),) for b in batches[:1]]))[0]
    assert float((f_ids - f_zero).abs().max()) > 1e-4
