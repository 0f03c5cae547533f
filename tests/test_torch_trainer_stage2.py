"""run_stage2 of the port against the JAX package's on the same tiny model
and the same fixed batches: ivlp, and promptsrc (distillation + GPA), 2
epochs of 2 batches of 8, fp32: per-epoch losses, the trained leaves within
the Adam bound of tests/test_torch_trainer_stage1.py, and the BNNeck running
statistics threaded as state."""

import jax.numpy as jnp
import numpy as np
import pytest

from tests.test_torch_reid_model import tiny_models
from tests.test_torch_trainer_stage1 import (
    EPOCHS, adam_bound, compare_leaves, epoch_losses, fixed_batches,
)
from tpu_reid.train import trainer as JTR
from tpu_reid_torch.train import trainer as TTR


@pytest.fixture(scope="module", params=["ivlp", "promptsrc"])
def stage2(request):
    mode = request.param
    jcfg, jp, tcfg, tp = tiny_models(mode)
    batches = fixed_batches(seed=1)
    jlog, tlog = [], []
    jout = JTR.run_stage2(jp, jcfg, JTR.TrainConfig(), lambda e: iter(
        [(jnp.asarray(i), jnp.asarray(lab), v) for i, lab, v in batches]), epochs=EPOCHS,
        log=jlog.append)
    tout = TTR.run_stage2(tp, tcfg, TTR.TrainConfig(), lambda e: iter(batches), epochs=EPOCHS,
                          log=tlog.append)
    return mode, jcfg, jp, jout, tcfg, tp, tout, jlog, tlog


def test_stage2_losses_match_jax(stage2):
    *_, jlog, tlog = stage2
    jl, tl = epoch_losses(jlog, "stage2"), epoch_losses(tlog, "stage2")
    assert len(tl) == len(jl) == EPOCHS and all(np.isfinite(tl))
    np.testing.assert_allclose(tl, jl, atol=2e-4)  # both logged to 4 decimals


def test_stage2_trained_leaves_and_bn_state_match_jax(stage2):
    mode, jcfg, jp, jout, tcfg, tp, tout, *_ = stage2
    from tpu_reid.models import reid_clip as JM
    from tpu_reid_torch.models import reid_clip as TM

    lrs = [TTR.S.warmup_multistep_lr(e, 5e-6) for e in range(EPOCHS) for _ in range(2)]
    compare_leaves(tout, jout, (lambda p: JM.stage2_trainable(p, jcfg),
                                lambda p: TM.stage2_trainable(p, tcfg)),
                   adam_bound(lrs, mult=2.0))  # the bias group runs at 2x lr
    for name in ("bn", "bn_proj"):
        for k in ("mean", "var"):
            np.testing.assert_allclose(tout["head"][name][k].numpy(),
                                       np.asarray(jout["head"][name][k]), atol=1e-5, rtol=1e-4)
        assert not np.allclose(tout["head"][name]["mean"].numpy(),
                               tp["head"][name]["mean"].numpy())
        np.testing.assert_array_equal(tout["head"][name]["bias"].numpy(), 0)
    # frozen leaves: the input itself, or (promptsrc's GPA output) the
    # gauss-weighted sum of it, equal to rounding
    for frozen in (("prompt_learner", "cls_ctx"), ("zs_visual", "proj")):
        if frozen[0] in tp:
            got, want = tout[frozen[0]][frozen[1]], tp[frozen[0]][frozen[1]]
            if mode == "promptsrc":
                np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-7)
            else:
                assert got is want
