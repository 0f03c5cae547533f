"""MaPLe training in the port against the JAX package's on the tiny model of
tests/test_torch_variant_models.py and the fixed batches of
tests/test_torch_trainer_stage1.py (2 epochs of 2 batches of 8, fp32): the
live stage 1, in which the couplings, the shared context and the deeper
text prompts train through the block Function's plane gradient, and stage
2, in which they stay frozen: per-epoch losses and the trained leaves within
the Adam bound. Then a mid-stage resume of MaPLe's stage 1 through files on
disk equals the straight run."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_resume import assert_trees_equal, resumed_run
from tests.test_torch_trainer_stage1 import (
    EPOCHS, adam_bound, compare_leaves, epoch_losses, fixed_batches,
)
from tests.test_torch_variant_models import variant_models
from tpu_reid.models import reid_clip as JM
from tpu_reid.train import trainer as JTR
from tpu_reid_torch.models import reid_clip as TM
from tpu_reid_torch.train import trainer as TTR


@pytest.fixture(scope="module")
def maple():
    return variant_models(mode="maple")


def _jax_batches(batches):
    return lambda e: iter([(jnp.asarray(i), jnp.asarray(lab), v) for i, lab, v in batches])


@pytest.fixture(scope="module")
def stage1(maple):
    jcfg, jp, tcfg, tp = maple
    batches = fixed_batches()
    jlog, tlog = [], []
    jout = JTR.run_stage1(jp, jcfg, JTR.TrainConfig(), _jax_batches(batches), epochs=EPOCHS,
                          batch_size=8, log=jlog.append)
    tout = TTR.run_stage1(tp, tcfg, TTR.TrainConfig(), lambda e: iter(batches), epochs=EPOCHS,
                          batch_size=8, log=tlog.append)
    return jout, tout, jlog, tlog


@pytest.fixture(scope="module")
def stage2(maple):
    jcfg, jp, tcfg, tp = maple
    batches = fixed_batches(seed=1)
    jlog, tlog = [], []
    jout = JTR.run_stage2(jp, jcfg, JTR.TrainConfig(), _jax_batches(batches), epochs=EPOCHS,
                          log=jlog.append)
    tout = TTR.run_stage2(tp, tcfg, TTR.TrainConfig(), lambda e: iter(batches), epochs=EPOCHS,
                          log=tlog.append)
    return jout, tout, jlog, tlog


@pytest.mark.parametrize("stage", ["stage1", "stage2"])
def test_maple_losses_match_jax(request, stage):
    *_, jlog, tlog = request.getfixturevalue(stage)
    jl, tl = epoch_losses(jlog, stage), epoch_losses(tlog, stage)
    assert len(tl) == len(jl) == EPOCHS and all(np.isfinite(tl))
    np.testing.assert_allclose(tl, jl, atol=2e-4)  # both logged to 4 decimals


def test_maple_stage1_trains_the_couplings_as_jax(maple, stage1):
    jcfg, jp, tcfg, tp = maple
    jout, tout, *_ = stage1
    lrs = [TTR.S.cosine_warmup_lr(e, 3.5e-4, EPOCHS) for e in range(1, EPOCHS + 1)]
    compare_leaves(tout, jout, (lambda p: JM.stage1_trainable(p, jcfg),
                                lambda p: TM.stage1_trainable(p, tcfg)),
                   adam_bound([lr for lr in lrs for _ in range(2)]))
    for path in (("proj", "w"), ("proj", "b"), ("shared_ctx",), ("text_deep",)):
        got, before = tout["maple"], tp["maple"]
        for k in path:
            got, before = got[k], before[k]
        assert not torch.allclose(got, before), path  # every coupling leaf moved
    # the tower-level vision token of a MaPLe design is no trained leaf
    assert tout["clip"]["visual"]["vpt_shallow"] is tp["clip"]["visual"]["vpt_shallow"]


def test_maple_stage2_freezes_the_couplings_as_jax(maple, stage2):
    jcfg, jp, tcfg, tp = maple
    jout, tout, *_ = stage2
    lrs = [TTR.S.warmup_multistep_lr(e, 5e-6) for e in range(EPOCHS) for _ in range(2)]
    compare_leaves(tout, jout, (lambda p: JM.stage2_trainable(p, jcfg),
                                lambda p: TM.stage2_trainable(p, tcfg)),
                   adam_bound(lrs, mult=2.0))
    assert tout["maple"]["proj"]["w"] is tp["maple"]["proj"]["w"]
    for k in ("mean", "var"):
        np.testing.assert_allclose(tout["head"]["bn"][k].numpy(),
                                   np.asarray(jout["head"]["bn"][k]), atol=1e-5, rtol=1e-4)


def test_maple_stage1_resume_equals_the_straight_run(maple, tmp_path):
    """4 epochs of 2 batches stopped after epoch 2: the couplings' Adam
    moments come back from the checkpoint files in the leaf order."""
    _, _, tcfg, tp = maple
    batches = {e: fixed_batches(seed=300 + e) for e in range(1, 5)}

    def run(params, **kw):
        return TTR.run_stage1(params, tcfg, TTR.TrainConfig(), lambda e: iter(batches[e]),
                              epochs=4, batch_size=8, log=lambda s: None, **kw)

    order = TTR.stage1_leaf_order(tp, tcfg)
    assert [p for p in order if p.startswith("maple/")], order
    want = run(tp)
    got = resumed_run(tmp_path, run, tp, 0, 2, lambda p: TTR.stage1_leaf_order(p, tcfg), False)
    assert_trees_equal(got, want)
