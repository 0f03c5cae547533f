"""Mid-stage resume of the port's trainers and prompt-learning CLI through
files on disk (runtime/checkpoint.py), the counterparts of the resume cases
of tests/test_trainer.py: a run stopped after epoch k, restored by
two_stage_resume and resumed equals the uninterrupted run bit for bit (live
ivlp stage 1, promptsrc stage 1 with its GPA sum, stage 2, the CLI's
--resume). The cached coop stage 1 restarts its permutation stream on
resume, as the JAX package's does; that is held against JAX."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_prompt_cli import _argv, assets  # noqa: F401  (fixture)
from tests.test_torch_reid_model import tiny_models
from tests.test_torch_trainer_stage1 import (
    adam_bound, compare_leaves, epoch_losses, fixed_batches,
)
from tpu_reid_torch.cli import prompt_learning as TCLI
from tpu_reid_torch.runtime import checkpoint as C
from tpu_reid_torch.train import optim as TO
from tpu_reid_torch.train import trainer as TTR

EPOCHS = 4


class Interrupt(Exception):
    pass


def assert_trees_equal(got, want):
    for (pg, g), (pw, w) in zip(TO.paths(got), TO.paths(want), strict=True):
        assert pg == pw
        assert torch.equal(g, w), (pg, float((g.float() - w.float()).abs().max()))


def resumed_run(tmp_path, run, params, stage, stop_after, leaf_order, gpa_used, **kw):
    """run(params, checkpoint_cb=..., **kwargs) stopped after epoch
    `stop_after` (its checkpoint written through two_stage_cb), then
    restored from disk and run to the end."""
    mgr = C.CheckpointManager(str(tmp_path), save_interval=1, max_to_keep=1)
    save = C.two_stage_cb(mgr, stage, lambda e: 100 * stage + e)

    def cb(e, p, state):
        save(e, p, state)
        if e == stop_after:
            raise Interrupt

    with pytest.raises(Interrupt):
        run(params, checkpoint_cb=cb, **kw)
    restored, done, kw1, kw2 = C.two_stage_resume(
        mgr, params, leaf_order, leaf_order, gpa_used, gpa_used, log=print)
    mgr.close()
    assert done == stage
    resume_kw = kw1 if stage == 0 else kw2
    assert resume_kw["start_epoch"] == stop_after + 1
    assert (resume_kw["init_gpa"] is not None) == gpa_used
    return run(restored, **resume_kw, **kw)


@pytest.mark.parametrize("mode", ["ivlp", "promptsrc"])
def test_stage1_live_resume_equals_the_straight_run(tmp_path, mode):
    """ivlp, and promptsrc whose GPA sum must carry across: 4 epochs of 2
    batches, stopped after epoch 2."""
    _, _, tcfg, tp = tiny_models(mode)
    batches = {e: fixed_batches(seed=200 + e) for e in range(1, EPOCHS + 1)}

    def run(params, **kw):
        return TTR.run_stage1(params, tcfg, TTR.TrainConfig(), lambda e: iter(batches[e]),
                              epochs=EPOCHS, batch_size=8, log=lambda s: None, **kw)

    want = run(tp)
    got = resumed_run(tmp_path, run, tp, 0, 2, lambda p: TTR.stage1_leaf_order(p, tcfg),
                      mode == "promptsrc")
    assert_trees_equal(got, want)


def test_stage2_resume_equals_the_straight_run(tmp_path):
    """coop stage 2, 4 epochs of 2 batches stopped after epoch 1: the Adam
    moments and the BNNeck statistics carry the trajectory."""
    _, _, tcfg, tp = tiny_models("coop")
    batches = {e: fixed_batches(seed=100 + e) for e in range(EPOCHS)}

    def run(params, **kw):
        return TTR.run_stage2(params, tcfg, TTR.TrainConfig(), lambda e: iter(batches[e]),
                              epochs=EPOCHS, log=lambda s: None, **kw)

    want = run(tp)
    got = resumed_run(tmp_path, run, tp, 1, 1, lambda p: TTR.stage2_leaf_order(p, tcfg),
                      False)
    assert_trees_equal(got, want)


def test_resume_refuses_another_leaf_order(tmp_path):
    """A checkpoint of a promptsrc stage 1 restored by a run whose stage-1
    optimizer trains other leaves (coop's): the moments would land on the
    wrong leaves, so the restore raises."""
    _, _, tcfg, tp = tiny_models("ivlp")
    _, _, ccfg, _ = tiny_models("coop")
    mgr = C.CheckpointManager(str(tmp_path), save_interval=1)
    TTR.run_stage1(tp, tcfg, TTR.TrainConfig(), lambda e: iter(fixed_batches(n_batches=1)),
                   epochs=1, log=lambda s: None,
                   checkpoint_cb=C.two_stage_cb(mgr, 0, lambda e: e))
    with pytest.raises(ValueError, match="other leaves"):
        C.two_stage_resume(mgr, tp, lambda p: TTR.stage1_leaf_order(p, ccfg), None,
                           False, False)
    mgr.close()


def test_cached_stage1_resume_restarts_the_permutation_as_jax():
    """The cached coop path draws every epoch's order from one generator
    seeded when run_stage1 starts, in both packages: a run started at epoch
    2 takes the first permutation again. The port's resumed run (fresh
    optimizer, start_epoch=2) against the JAX package's, 20 cached features
    in batches of 8 (a padded tail): per-epoch losses and trained leaves."""
    from tpu_reid.models import reid_clip as JM
    from tpu_reid.train import trainer as JTR
    from tpu_reid_torch.models import reid_clip as TM

    jcfg, jp, tcfg, tp = tiny_models("coop")
    rng = np.random.RandomState(3)
    images = rng.randn(20, 32, 16, 3).astype(np.float32)
    labels = np.repeat(np.arange(5), 4)
    batches = [(images[i:i + 8], labels[i:i + 8], np.ones(len(labels[i:i + 8]), bool))
               for i in range(0, 20, 8)]
    batches[-1] = tuple(np.concatenate([a, np.zeros((4,) + a.shape[1:], a.dtype)])
                        for a in batches[-1][:2]) + (np.arange(8) < 4,)
    jlog, tlog = [], []
    jout = JTR.run_stage1(jp, jcfg, JTR.TrainConfig(), lambda e: iter(
        [(jnp.asarray(i), jnp.asarray(lab), v) for i, lab, v in batches]), epochs=3,
        batch_size=8, log=jlog.append, start_epoch=2)
    tout = TTR.run_stage1(tp, tcfg, TTR.TrainConfig(), lambda e: iter(batches), epochs=3,
                          batch_size=8, log=tlog.append, start_epoch=2)
    jl, tl = epoch_losses(jlog, "stage1"), epoch_losses(tlog, "stage1")
    assert len(tl) == len(jl) == 2
    np.testing.assert_allclose(tl, jl, atol=2e-4)
    lrs = [TTR.S.cosine_warmup_lr(e, 3.5e-4, 3) for e in (2, 3) for _ in range(3)]
    compare_leaves(tout, jout, (lambda p: JM.stage1_trainable(p, jcfg),
                                lambda p: TM.stage1_trainable(p, tcfg)), adam_bound(lrs))


def test_cli_resume_mid_stage_equals_the_straight_run(assets, monkeypatch, capsys,  # noqa: F811
                                                      tmp_path):
    """The prompt-learning CLI (ivlp, 1 + 2 epochs, --device cpu): a run
    interrupted after stage-2 epoch 0 (a checkpoint every epoch), then
    --resume, ends with the metrics of an uninterrupted run."""
    extra = ("--training_mode", "ivlp", "--epochs_stage1", "1", "--epochs_stage2", "2",
             "--device", "cpu")
    cmc, mAP = TCLI.main(_argv(assets, tmp_path / "straight", *extra))

    real_mgr, real_cb = C.CheckpointManager, C.two_stage_cb

    class EveryEpoch(real_mgr):
        def __init__(self, directory, max_to_keep=3, save_interval=20, mesh=None):
            super().__init__(directory, max_to_keep, save_interval=1, mesh=mesh)

    def stop_after_stage2_epoch0(mgr, stage, step_of):
        save = real_cb(mgr, stage, step_of)

        def cb(e, p, state):
            save(e, p, state)
            if stage == 1 and e == 0:
                raise Interrupt

        return cb

    monkeypatch.setattr(C, "CheckpointManager", EveryEpoch)
    monkeypatch.setattr(C, "two_stage_cb", stop_after_stage2_epoch0)
    with pytest.raises(Interrupt):
        TCLI.main(_argv(assets, tmp_path / "cut", *extra))
    monkeypatch.setattr(C, "CheckpointManager", real_mgr)
    monkeypatch.setattr(C, "two_stage_cb", real_cb)
    capsys.readouterr()
    cmc2, mAP2 = TCLI.main(_argv(assets, tmp_path / "cut", *extra, "--resume"))
    out = capsys.readouterr().out
    assert "[resume] stage=1 epoch=1" in out  # stage-2 epoch 0 = global step 1
    assert "[stage1] epoch" not in out and "[stage2] epoch 2/2" in out
    assert "[stage2] epoch 1/2" not in out
    assert mAP2 == mAP
    np.testing.assert_array_equal(cmc2, cmc)
