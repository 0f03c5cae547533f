"""Data-parallel training of the port over two gloo ranks (spawned once for
the module) against the JAX package's mesh paths on a 2-device mesh of its
virtual CPU devices and against the port's single-device runs, on the tiny
models of tests/test_torch_reid_model.py and tests/test_torch_multitask.py
carried across from JAX's initialisation: run_stage1 (coop: the sharded
feature precompute and the sharded text side; ivlp: the live encoder) and
run_stage2 (ivlp), 2 epochs of 2 batches of 8, fp32; a stage-2 epoch whose
second batch has a NaN image on rank 1's rows, which both ranks roll back;
the sharded DeviceImageCache's gathers; run_mt_stage1 / run_mt_stage2 over
one batch of each task. Trained leaves within the Adam bound of
tests/test_torch_trainer_stage1.py (median |d| <= 1e-6), and every rank's
leaves bit-identical after every run."""

import jax.numpy as jnp
import numpy as np
import pytest

from tests import torch_dist_workers as W
from tests.test_torch_multitask import HW1, _j, task_batch, tiny_mt
from tests.test_torch_reid_model import tiny_models
from tests.test_torch_trainer_stage1 import adam_bound, compare_leaves, fixed_batches
from tpu_reid.parallel.mesh import make_mesh
from tpu_reid.tools import synth_market as SM
from tpu_reid.train import multitask as JMT
from tpu_reid.train import trainer as JTR
from tpu_reid_torch.data.datasets import get_dataset
from tpu_reid_torch.data.device_cache import DeviceImageCache
from tpu_reid_torch.models import reid_clip as TM
from tpu_reid_torch.runtime.guard import TrainGuard
from tpu_reid_torch.train import multitask as TMT
from tpu_reid_torch.train import optim as TO
from tpu_reid_torch.train import trainer as TTR

EPOCHS = 2


def _jax_batches(batches):
    return lambda e: iter([(jnp.asarray(i), jnp.asarray(lab), v) for i, lab, v in batches])


def _within(got, want, pred, bound):
    """The port's trained leaves of two runs: max|d| <= bound, median <= 1e-6."""
    n = 0
    for (path, a), (_, b) in zip(TO.paths(TO.partition(got, pred)[0]),
                                 TO.paths(TO.partition(want, pred)[0])):
        if a is None:
            continue
        d = (a.detach() - b.detach()).abs()
        assert float(d.max()) <= bound and float(d.median()) <= 1e-6, (path, float(d.max()))
        n += 1
    assert n > 0


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    models = {mode: tiny_models(mode) for mode in ("coop", "ivlp")}
    batches = fixed_batches()
    nan = [(im.copy(), lab, v) for im, lab, v in batches]
    nan[1][0][6] = np.nan  # rank 1's rows of the second batch
    mt = tiny_mt("hard")
    mt_epochs = {1: {1: [(0, task_batch(HW1, 5, seed=501)), (1, task_batch(HW1, 4, seed=551))]},
                 2: {0: [(0, task_batch(HW1, 5, seed=300)), (1, task_batch(HW1, 4, seed=350))]}}
    root = tmp_path_factory.mktemp("sharded_cache")
    SM.write_images(str(root / "Market1501"), np.random.RandomState(0), n_train_ids=3,
                    n_test_ids=2, n_query=2, n_gallery=4, hw=(64, 32))
    records = get_dataset(str(root), "market1501").train
    n = len(records)
    sels = {"spread": np.array([0, n - 1, 3, n // 2 + 1, 1, n // 2, 6, n - 5]),
            "padded": np.array([n - 1, n - 1, 0, 0, n // 2, 0, 0, 0])}
    ranks = W.spawn(W.sharded_training, {m: v[2:] for m, v in models.items()}, batches, nan,
                    mt[2:], mt_epochs, records, sels)
    return models, batches, nan, mt, mt_epochs, records, sels, ranks


@pytest.mark.parametrize("mode", ["coop", "ivlp"])
def test_stage1_over_two_ranks_matches_jax_and_one_device(setup, mode):
    models, batches, *_, ranks = setup
    jcfg, jp, tcfg, tp = models[mode]
    got, same = ranks[f"stage1_{mode}"]
    assert same
    jout = JTR.run_stage1(jp, jcfg, JTR.TrainConfig(), _jax_batches(batches), epochs=EPOCHS,
                          batch_size=8, mesh=make_mesh(n_data=2), log=lambda s: None)
    single = TTR.run_stage1(tp, tcfg, TTR.TrainConfig(), lambda e: iter(batches),
                            epochs=EPOCHS, batch_size=8, log=lambda s: None)
    lrs = [TTR.S.cosine_warmup_lr(e, 3.5e-4, EPOCHS) for e in range(1, EPOCHS + 1)
           for _ in range(2)]
    from tpu_reid.models import reid_clip as JM

    compare_leaves(got, jout, (lambda p: JM.stage1_trainable(p, jcfg),
                               lambda p: TM.stage1_trainable(p, tcfg)), adam_bound(lrs))
    _within(got, single, lambda p: TM.stage1_trainable(p, tcfg), adam_bound(lrs))
    assert not np.allclose(got["prompt_learner"]["cls_ctx"].numpy(),
                           tp["prompt_learner"]["cls_ctx"].numpy())


def test_stage2_over_two_ranks_matches_jax_and_one_device(setup):
    models, batches, *_, ranks = setup
    jcfg, jp, tcfg, tp = models["ivlp"]
    got, same = ranks["stage2_ivlp"]
    assert same
    jout = JTR.run_stage2(jp, jcfg, JTR.TrainConfig(), _jax_batches(batches), epochs=EPOCHS,
                          mesh=make_mesh(n_data=2), log=lambda s: None)
    single = TTR.run_stage2(tp, tcfg, TTR.TrainConfig(), lambda e: iter(batches),
                            epochs=EPOCHS, log=lambda s: None)
    lrs = [TTR.S.warmup_multistep_lr(e, 5e-6) for e in range(EPOCHS) for _ in range(2)]
    from tpu_reid.models import reid_clip as JM

    compare_leaves(got, jout, (lambda p: JM.stage2_trainable(p, jcfg),
                               lambda p: TM.stage2_trainable(p, tcfg)), adam_bound(lrs, 2.0))
    _within(got, single, lambda p: TM.stage2_trainable(p, tcfg), adam_bound(lrs, 2.0))
    for name in ("bn", "bn_proj"):  # the BNNeck statistics of the global batch
        for k in ("mean", "var"):
            np.testing.assert_allclose(got["head"][name][k].numpy(),
                                       np.asarray(jout["head"][name][k]), atol=1e-5, rtol=1e-4)
            np.testing.assert_allclose(got["head"][name][k].numpy(),
                                       single["head"][name][k].numpy(), atol=1e-6, rtol=1e-5)


def test_a_nan_on_one_rank_rolls_both_back(setup):
    """The NaN image sits in rank 1's rows only; the gathered features carry
    it into the global loss of both ranks, both guards roll back once at
    the same step and skip the batch, the ranks stay identical, and the
    result is the single-device run's with the same guard."""
    models, _, nan, *_, ranks = setup
    _, _, tcfg, tp = models["ivlp"]
    got, same, restores, steps = ranks["guard"]
    assert same and restores == [1, 1] and steps == [1]
    guard = TrainGuard(snapshot_every=1, max_restores=3, log=lambda s: None)
    single = TTR.run_stage2(tp, tcfg, TTR.TrainConfig(), lambda e: iter(nan), epochs=1,
                            log=lambda s: None, guard=guard)
    assert guard.restores == 1
    lrs = [TTR.S.warmup_multistep_lr(0, 5e-6)] * 2
    _within(got, single, lambda p: TM.stage2_trainable(p, tcfg), adam_bound(lrs, 2.0))
    for leaf in (got["clip"]["visual"]["proj"], got["head"]["bn"]["mean"]):
        assert np.isfinite(leaf.detach().numpy()).all()


def test_the_sharded_cache_gathers_like_one_device_and_jax(setup):
    """Each rank holds half the split (zero-padded); a global index row's
    gather on every rank, gathered in rank order, is the single-device
    cache's gather bit for bit, and the JAX package's sharded cache's."""
    from tpu_reid.data.device_cache import DeviceImageCache as JCache

    *_, records, sels, ranks = setup
    rows, n_local, nbytes = ranks["cache"]
    assert n_local == -(-len(records) // 2) and nbytes == n_local * 32 * 16 * 3
    single = DeviceImageCache(records, (32, 16), device="cpu")
    jcache = JCache(records, (32, 16), mesh=make_mesh(n_data=2))
    for name, sel in sels.items():
        np.testing.assert_array_equal(rows[name].numpy(), single.gather(sel).numpy())
        np.testing.assert_array_equal(rows[name].numpy(),
                                      np.asarray(jcache.gather(sel.astype(np.int32))))


@pytest.mark.parametrize("stage", [1, 2])
def test_mt_runners_over_two_ranks_match_jax_and_one_device(setup, stage):
    """One batch of each task: the image tower (and in stage 2 the XBM
    memory, filled from the global batch) over the ranks."""
    *_, mt, mt_epochs, _, _, ranks = setup
    jcfg, jp, tcfg, tp = mt
    got, same = ranks[f"mt_stage{stage}"]
    assert same
    eps = mt_epochs[stage]
    jrun, trun = (JMT.run_mt_stage1, TMT.run_mt_stage1) if stage == 1 else \
        (JMT.run_mt_stage2, TMT.run_mt_stage2)
    kw = dict(xbm_capacity=16, xbm_start_epoch=0) if stage == 2 else {}
    jout = jrun(jp, jcfg, JTR.TrainConfig(), lambda e: iter([(t, _j(b)) for t, b in eps[e]]),
                epochs=1, mesh=make_mesh(n_data=2), log=lambda s: None, **kw)
    single = trun(tp, tcfg, TTR.TrainConfig(), lambda e: iter(eps[e]), epochs=1,
                  log=lambda s: None, **kw)
    if stage == 1:
        lrs = [TTR.S.cosine_warmup_lr(1, 3.5e-4, 1)] * 2
        preds = (lambda p: JMT.mt_stage1_trainable(p, jcfg),
                 lambda p: TMT.mt_stage1_trainable(p, tcfg))
        bound = adam_bound(lrs)
    else:
        lrs = [TTR.S.warmup_multistep_lr(0, 5e-6)] * 2
        preds = (lambda p: JMT.mt_stage2_trainable(p, jcfg),
                 lambda p: TMT.mt_stage2_trainable(p, tcfg))
        bound = adam_bound(lrs, 2.0)
    compare_leaves(got, jout, preds, bound)
    _within(got, single, preds[1], bound)
