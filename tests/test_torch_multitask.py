"""The port's multitask training (train/xbm.py, losses.triplet_loss_xbm,
train/multitask.py) against tpu_reid.train.multitask on the same numpy
parameters: the tiny two-task model of tests/test_multitask.py (width 64,
2 layers, 32x16 images, stride 8; task 1 at 32x16, or 40x24 for
hard_ivlp), carried across by from_jax_multitask_params. The XBM ring
exactly, the XBM triplet within 1e-6, the four schedulers, encoders and
eval_embed_mt at both geometries within 2e-4, run_mt_stage1 /
run_mt_stage2 (per-epoch losses, trained leaves within the Adam bound of
tests/test_torch_trainer_stage1.py, the XBM banks within 1e-5), a padded
batch, and a resume through a file on disk bit for bit."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_oracle as oracle
from tests.test_torch_trainer_stage1 import adam_bound, compare_leaves
from tpu_reid.configs import PromptDesign as JDesign
from tpu_reid.configs import VisionConfig as JVision
from tpu_reid.models import prompts as JP
from tpu_reid.models.text import init_text
from tpu_reid.models.vit import init_vit
from tpu_reid.train import losses as JL
from tpu_reid.train import multitask as JMT
from tpu_reid.train import xbm as JX
from tpu_reid.train.trainer import TrainConfig as JTrainConfig
from tpu_reid.weights import convert as JW
from tpu_reid_torch.configs import PromptDesign, VisionConfig
from tpu_reid_torch.models import prompts as TP
from tpu_reid_torch.runtime import checkpoint as C
from tpu_reid_torch.train import losses as TL
from tpu_reid_torch.train import multitask as TMT
from tpu_reid_torch.train import optim as TO
from tpu_reid_torch.train import xbm as TX
from tpu_reid_torch.train.trainer import TrainConfig
from tpu_reid_torch.weights import convert as TW

HW1 = (32, 16)
EPOCHS = 2


def _design(variant, cls):
    if variant == "hard_ivlp":
        return cls(trainer="IVLP", vision_depth=2, vision_ctx=2, language_depth=2,
                   language_ctx=2)
    return cls()


def _with_grid(cfg, vision_cls, hw):
    hg, wg = vision_cls.grid_for(hw, 8, 8)
    return dataclasses.replace(cfg, vision=dataclasses.replace(cfg.vision, h_grid=hg, w_grid=wg))


def tiny_mt(variant="hard", hw2=HW1, seed=0):
    """(JAX config, JAX params, port config, port params on the CPU): the
    model of tests/test_multitask.py's build_mt, initialised by the JAX
    package and carried across."""
    rng = np.random.RandomState(seed)
    sd = oracle.make_clip_state_dict(rng, vision_width=64, vision_layers=2, patch=8, grid=4,
                                     text_width=128, text_layers=2, vocab=120, context=12,
                                     embed_dim=32)
    jcfg1, jcp = JW.convert_clip(sd, image_hw=HW1, stride=8, design=_design(variant, JDesign))
    if variant == "hard_ivlp":
        vinit = init_vit(jax.random.key(9), jcfg1.vision)
        jcp["visual"]["vpt_shallow"] = vinit["vpt_shallow"]
        jcp["visual"]["vpt_deep"] = vinit["vpt_deep"]
        jcp["text"]["vpt_deep"] = init_text(jax.random.key(10), jcfg1.text)["vpt_deep"]
    mk = JP.PromptLearnerConfig.ivlp if variant == "hard_ivlp" else JP.PromptLearnerConfig.coop
    jcfg = JMT.MultitaskModelConfig(variant=variant, clip=jcfg1,
                                    clip2=_with_grid(jcfg1, JVision, hw2),
                                    prompt1=mk(5), prompt2=mk(4))
    tokens = np.zeros((1, 12), np.int32)
    tokens[0, 0] = 118
    tokens[0, 1:10] = rng.randint(1, 117, 9)
    tokens[0, 10] = 119
    emb = np.asarray(jcp["text"]["token_embedding"])[tokens]
    jparams = JMT.init_multitask_model(jax.random.key(seed), jcfg, jcp, emb, tokens, emb,
                                       tokens)

    tcfg1 = TW.infer_config(sd, image_hw=HW1, stride=8, design=_design(variant, PromptDesign))
    tmk = (TP.PromptLearnerConfig.ivlp if variant == "hard_ivlp"
           else TP.PromptLearnerConfig.coop)
    tcfg = TMT.MultitaskModelConfig(variant=variant, clip=tcfg1,
                                    clip2=_with_grid(tcfg1, VisionConfig, hw2),
                                    prompt1=tmk(5), prompt2=tmk(4))
    tparams = TW.from_jax_multitask_params(jax.tree.map(np.asarray, jparams), tcfg,
                                           device="cpu")
    return jcfg, jparams, tcfg, tparams


def task_batch(hw, n_cls, bs=8, seed=0, n_valid=None):
    rng = np.random.RandomState(seed)
    images = rng.randn(bs, *hw, 3).astype(np.float32)
    labels = np.repeat(rng.choice(n_cls, bs // 4, replace=False), 4)
    valid = np.ones(bs, bool) if n_valid is None else np.arange(bs) < n_valid
    return images, labels, valid


def _j(batch):
    images, labels, valid = batch
    return jnp.asarray(images), jnp.asarray(labels), valid


# ---------------------------------------------------------------------------
# XBM, the memory triplet, the schedulers
# ---------------------------------------------------------------------------


def _xbm_equal(t, j):
    np.testing.assert_array_equal(t["feats"].numpy(), np.asarray(j["feats"]))
    np.testing.assert_array_equal(t["labels"].numpy(), np.asarray(j["labels"]))
    assert t["ptr"] == int(j["ptr"]) and t["filled"] == int(j["filled"])


@pytest.mark.parametrize("padded", [False, True])
def test_xbm_ring_matches_jax(padded):
    """Enqueues of 6, 4 (wrapping around) and 5 rows into a ring of 8,
    with a padded tail in the second batch when `padded`: slots, features,
    labels, pointer, fill count, the valid mask and is_full, exactly."""
    rng = np.random.RandomState(1)
    tst, jst = TX.init_xbm(8, 4), JX.init_xbm(8, 4)
    assert not TX.xbm_is_full(tst)
    _xbm_equal(tst, jst)
    for k, n in enumerate((6, 4, 5)):
        f = rng.randn(n, 4).astype(np.float32)
        lab = rng.randint(0, 9, n)
        valid = np.arange(n) < (n - 2) if (padded and k == 1) else None
        tst, tslots = TX.xbm_enqueue(tst, torch.from_numpy(f), torch.from_numpy(lab),
                                     None if valid is None else torch.from_numpy(valid))
        jst, jslots = JX.xbm_enqueue(jst, jnp.asarray(f), jnp.asarray(lab),
                                     None if valid is None else jnp.asarray(valid))
        np.testing.assert_array_equal(tslots.numpy(), np.asarray(jslots))
        _xbm_equal(tst, jst)
        assert TX.xbm_is_full(tst) == bool(JX.xbm_is_full(jst))
        np.testing.assert_array_equal(TX.xbm_get(tst)[2].numpy(),
                                      np.asarray(JX.xbm_get(jst)[2]))
    assert TX.xbm_is_full(tst)


def test_xbm_enqueue_leaves_the_old_state_alone():
    """A step's enqueue returns a new state: a guard's snapshot taken before
    the step is the state before it; bf16 features land in the fp32 bank."""
    st = TX.init_xbm(4, 2)
    new, _ = TX.xbm_enqueue(st, torch.ones(2, 2, dtype=torch.bfloat16), torch.tensor([3, 4]))
    assert float(st["feats"].abs().max()) == 0.0 and st["ptr"] == 0 and st["filled"] == 0
    assert new["feats"].dtype == torch.float32 and new["ptr"] == 2 and new["filled"] == 2


@pytest.mark.parametrize("margin,normalize", [(0.3, False), (None, False), (0.3, True)])
def test_triplet_loss_xbm_matches_jax(margin, normalize):
    """Anchors against a bank with self slots, unfilled slots and padded
    anchors excluded: the value within 1e-6, and the anchors' gradient."""
    rng = np.random.RandomState(2)
    feat = rng.randn(8, 16).astype(np.float32)
    labels = np.repeat(np.arange(2), 4)
    bank = rng.randn(12, 16).astype(np.float32)
    bank_lab = rng.randint(0, 3, 12)
    self_cols = np.arange(3, 11)
    valid_cols = np.arange(12) < 10
    valid = np.arange(8) < 7
    kw = dict(margin=margin, normalize_feature=normalize)

    def jloss(f):
        return JL.triplet_loss_xbm(f, jnp.asarray(labels), jnp.asarray(bank),
                                   jnp.asarray(bank_lab), self_cols=jnp.asarray(self_cols),
                                   valid_cols=jnp.asarray(valid_cols),
                                   valid=jnp.asarray(valid), **kw)

    want, jgrad = jax.value_and_grad(jloss)(jnp.asarray(feat))
    tf = torch.from_numpy(feat).requires_grad_(True)
    got = TL.triplet_loss_xbm(tf, torch.from_numpy(labels), torch.from_numpy(bank),
                              torch.from_numpy(bank_lab), self_cols=torch.from_numpy(self_cols),
                              valid_cols=torch.from_numpy(valid_cols),
                              valid=torch.from_numpy(valid), **kw)
    got.backward()
    assert abs(float(got.detach()) - float(want)) <= 1e-6
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(jgrad), atol=1e-6)


@pytest.mark.parametrize("name", ["alternate", "alternate_longest", "chain_tasks",
                                  "chain_tasks_longest"])
@pytest.mark.parametrize("lengths", [(3, 1), (1, 3), (2, 2), (0, 2)])
def test_schedulers_match_jax(name, lengths):
    a = [f"a{i}" for i in range(lengths[0])]
    b = [f"b{i}" for i in range(lengths[1])]
    assert list(getattr(TMT, name)(a, b)) == list(getattr(JMT, name)(a, b))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=["hard", "hard_ivlp"])
def models(request):
    hw2 = (40, 24) if request.param == "hard_ivlp" else HW1
    return (hw2,) + tiny_mt(request.param, hw2)


def test_init_matches_jax_and_clones_the_text_tower(models):
    """init_multitask_model of the port on the carried CLIP weights: the
    second positional embedding equals JAX's bicubic resize, text2 equals
    the CLIP text tower without sharing its storage, the new leaves have
    JAX's shapes."""
    hw2, jcfg, jp, tcfg, tp = models
    emb = tp["prompt1"]["prefix"].new_zeros((1, 12, 128))
    tokens = np.zeros((1, 12), np.int32)
    tokens[0, 10] = 119
    mine = TMT.init_multitask_model(torch.Generator().manual_seed(0), tcfg, tp["clip"], emb,
                                    tokens, emb, tokens)
    assert set(mine) == set(jp)
    for key in ("prompt1", "prompt2", "head1", "head2"):
        shapes = {p: tuple(t.shape) for p, t in TO.paths(tp[key])}
        assert {p: tuple(t.shape) for p, t in TO.paths(mine[key])} == shapes, key
    if "pos_embed2" in jp:
        np.testing.assert_allclose(mine["pos_embed2"].numpy(), np.asarray(jp["pos_embed2"]),
                                   atol=1e-6)
    if tcfg.dual_text:
        for (_, a), (_, b) in zip(TO.paths(mine["text2"]), TO.paths(tp["clip"]["text"])):
            assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()


@pytest.mark.parametrize("task", [0, 1])
def test_encoders_and_eval_embed_match_jax(models, task):
    hw2, jcfg, jp, tcfg, tp = models
    hw = HW1 if task == 0 else hw2
    images = np.random.RandomState(5 + task).randn(3, *hw, 3).astype(np.float32)
    label = np.array([1, 3, 0])
    for got, want in zip(TMT.encode_image_mt(tp, tcfg, task, torch.from_numpy(images)),
                         JMT.encode_image_mt(jp, jcfg, task, jnp.asarray(images))):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=2e-4)
    np.testing.assert_allclose(
        TMT.eval_embed_mt(tp, tcfg, task, torch.from_numpy(images)).detach().numpy(),
        np.asarray(JMT.eval_embed_mt(jp, jcfg, task, jnp.asarray(images))), atol=2e-4)
    np.testing.assert_allclose(
        TMT.encode_text_mt(tp, tcfg, task, torch.from_numpy(label)).detach().numpy(),
        np.asarray(JMT.encode_text_mt(jp, jcfg, task, jnp.asarray(label))), atol=2e-4)
    np.testing.assert_allclose(
        TMT.all_class_text_features_mt(tp, tcfg, task, batch=3).detach().numpy(),
        np.asarray(JMT.all_class_text_features_mt(jp, jcfg, task)), atol=2e-4)


def test_partitions_match_jax(models):
    hw2, jcfg, jp, tcfg, tp = models
    for stage in (1, 2):
        jpred = getattr(JMT, f"mt_stage{stage}_trainable")
        tpred = getattr(TMT, f"mt_stage{stage}_trainable")
        jt, _ = TO.partition(jax.tree.map(np.asarray, jp), lambda p: jpred(p, jcfg))
        tt, _ = TO.partition(tp, lambda p: tpred(p, tcfg))
        assert [p for p, t in TO.paths(jt) if t is not None] == \
            [p for p, t in TO.paths(tt) if t is not None]


# ---------------------------------------------------------------------------
# the runners against JAX
# ---------------------------------------------------------------------------


def _epochs(hw2, first_epoch, seed):
    """{epoch: [(task, batch)]}: one batch of each task per epoch, each
    epoch its own draws."""
    return {e: [(0, task_batch(HW1, 5, seed=seed + e)),
                (1, task_batch(hw2, 4, seed=seed + 50 + e))]
            for e in range(first_epoch, first_epoch + EPOCHS)}


def _mt_losses(lines, stage):
    return [float(s.split(" loss ")[1]) for s in lines
            if s.startswith(f"[mt-stage{stage}] epoch") and "/" in s.split()[2]]


@pytest.fixture(scope="module")
def stage1_runs(models):
    hw2, jcfg, jp, tcfg, tp = models
    eps = _epochs(hw2, 1, 500)
    jlog, tlog = [], []
    jout = JMT.run_mt_stage1(jp, jcfg, JTrainConfig(), lambda e: iter(
        [(t, _j(b)) for t, b in eps[e]]), epochs=EPOCHS, log=jlog.append)
    tout = TMT.run_mt_stage1(tp, tcfg, TrainConfig(), lambda e: iter(eps[e]), epochs=EPOCHS,
                             log=tlog.append)
    return jout, tout, jlog, tlog


def test_mt_stage1_matches_jax(models, stage1_runs):
    """Both tasks' prompts (and for hard_ivlp the VPT tokens of all three
    towers) trained for 2 epochs of one batch per task: per-epoch losses,
    trained leaves within the Adam bound (the hard_ivlp output is the GPA
    average), the rest untouched."""
    hw2, jcfg, jp, tcfg, tp = models
    jout, tout, jlog, tlog = stage1_runs
    jl, tl = _mt_losses(jlog, 1), _mt_losses(tlog, 1)
    assert len(tl) == len(jl) == EPOCHS and np.isfinite(tl).all()
    np.testing.assert_allclose(tl, jl, atol=2e-4)  # both logged to 4 decimals
    lrs = [TMT.S.cosine_warmup_lr(e, 3.5e-4, EPOCHS) for e in range(1, EPOCHS + 1)
           for _ in range(2)]
    compare_leaves(tout, jout, (lambda p: JMT.mt_stage1_trainable(p, jcfg),
                                lambda p: TMT.mt_stage1_trainable(p, tcfg)), adam_bound(lrs))
    for key in ("prompt1", "prompt2"):
        assert not np.allclose(tout[key]["cls_ctx"].numpy(), tp[key]["cls_ctx"].numpy())
    if tcfg.variant == "hard":  # no stage-1 GPA: the frozen leaves are the input
        assert tout["clip"]["visual"]["proj"] is tp["clip"]["visual"]["proj"]
    else:
        assert not np.allclose(tout["text2"]["vpt_deep"].numpy(),
                               tp["text2"]["vpt_deep"].numpy())


@pytest.fixture(scope="module")
def stage2_runs(models):
    hw2, jcfg, jp, tcfg, tp = models
    eps = _epochs(hw2, 0, 300)
    banks = {}

    def keep(name):
        def cb(e, p, state):
            if e == EPOCHS - 1:
                banks[name] = [jax.tree.map(np.asarray, x) if name == "jax" else x
                               for x in state["xbms"]]
        return cb

    jlog, tlog = [], []
    kw = dict(epochs=EPOCHS, xbm_capacity=16, xbm_start_epoch=1)
    jout = JMT.run_mt_stage2(jp, jcfg, JTrainConfig(), lambda e: iter(
        [(t, _j(b)) for t, b in eps[e]]), log=jlog.append, checkpoint_cb=keep("jax"), **kw)
    tout = TMT.run_mt_stage2(tp, tcfg, TrainConfig(), lambda e: iter(eps[e]), log=tlog.append,
                             checkpoint_cb=keep("torch"), **kw)
    return jout, tout, jlog, tlog, banks


def test_mt_stage2_matches_jax(models, stage2_runs):
    """The image tower and both heads trained for 2 epochs of one batch per
    task, the memory triplet from epoch 1 (so epoch 0 fills the banks and
    epoch 1 mines them): per-epoch losses, trained leaves within the Adam
    bound (bias group at 2x lr; the output is the GPA average), both heads'
    BN statistics, and both XBM banks (features within 1e-5, labels,
    pointer and fill count equal)."""
    hw2, jcfg, jp, tcfg, tp = models
    jout, tout, jlog, tlog, banks = stage2_runs
    jl, tl = _mt_losses(jlog, 2), _mt_losses(tlog, 2)
    assert len(tl) == len(jl) == EPOCHS and np.isfinite(tl).all()
    np.testing.assert_allclose(tl, jl, atol=2e-4)
    lrs = [TMT.S.warmup_multistep_lr(e, 5e-6) for e in range(EPOCHS) for _ in range(2)]
    compare_leaves(tout, jout, (lambda p: JMT.mt_stage2_trainable(p, jcfg),
                                lambda p: TMT.mt_stage2_trainable(p, tcfg)),
                   adam_bound(lrs, mult=2.0))
    for head in ("head1", "head2"):
        for name in ("bn", "bn_proj"):
            for k in ("mean", "var"):
                np.testing.assert_allclose(tout[head][name][k].numpy(),
                                           np.asarray(jout[head][name][k]), atol=1e-5,
                                           rtol=1e-4)
    for tb, jb in zip(banks["torch"], banks["jax"], strict=True):
        np.testing.assert_allclose(tb["feats"].numpy(), jb["feats"], atol=1e-5)
        np.testing.assert_array_equal(tb["labels"].numpy(), jb["labels"])
        assert tb["ptr"] == int(jb["ptr"]) and tb["filled"] == int(jb["filled"]) == 16


def test_mt_padded_batch_changes_nothing(models):
    """A stage-2 step on a batch padded with 4 rows of garbage equals the
    step on the unpadded batch: loss, trained leaves, and the bank (padded
    rows take slots with label -1 and are reported invalid)."""
    hw2, jcfg, jp, tcfg, tp = models
    tcfg_train = TrainConfig()
    text = TMT.all_class_text_features_mt(tp, tcfg, 0).detach()
    images, labels, _ = task_batch(HW1, 5, seed=7)
    rng = np.random.RandomState(8)
    pad_images = np.concatenate([images, 50.0 * rng.randn(4, *HW1, 3).astype(np.float32)])
    pad_labels = np.concatenate([labels, np.zeros(4, labels.dtype)])
    outs = []
    for imgs, labs, valid in ((images, labels, np.ones(8, bool)),
                              (pad_images, pad_labels, np.arange(12) < 8)):
        trainable, frozen = TO.partition(tp, lambda p: TMT.mt_stage2_trainable(p, tcfg))
        trainable = TMT.TR._trainable_copy(trainable)
        opt = TO.make_stage_optimizer(trainable, tcfg_train.lr_stage2, bias_lr_mult=2.0)
        step = TMT.make_mt_stage2_step(tcfg, tcfg_train, opt, 0)
        frozen, xbm, loss = step(trainable, frozen, torch.from_numpy(imgs),
                                 torch.from_numpy(labs), text, TX.init_xbm(16, 32), True,
                                 torch.from_numpy(valid))
        outs.append((trainable, frozen, xbm, float(loss)))
    (t_ref, f_ref, x_ref, l_ref), (t_pad, f_pad, x_pad, l_pad) = outs
    assert abs(l_ref - l_pad) < 1e-4
    for (_, a), (_, b) in zip(TO.paths(t_ref), TO.paths(t_pad)):
        if a is not None:
            np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), atol=1e-5)
    for name in ("bn", "bn_proj"):
        np.testing.assert_allclose(f_ref["head1"][name]["mean"].numpy(),
                                   f_pad["head1"][name]["mean"].numpy(), atol=1e-5)
    _, lab_pad, valid_pad = TX.xbm_get(x_pad)
    assert int(valid_pad.sum()) == 8 and (lab_pad[8:12] == -1).all()
    np.testing.assert_array_equal(x_ref["feats"][:8].numpy(), x_pad["feats"][:8].numpy())


# ---------------------------------------------------------------------------
# resume
# ---------------------------------------------------------------------------


def _trees_equal(got, want):
    for (pg, g), (pw, w) in zip(TO.paths(got), TO.paths(want), strict=True):
        assert pg == pw and torch.equal(g, w), pg


@pytest.mark.parametrize("stage", [1, 2])
def test_mt_resume_equals_the_straight_run(models, tmp_path, stage):
    """4 epochs straight against 2 epochs, a checkpoint through
    two_stage_cb, a restore by two_stage_resume from the files, and the
    last 2 epochs: equal bit for bit, the optimizer state, the GPA sum
    (stage 2 always, stage 1 for hard_ivlp) and, in stage 2, the XBM banks
    (memory triplet from epoch 0, so the banks shape every step)."""
    hw2, jcfg, jp, tcfg, tp = models
    first = 1 if stage == 1 else 0
    eps = {e: [(0, task_batch(HW1, 5, seed=700 + e)), (1, task_batch(hw2, 4, seed=800 + e))]
           for e in range(first, first + 4)}
    last = {}

    def run(params, checkpoint_cb=None, **kw):
        def cb(e, p, state):
            if stage == 2 and e == first + 3:
                last["xbms"] = state["xbms"]
            if checkpoint_cb is not None:
                checkpoint_cb(e, p, state)

        if stage == 1:
            return TMT.run_mt_stage1(params, tcfg, TrainConfig(), lambda e: iter(eps[e]),
                                     epochs=4, log=lambda s: None, checkpoint_cb=cb, **kw)
        return TMT.run_mt_stage2(params, tcfg, TrainConfig(), lambda e: iter(eps[e]),
                                 epochs=4, xbm_capacity=16, xbm_start_epoch=0,
                                 log=lambda s: None, checkpoint_cb=cb, **kw)

    want = run(tp)
    want_xbms = last.pop("xbms", None)
    mgr = C.CheckpointManager(str(tmp_path), save_interval=1, max_to_keep=1)
    save = C.two_stage_cb(mgr, stage - 1, lambda e: e)

    class Interrupt(Exception):
        pass

    def stop(e, p, state):
        save(e, p, state)
        if e == first + 1:
            raise Interrupt

    with pytest.raises(Interrupt):
        run(tp, checkpoint_cb=stop)
    gpa_used = stage == 2 or tcfg.variant == "hard_ivlp"
    params, done, kw1, kw2 = C.two_stage_resume(
        mgr, tp, lambda p: TMT.mt_stage1_leaf_order(p, tcfg),
        lambda p: TMT.mt_stage2_leaf_order(p, tcfg), gpa_used, gpa_used, xbms_used=True)
    mgr.close()
    kw = kw1 if stage == 1 else kw2
    assert done == stage - 1 and kw["start_epoch"] == first + 2
    got = run(params, **kw)
    _trees_equal(got, want)
    if stage == 2:
        for a, b in zip(last["xbms"], want_xbms, strict=True):
            assert torch.equal(a["feats"], b["feats"]) and torch.equal(a["labels"], b["labels"])
            assert (a["ptr"], a["filled"]) == (b["ptr"], b["filled"])


def test_mt_runners_refuse_a_mesh(models):
    """A mesh that is not the port's is refused (the port's mesh runs:
    tests/test_torch_sharded_training.py)."""
    hw2, jcfg, jp, tcfg, tp = models
    for run in (TMT.run_mt_stage1, TMT.run_mt_stage2):
        with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
            run(tp, tcfg, TrainConfig(), lambda e: iter([]), epochs=1, mesh=object())
