"""The port's ReID model (heads, prompt learner, reid_clip) against the JAX
package's on the tiny model of tests/test_trainer.py (width 64, 2 layers,
32x16 images, stride 8), carried across by from_jax_reid_params: for coop,
ivlp, promptsrc and adapter, eval_embed, the text features, forward_train
(logits and BN statistics) and the stage partitions, fp32 within 1e-4.

`tiny_models` is shared with the training tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_oracle as oracle
from tpu_reid.configs import PromptDesign as JDesign
from tpu_reid.models import heads as JH
from tpu_reid.models import prompts as JP
from tpu_reid.models import reid_clip as JM
from tpu_reid.models.resnet import batch_norm as j_batch_norm
from tpu_reid.models.text import init_text
from tpu_reid.models.vit import init_vit
from tpu_reid.train import optim as JO
from tpu_reid.weights import convert as JW
from tpu_reid_torch.configs import PromptDesign
from tpu_reid_torch.models import heads as TH
from tpu_reid_torch.models import layers as TL
from tpu_reid_torch.models import prompts as TP
from tpu_reid_torch.models import reid_clip as TM
from tpu_reid_torch.train import optim as TO
from tpu_reid_torch.weights import convert as TW

TOL = 1e-4
N_CLS = 6
MODES = ("coop", "ivlp", "promptsrc", "adapter")


def _design(mode, cls):
    if mode in ("ivlp", "promptsrc"):
        return cls(trainer="IVLP", vision_depth=2, vision_ctx=2, language_depth=2,
                   language_ctx=2)
    return cls()


def tiny_models(mode, seed=0, n_cls=N_CLS):
    """(JAX config, JAX params as jnp arrays, port config, port params on
    the CPU): one random tiny CLIP with the JAX package's own VPT and ReID
    initialisation, carried across by from_jax_reid_params."""
    rng = np.random.RandomState(seed)
    sd = oracle.make_clip_state_dict(rng, vision_width=64, vision_layers=2, patch=8, grid=4,
                                     text_width=128, text_layers=2, vocab=120, context=12,
                                     embed_dim=32)
    jccfg, jcp = JW.convert_clip(sd, image_hw=(32, 16), stride=8,
                                 design=_design(mode, JDesign))
    if mode in ("ivlp", "promptsrc"):
        vinit = init_vit(jax.random.key(9), jccfg.vision)
        jcp["visual"]["vpt_shallow"] = vinit["vpt_shallow"]
        jcp["visual"]["vpt_deep"] = vinit["vpt_deep"]
        jcp["text"]["vpt_deep"] = init_text(jax.random.key(10), jccfg.text)["vpt_deep"]
    tokens = np.zeros((1, 12), np.int32)
    tokens[0, 0] = 118
    tokens[0, 1:10] = rng.randint(1, 117, 9)
    tokens[0, 10] = 119
    temb = np.asarray(jcp["text"]["token_embedding"])[tokens]
    jpcfg = (JP.PromptLearnerConfig.coop(n_cls) if mode in ("coop", "adapter")
             else JP.PromptLearnerConfig.ivlp(n_cls))
    jcfg = JM.ReidModelConfig(mode=mode, clip=jccfg, prompt=jpcfg)
    zs = jax.tree.map(np.copy, jcp["visual"]) if mode == "promptsrc" else None
    jparams = JM.init_reid_model(jax.random.key(seed), jcfg, jcp, temb, tokens,
                                 zs_visual_params=zs)
    jparams = jax.tree.map(jnp.asarray, jparams)

    tccfg = TW.infer_config(sd, image_hw=(32, 16), stride=8, design=_design(mode, PromptDesign))
    tpcfg = (TP.PromptLearnerConfig.coop(n_cls) if mode in ("coop", "adapter")
             else TP.PromptLearnerConfig.ivlp(n_cls))
    tcfg = TM.ReidModelConfig(mode=mode, clip=tccfg, prompt=tpcfg)
    tparams = TW.from_jax_reid_params(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module", params=MODES)
def models(request):
    return (request.param, *tiny_models(request.param))


def _images(seed, b=4):
    return np.random.RandomState(seed).randn(b, 32, 16, 3).astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_eval_embed_and_image_features_match_jax(models, impl):
    mode, jcfg, jp, tcfg, tp = models
    x = _images(1)
    want = JM.eval_embed(jp, jcfg, jnp.asarray(x))
    with TL.kernel_impl(impl):
        got = TM.eval_embed(tp, tcfg, torch.from_numpy(x))
    assert tuple(got.shape) == (4, 64 + 32)
    _close(got, want)
    # with the input normalisation folded into the patch embed
    jf, tf = JM.fold_input_norm(jp, jcfg), TM.fold_input_norm(tp, tcfg)
    raw = np.random.RandomState(2).uniform(0, 255, (3, 32, 16, 3)).astype(np.float32)
    _close(TM.eval_embed(tf, tcfg, torch.from_numpy(raw)),
           JM.eval_embed(jf, jcfg, jnp.asarray(raw)), tol=3e-4)


def test_text_features_match_jax(models):
    mode, jcfg, jp, tcfg, tp = models
    labels = np.array([3, 0, 5, 3])
    _close(TM.encode_text_features(tp, tcfg, torch.from_numpy(labels)),
           JM.encode_text_features(jp, jcfg, jnp.asarray(labels)))
    _close(TM.all_class_text_features(tp, tcfg, batch=4),
           JM.all_class_text_features(jp, jcfg, batch=4))


def test_forward_train_matches_jax(models):
    mode, jcfg, jp, tcfg, tp = models
    x = _images(3, b=6)
    valid = np.array([True] * 5 + [False])
    want = JM.forward_train(jp, jcfg, jnp.asarray(x), train=True, valid=jnp.asarray(valid))
    got = TM.forward_train(tp, tcfg, torch.from_numpy(x), train=True,
                           valid=torch.from_numpy(valid))
    for g, w in zip(got["cls_scores"], want["cls_scores"]):
        _close(g, w)
    for g, w in zip(got["features"], want["features"]):
        _close(g, w)
    for name in ("bn", "bn_proj"):
        for k in ("mean", "var"):
            _close(got["bn_stats"][name][k], want["bn_stats"][name][k])
    assert ("zs_non_proj" in got) == (mode == "promptsrc")
    if mode == "promptsrc":
        _close(got["zs_non_proj"], want["zs_non_proj"])


def test_stage_partitions_match_jax(models):
    mode, jcfg, jp, tcfg, tp = models
    for jpred, tpred in ((JM.stage1_trainable, TM.stage1_trainable),
                         (JM.stage2_trainable, TM.stage2_trainable)):
        jt, _ = JO.partition(jp, lambda p: jpred(p, jcfg))
        tt, tf = TO.partition(tp, lambda p: tpred(p, tcfg))
        jpaths = [p for p, v in JO._paths(jt) if v is not None]
        tpaths = [p for p, v in TO.paths(tt) if v is not None]
        assert tpaths == jpaths, (mode, jpred.__name__)
        assert TO.count_params(tt) == JO.count_params(jt)
        full = TO.combine(tt, tf)
        assert all(a is b for (_, a), (_, b) in zip(TO.paths(full), TO.paths(tp)))


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_batch_norm_matches_jax(train, masked):
    rng = np.random.RandomState(4)
    x = rng.randn(7, 5).astype(np.float32) * 2 + 1
    p = {"scale": 1 + 0.1 * rng.randn(5).astype(np.float32),
         "bias": 0.1 * rng.randn(5).astype(np.float32),
         "mean": 0.1 * rng.randn(5).astype(np.float32),
         "var": 1 + 0.1 * rng.rand(5).astype(np.float32)}
    valid = np.array([1, 1, 0, 1, 1, 1, 0], bool) if masked else None
    jy, js = j_batch_norm({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), train,
                          valid=None if valid is None else jnp.asarray(valid))
    ty, ts = TH.batch_norm({k: torch.from_numpy(v) for k, v in p.items()},
                           torch.from_numpy(x), train,
                           valid=None if valid is None else torch.from_numpy(valid))
    _close(ty, jy, tol=1e-5)
    assert (ts is None) == (js is None)
    if train:
        for k in ("mean", "var"):
            _close(ts[k], js[k], tol=1e-5)


def test_heads_and_adapter_match_jax():
    rng = np.random.RandomState(6)
    feat, proj = rng.randn(4, 64).astype(np.float32), rng.randn(4, 32).astype(np.float32)
    jp = JH.init_classifier(jax.random.key(1), 5, 64, 32)
    tp = TW.to_device(jax.tree.map(np.asarray, jp), torch.device("cpu"))
    want = JH.apply_classifier(jp, jnp.asarray(feat), jnp.asarray(proj), train=True)
    got = TH.apply_classifier(tp, torch.from_numpy(feat), torch.from_numpy(proj), train=True)
    for k in ("bn_feat", "bn_feat_proj", "logits", "logits_proj"):
        _close(got[k], want[k], tol=1e-5)
    ja = JH.init_adapter(jax.random.key(2), 64)
    ta = TW.to_device(jax.tree.map(np.asarray, ja), torch.device("cpu"))
    _close(TH.apply_adapter(ta, torch.from_numpy(feat)), JH.apply_adapter(ja, jnp.asarray(feat)),
           tol=1e-5)
    # the port's own initialisations: shapes and scales of the JAX ones
    g = torch.Generator().manual_seed(0)
    ti = TH.init_classifier(g, 5, 64, 32)
    assert tuple(ti["cls"]["w"].shape) == (64, 5) and float(ti["cls"]["w"].std()) < 0.002
    assert tuple(TH.init_adapter(g, 64)["fc2"]["w"].shape) == (16, 64)


@pytest.mark.parametrize("kind", ["coop", "ivlp", "veri", "augmented", "captions"])
def test_prompt_learner_matches_jax(kind):
    rng = np.random.RandomState(8)
    n_cls, t_len, d = 5, 16, 24
    cfgs = {"coop": "coop", "ivlp": "ivlp", "veri": "veri", "augmented": "augmented",
            "captions": "captions"}
    jcfg = getattr(JP.PromptLearnerConfig, cfgs[kind])(n_cls)
    tcfg = getattr(TP.PromptLearnerConfig, cfgs[kind])(n_cls)
    n_t = n_cls if jcfg.per_class else jcfg.n_templates
    tokens = rng.randint(1, 100, (n_t, t_len)).astype(np.int32)
    tokens[np.arange(n_t), rng.randint(10, t_len, n_t)] = 500  # EOT
    temb = rng.randn(n_t, t_len, d).astype(np.float32)
    jp = JP.init_prompt_learner(jax.random.key(0), jcfg, temb, tokens)
    tp = TP.init_prompt_learner(torch.Generator().manual_seed(0), tcfg, temb, tokens)
    for k in ("prefix", "suffix", "eot_idx"):
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
    assert tp["eot_idx"].dtype == torch.int32
    assert tuple(tp["cls_ctx"].shape) == tuple(jp["cls_ctx"].shape)
    tp["cls_ctx"] = torch.from_numpy(np.asarray(jp["cls_ctx"]))
    labels = np.array([4, 1, 1])
    jpr, jeot = JP.apply_prompt_learner(jp, jcfg, jnp.asarray(labels))
    tpr, teot = TP.apply_prompt_learner(tp, tcfg, torch.from_numpy(labels))
    np.testing.assert_array_equal(tpr.numpy(), np.asarray(jpr))
    np.testing.assert_array_equal(teot.numpy(), np.asarray(jeot))
    jall, _ = JP.all_class_prompts(jp, jcfg)
    np.testing.assert_array_equal(TP.all_class_prompts(tp, tcfg)[0].numpy(), np.asarray(jall))
    assert TP.veri_templates(["red sedan", "suv"], 4) == JP.veri_templates(["red sedan", "suv"], 4)
    assert TP.base_template("veri") == JP.base_template("veri")


def test_converter_checks_and_vpt_init():
    jcfg, jp, tcfg, tp = tiny_models("ivlp")
    assert tp["prompt_learner"]["eot_idx"].dtype == torch.int32
    assert tuple(tp["head"]["bn"]["var"].shape) == (64,)
    bad = jax.tree.map(np.asarray, jp)
    bad["head"]["cls"]["w"] = np.zeros((64, N_CLS + 1), np.float32)
    with pytest.raises(ValueError, match="head.cls"):
        TW.from_jax_reid_params(bad, tcfg, device="cpu")
    clip = {k: v for k, v in tp["clip"].items()}
    clip["visual"] = {k: v for k, v in clip["visual"].items() if not k.startswith("vpt_")}
    clip["text"] = {k: v for k, v in clip["text"].items() if k != "vpt_deep"}
    filled = TW.init_vpt(torch.Generator().manual_seed(0), tcfg.clip, clip)
    assert tuple(filled["visual"]["vpt_shallow"].shape) == (2, 64)
    assert tuple(filled["visual"]["vpt_deep"].shape) == (2, 2, 64)
    assert tuple(filled["text"]["vpt_deep"].shape) == (2, 2, 128)
    assert "vpt_shallow" not in clip["visual"]  # a new dict, the input untouched
    kept = TW.init_vpt(torch.Generator().manual_seed(0), tcfg.clip, tp["clip"])
    assert kept["visual"]["vpt_deep"] is tp["clip"]["visual"]["vpt_deep"]


