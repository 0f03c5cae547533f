"""The port's prompt-learning variants against the JAX package's on the tiny
model of tests/test_torch_reid_model.py (width 64, 2 layers, 32x16 images,
stride 8), carried across by from_jax_reid_params, fp32 within 1e-4:

  * MaPLe: the prompt stacks, eval_embed, the text features, forward_train
    and the stage partitions (the couplings train in stage 1, freeze in 2);
  * JPM: shuffle_unit (groups 1 and 3), apply_jpm, forward_train's four
    levels, the 2048-style concatenated eval embedding;
  * SIE: camera and view ids through the CLS token, ids beyond the table
    clipped, JPM and SIE together;
  * the gradient of the block Function to MaPLe's computed (non-leaf)
    prompt plane against plain autograd.

`variant_models` is shared with the training and CLI tests of the variants."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_oracle as oracle
from tpu_reid.configs import PromptDesign as JDesign
from tpu_reid.models import maple_prompts as JMP
from tpu_reid.models import prompts as JP
from tpu_reid.models import reid_clip as JM
from tpu_reid.models import vit as JV
from tpu_reid.train import optim as JO
from tpu_reid.weights import convert as JW
from tpu_reid_torch.configs import PromptDesign
from tpu_reid_torch.device import clone
from tpu_reid_torch.models import layers as TL
from tpu_reid_torch.models import maple_prompts as TMP
from tpu_reid_torch.models import prompts as TP
from tpu_reid_torch.models import reid_clip as TM
from tpu_reid_torch.models import vit as TV
from tpu_reid_torch.train import optim as TO
from tpu_reid_torch.weights import convert as TW

TOL = 1e-4
N_CLS = 6
SIE_COE = 1.5


def _design(mode, cls):
    if mode == "maple":
        return cls(trainer="MaPLe", vision_depth=2, vision_ctx=2, language_depth=2,
                   language_ctx=2, maple_length=2)
    return cls()


def variant_models(mode="coop", use_jpm=False, sie_ids=0, prompt="default", seed=0,
                   n_cls=N_CLS, vision_layers=2):
    """(JAX config, JAX params as jnp arrays, port config, port params on
    the CPU) of one random tiny CLIP in `mode` (coop, adapter or maple) with
    the JPM branch and an SIE table of `sie_ids` rows (coefficient 1.5),
    built by the JAX package's own initialisation and carried across by
    from_jax_reid_params. prompt="augmented": the 4 article-variant
    templates. vision_layers: the depth of both towers (MaPLe's stacks
    cover both with one layer count)."""
    rng = np.random.RandomState(seed)
    sd = oracle.make_clip_state_dict(rng, vision_width=64, vision_layers=vision_layers,
                                     patch=8, grid=4, text_width=128, text_layers=vision_layers,
                                     vocab=120, context=12, embed_dim=32)
    jccfg, jcp = JW.convert_clip(sd, image_hw=(32, 16), stride=8, design=_design(mode, JDesign))
    if mode == "maple":  # the keys JAX's init_vit gives a MaPLe design
        jcp["visual"]["vpt_shallow"] = JV.init_vit(jax.random.key(9), jccfg.vision)["vpt_shallow"]
    n_t = 4 if prompt == "augmented" else 1
    tokens = np.zeros((n_t, 12), np.int32)
    tokens[:, 0] = 118
    tokens[:, 1:10] = rng.randint(1, 117, (n_t, 9))
    tokens[:, 10] = 119
    temb = np.asarray(jcp["text"]["token_embedding"])[tokens]

    def pcfg(P):
        if prompt == "augmented":
            return P.PromptLearnerConfig.augmented(n_cls)
        return (P.PromptLearnerConfig.coop(n_cls) if mode in ("coop", "adapter")
                else P.PromptLearnerConfig.ivlp(n_cls))

    jcfg = JM.ReidModelConfig(mode=mode, clip=jccfg, prompt=pcfg(JP), use_jpm=use_jpm,
                              sie_ids=sie_ids, sie_coe=SIE_COE)
    jparams = jax.tree.map(jnp.asarray, JM.init_reid_model(jax.random.key(seed), jcfg, jcp,
                                                           temb, tokens))
    tccfg = TW.infer_config(sd, image_hw=(32, 16), stride=8, design=_design(mode, PromptDesign))
    tcfg = TM.ReidModelConfig(mode=mode, clip=tccfg, prompt=pcfg(TP), use_jpm=use_jpm,
                              sie_ids=sie_ids, sie_coe=SIE_COE)
    tparams = TW.from_jax_reid_params(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


VARIANTS = {
    "maple": dict(mode="maple"),
    "jpm": dict(mode="coop", use_jpm=True),
    "sie": dict(mode="coop", sie_ids=4),
    "jpm_sie": dict(mode="adapter", use_jpm=True, sie_ids=4),
}


@pytest.fixture(scope="module", params=list(VARIANTS))
def models(request):
    return (request.param, *variant_models(**VARIANTS[request.param]))


def _images(seed, b=4):
    return np.random.RandomState(seed).randn(b, 32, 16, 3).astype(np.float32)


def _cv(cfg, b, seed=5):
    """Camera ids with some beyond the table (clipped by both packages)."""
    if cfg.sie_ids == 0:
        return None, None
    ids = np.random.RandomState(seed).randint(0, cfg.sie_ids + 3, b).astype(np.int32)
    return jnp.asarray(ids), torch.from_numpy(ids)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want), atol=tol,
                               rtol=tol)


def test_maple_prompt_stacks_match_jax():
    rng = np.random.RandomState(2)
    for depth, n_layers in ((3, 5), (4, 4), (6, 3)):
        p = {"shared_ctx": rng.randn(2, 16).astype(np.float32),
             "text_deep": rng.randn(depth - 1, 2, 16).astype(np.float32),
             "proj": {"w": rng.randn(depth, 16, 24).astype(np.float32),
                      "b": rng.randn(depth, 24).astype(np.float32)}}
        want = JMP.maple_prompt_stacks(jax.tree.map(jnp.asarray, p), n_layers)
        got = TMP.maple_prompt_stacks(TW.to_device(p, torch.device("cpu")), n_layers)
        for g, w in zip(got, want, strict=True):
            assert tuple(g.shape) == tuple(w.shape)
            _close(g, w, tol=1e-5)
    # the port's own initialisation: the JAX one's shapes and scales
    ti = TMP.init_maple(torch.Generator().manual_seed(0), 2, 12, 512, 768)
    ji = JMP.init_maple(jax.random.key(0), 2, 12, 512, 768)
    for (pa, a), (pb, b) in zip(TO.paths(ti), JO._paths(ji), strict=True):
        assert pa == pb and tuple(a.shape) == tuple(b.shape)
        assert abs(float(a.std()) - float(np.std(b))) <= 0.1 * float(np.std(b)) + 1e-7


@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_eval_embed_matches_jax(models, impl):
    name, jcfg, jp, tcfg, tp = models
    x = _images(1)
    jcv, tcv = _cv(tcfg, 4)
    want = JM.eval_embed(jp, jcfg, jnp.asarray(x), cv_ids=jcv)
    with TL.kernel_impl(impl):
        got = TM.eval_embed(tp, tcfg, torch.from_numpy(x), cv_ids=tcv)
    assert tuple(got.shape) == (4, 64 + 32 + (64 if tcfg.use_jpm else 0))
    _close(got, want)
    feats = TM.encode_image_features(tp, tcfg, torch.from_numpy(x), cv_ids=tcv)
    assert ("jpm" in feats) == tcfg.use_jpm


def test_text_features_match_jax(models):
    name, jcfg, jp, tcfg, tp = models
    labels = np.array([3, 0, 5, 3])
    _close(TM.encode_text_features(tp, tcfg, torch.from_numpy(labels)),
           JM.encode_text_features(jp, jcfg, jnp.asarray(labels)))


def test_forward_train_matches_jax(models):
    name, jcfg, jp, tcfg, tp = models
    x = _images(3, b=6)
    valid = np.array([True] * 5 + [False])
    jcv, tcv = _cv(tcfg, 6)
    want = JM.forward_train(jp, jcfg, jnp.asarray(x), train=True, valid=jnp.asarray(valid),
                            cv_ids=jcv)
    got = TM.forward_train(tp, tcfg, torch.from_numpy(x), train=True,
                           valid=torch.from_numpy(valid), cv_ids=tcv)
    n_levels = 4 if tcfg.use_jpm else 3
    assert len(got["features"]) == len(want["features"]) == n_levels
    assert len(got["cls_scores"]) == len(want["cls_scores"]) == n_levels - 1
    for g, w in zip(got["cls_scores"], want["cls_scores"], strict=True):
        _close(g, w)
    for g, w in zip(got["features"], want["features"], strict=True):
        _close(g, w)
    for bn in (("bn", "bn_proj", "jpm") if tcfg.use_jpm else ("bn", "bn_proj")):
        for k in ("mean", "var"):
            _close(got["bn_stats"][bn][k], want["bn_stats"][bn][k])


def test_stage_partitions_match_jax(models):
    name, jcfg, jp, tcfg, tp = models
    for jpred, tpred in ((JM.stage1_trainable, TM.stage1_trainable),
                         (JM.stage2_trainable, TM.stage2_trainable)):
        jt, _ = JO.partition(jp, lambda p: jpred(p, jcfg))
        tt, _ = TO.partition(tp, lambda p: tpred(p, tcfg))
        jpaths = [p for p, v in JO._paths(jt) if v is not None]
        tpaths = [p for p, v in TO.paths(tt) if v is not None]
        assert tpaths == jpaths, (name, jpred.__name__)
        top = {p[0] for p in tpaths}
        if jpred is JM.stage1_trainable:
            assert ("maple" in top) == (name == "maple")
        else:
            assert "maple" not in top
            assert {"jpm", "jpm_head"} <= top if tcfg.use_jpm else "jpm" not in top
            assert ("sie_embed" in top) == (tcfg.sie_ids > 0)


def test_the_jpm_branch_is_a_copy_of_the_last_block():
    _, _, tcfg, tp = variant_models(**VARIANTS["jpm"])
    last = TL.slice_layer(tp["clip"]["visual"]["blocks"], 1)
    for (_, a), (_, b) in zip(TO.paths(tp["jpm"]["block"]), TO.paths(last), strict=True):
        assert torch.equal(a, b)
    # the port's own init makes its copy too, one that shares no storage
    tokens = np.zeros((1, 12), np.int32)
    tokens[0, :11] = [118, *range(1, 10), 119]
    temb = tp["clip"]["text"]["token_embedding"][torch.from_numpy(tokens).long()]
    fresh = TM.init_reid_model(torch.Generator().manual_seed(0), tcfg, tp["clip"], temb, tokens)
    w = fresh["jpm"]["block"]["attn"]["in_proj"]["w"]
    assert torch.equal(w, last["attn"]["in_proj"]["w"])
    assert w.data_ptr() != last["attn"]["in_proj"]["w"].data_ptr()
    assert tuple(fresh["jpm_head"]["cls"]["w"].shape) == (64, N_CLS)


@pytest.mark.parametrize("group", [1, 3])
@pytest.mark.parametrize("s", [9, 10])
def test_shuffle_unit_matches_jax(group, s):
    x = np.random.RandomState(group + s).randn(2, s, 5).astype(np.float32)
    want = JV.shuffle_unit(jnp.asarray(x), 5, group)
    got = TV.shuffle_unit(torch.from_numpy(x), 5, group)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.is_contiguous()


def test_apply_jpm_matches_jax():
    jcfg, jp, tcfg, tp = variant_models(**VARIANTS["jpm"])
    x = np.random.RandomState(7).randn(3, tcfg.clip.vision.seq_len, 64).astype(np.float32)
    want = JV.apply_jpm(jp["jpm"], jcfg.clip.vision, jnp.asarray(x))
    for impl in ("plain", "kernel"):
        with TL.kernel_impl(impl):
            got = TV.apply_jpm(tp["jpm"], tcfg.clip.vision, torch.from_numpy(x))
        _close(got, want)


def test_sie_ids_are_clipped_and_scaled():
    jcfg, jp, tcfg, tp = variant_models(**VARIANTS["sie"])
    x = torch.from_numpy(_images(4, b=1)).repeat(6, 1, 1, 1)
    ids = torch.tensor([0, 2, 3, 3, 9, 100])  # 4-row table: 9 and 100 clip to 3
    f = TM.encode_image_features(tp, tcfg, x, cv_ids=ids)["proj"]
    _close(f[3:], f[2:3].expand(3, -1).detach().numpy(), tol=1e-6)
    assert float((f[0] - f[1]).abs().max()) > 1e-4  # other rows, other features
    want = JM.encode_image_features(jp, jcfg, jnp.asarray(x.numpy()),
                                    cv_ids=jnp.asarray(ids.numpy()))["proj"]
    _close(f, want)
    # the table's row times sie_coe lands on the CLS token
    zero = dict(tp, sie_embed=torch.zeros_like(tp["sie_embed"]))
    cls_cfg = tcfg.clip.vision
    with_sie = TV.apply_vit(tp["clip"]["visual"], cls_cfg, x[:1],
                            cv_emb=SIE_COE * tp["sie_embed"][2:3])[2][:, 0]
    _close(TM.encode_image_features(tp, tcfg, x[:1], cv_ids=torch.tensor([2]))["proj"],
           with_sie.detach().numpy())
    assert float((TM.encode_image_features(zero, tcfg, x[:1], cv_ids=torch.tensor([2]))["proj"]
                  - with_sie).abs().max()) > 1e-4
    with pytest.raises(ValueError, match="camera ids"):
        TM.encode_image_features(tp, tcfg, x)


def test_jpm_with_a_prompted_tower_is_refused():
    _, _, tcfg, _ = variant_models(mode="maple")
    with pytest.raises(ValueError, match="without vision prompt tokens"):
        TM.ReidModelConfig(mode="maple", clip=tcfg.clip, prompt=tcfg.prompt, use_jpm=True)


def test_converter_checks_the_variant_leaves():
    jcfg, jp, tcfg, tp = variant_models(**VARIANTS["jpm_sie"])
    bad = jax.tree.map(np.asarray, jp)
    bad["sie_embed"] = np.zeros((5, 64), np.float32)
    with pytest.raises(ValueError, match="sie_embed"):
        TW.from_jax_reid_params(bad, tcfg, device="cpu")
    plain = TM.ReidModelConfig(mode="adapter", clip=tcfg.clip, prompt=tcfg.prompt)
    with pytest.raises(ValueError, match="does not use"):
        TW.from_jax_reid_params(jax.tree.map(np.asarray, jp), plain, device="cpu")
    mcfg, mp, mtcfg, _ = variant_models(mode="maple")
    bad = jax.tree.map(np.asarray, mp)
    bad["maple"]["proj"]["w"] = np.zeros((2, 128, 63), np.float32)
    with pytest.raises(ValueError, match="maple.proj"):
        TW.from_jax_reid_params(bad, mtcfg, device="cpu")


def test_block_function_carries_the_gradient_of_a_computed_prompt_plane():
    """MaPLe's vision prompts are text @ proj.w + proj.b, a tensor that
    requires grad but is no leaf: through the block Function (kernel_impl
    "kernel", the kernels' plain versions on the CPU) the stage-1 loss
    reaches proj.w, proj.b, shared_ctx and text_deep with the gradients of
    plain autograd through the plain block (fp32, within 1e-5 of each
    leaf's max). Three vision layers, so that layer 1's spliced plane lies
    inside the block stack on the vision side too."""
    _, _, tcfg, tp = variant_models(mode="maple", vision_layers=3)
    x = torch.from_numpy(_images(6, b=4))
    labels = torch.tensor([0, 0, 3, 3])
    grads = {}
    for impl in ("kernel", "plain"):
        m = tp["maple"]
        tree = {"shared_ctx": m["shared_ctx"], "text_deep": m["text_deep"],
                "proj": {"w": m["proj"]["w"], "b": m["proj"]["b"]}}
        tree = clone(tree)
        leaves = [t.requires_grad_() for _, t in TO.paths(tree)]
        assert len(leaves) == 4
        params = dict(tp, maple=tree)
        with TL.kernel_impl(impl):
            img = TM.encode_image_features(params, tcfg, x)["proj"]
            txt = TM.encode_text_features(params, tcfg, labels)
            loss = (img @ txt.T).square().sum()
        grads[impl] = torch.autograd.grad(loss, leaves)
    for gk, gp in zip(grads["kernel"], grads["plain"], strict=True):
        assert float(gp.abs().max()) > 0
        assert float((gk - gp).abs().max()) <= 1e-5 * float(gp.abs().max())
