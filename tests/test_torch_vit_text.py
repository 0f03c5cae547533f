"""tpu_reid_torch ViT and text towers against tpu_reid's, from one random
OpenAI-format state dict converted by both packages (fp32, JAX on its XLA
path, the port through its plain block and through its kernel wrappers)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_oracle import make_clip_state_dict
from tpu_reid.configs import PromptDesign as JPromptDesign
from tpu_reid.models import clip_model as JC
from tpu_reid.models import layers as JL
from tpu_reid.models import text as JT
from tpu_reid.models import vit as JV
from tpu_reid.weights import convert as JW
from tpu_reid_torch.configs import PromptDesign
from tpu_reid_torch.models import clip_model as TC
from tpu_reid_torch.models import text as TT
from tpu_reid_torch.models import vit as TV
from tpu_reid_torch.ops._build import kernel_impl
from tpu_reid_torch.weights import convert as TW

ATOL = 2e-4  # tests/test_convert.py's full-tower tolerance
IMAGE_HW, STRIDE = (32, 16), 6
IVLP = dict(trainer="IVLP", vision_depth=3, vision_ctx=2, language_depth=2, language_ctx=2)


@pytest.fixture(scope="module")
def models():
    sd = make_clip_state_dict(np.random.RandomState(0), vision_width=128, vision_layers=3,
                              patch=8, grid=4, text_width=64, text_layers=2, vocab=100,
                              context=16, embed_dim=24)
    out = {}
    for name, kw in (("plain", {}), ("ivlp", IVLP)):
        jcfg, jp = JW.convert_clip(sd, image_hw=IMAGE_HW, stride=STRIDE,
                                   design=JPromptDesign(**kw))
        tcfg, tp = TW.convert_clip(sd, image_hw=IMAGE_HW, stride=STRIDE,
                                   design=PromptDesign(**kw), device="cpu")
        out[name] = (jcfg, jax.tree.map(jnp.asarray, jp), tcfg, tp)
    return out


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want), atol=atol, rtol=1e-4)


def _images(seed, n=3):
    return np.random.RandomState(seed).rand(n, *IMAGE_HW, 3).astype(np.float32)


@pytest.mark.parametrize("impl", ["plain", "kernel"])
@pytest.mark.parametrize("cls_only", [False, True])
def test_apply_vit_matches_jax(models, impl, cls_only):
    jcfg, jp, tcfg, tp = models["plain"]
    img = _images(1)
    with JL.attention_impl("xla"):
        want = JV.apply_vit(jp["visual"], jcfg.vision, jnp.asarray(img), cls_only=cls_only)
    with kernel_impl(impl):
        got = TV.apply_vit(tp["visual"], tcfg.vision, torch.from_numpy(img),
                           cls_only=cls_only)
    assert len(got) == 3
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        _close(g, w)


@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_apply_vit_deep_prompts_and_cv_emb(models, impl):
    """IVLP: shallow prompts appended, deep prompts spliced at the END of the
    sequence in layers 1..depth-1 (fused into the block kernels on the
    kernel path), camera embedding added to CLS."""
    jcfg, jp, tcfg, tp = models["ivlp"]
    rng = np.random.RandomState(2)
    cfg = jcfg.vision
    shallow = rng.randn(2, cfg.width).astype(np.float32) * 0.1
    deep = rng.randn(cfg.layers, 2, cfg.width).astype(np.float32) * 0.1
    cv = rng.randn(3, cfg.width).astype(np.float32) * 0.1
    img = _images(3)
    with JL.attention_impl("xla"):
        want = JV.apply_vit(jp["visual"], cfg, jnp.asarray(img), deep_prompts=jnp.asarray(deep),
                            shallow_prompt=jnp.asarray(shallow), cv_emb=jnp.asarray(cv),
                            cls_only=True)
    with kernel_impl(impl):
        got = TV.apply_vit(tp["visual"], tcfg.vision, torch.from_numpy(img),
                           deep_prompts=torch.from_numpy(deep),
                           shallow_prompt=torch.from_numpy(shallow),
                           cv_emb=torch.from_numpy(cv), cls_only=True)
    assert got[0].shape[1] == cfg.seq_len
    for g, w in zip(got, want):
        _close(g, w)


def test_fold_visual_input_norm_matches_jax_and_is_exact(models):
    jcfg, jp, tcfg, tp = models["plain"]
    jf = JV.fold_visual_input_norm(jp["visual"])
    tf = TV.fold_visual_input_norm(tp["visual"])
    _close(tf["conv"]["w"], jf["conv"]["w"], atol=1e-7)
    _close(tf["conv"]["b"], jf["conv"]["b"], atol=1e-6)
    # raw 0..255 images through the folded embed == normalized images
    # through the original one
    u8 = np.random.RandomState(4).randint(0, 256, (2, *IMAGE_HW, 3)).astype(np.float32)
    normed = (u8 / 255.0 - 0.5) / 0.5
    a = TV.patch_embed(tf, tcfg.vision, torch.from_numpy(u8))
    b = TV.patch_embed(tp["visual"], tcfg.vision, torch.from_numpy(normed.astype(np.float32)))
    _close(a, b.numpy(), atol=1e-4)
    with pytest.raises(ValueError):
        TV.fold_visual_input_norm(tf)


@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_encode_text_tokens_matches_jax(models, impl):
    jcfg, jp, tcfg, tp = models["plain"]
    rng = np.random.RandomState(5)
    tokens = np.zeros((3, jcfg.text.context_length), np.int32)
    for i, n in enumerate((4, 7, 11)):
        tokens[i, 0] = 98
        tokens[i, 1:n] = rng.randint(1, 97, n - 1)
        tokens[i, n] = 99  # EOT: the largest id
    want = JC.encode_text(jp, jcfg, jnp.asarray(tokens))
    with kernel_impl(impl):
        got = TC.encode_text(tp, tcfg, torch.from_numpy(tokens))
    assert tuple(got.shape) == (3, 24)
    _close(got, want)


@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_encode_text_embeddings_deep_prompts(models, impl):
    """Prompt-learner path with deep language prompts (keep SOS, replace
    tokens 1..n_ctx) under the causal mask."""
    jcfg, jp, tcfg, tp = models["ivlp"]
    rng = np.random.RandomState(6)
    cfg = jcfg.text
    emb = rng.randn(2, cfg.context_length, cfg.width).astype(np.float32) * 0.02
    eot = np.array([5, 9])
    deep = rng.randn(cfg.layers, 2, cfg.width).astype(np.float32) * 0.1
    with JL.attention_impl("xla"):
        want = JT.encode_text_embeddings(jp["text"], cfg, jnp.asarray(emb), jnp.asarray(eot),
                                         deep_prompts=jnp.asarray(deep))
    with kernel_impl(impl):
        got = TT.encode_text_embeddings(tp["text"], tcfg.text, torch.from_numpy(emb),
                                        torch.from_numpy(eot),
                                        deep_prompts=torch.from_numpy(deep))
    _close(got, want)


def test_encode_image_matches_independent_torch_oracle(models):
    """The port's tower against tests/torch_oracle.py's independent
    nn.functional forward of the same state dict (full sequence)."""
    from tests.torch_oracle import vit_forward

    sd = make_clip_state_dict(np.random.RandomState(0), vision_width=128, vision_layers=3,
                              patch=8, grid=4, text_width=64, text_layers=2, vocab=100,
                              context=16, embed_dim=24)
    # the oracle needs the native grid: 32x32 at stride 8 -> 4x4
    tcfg, tp = TW.convert_clip(sd, image_hw=(32, 32), stride=8, device="cpu")
    img = np.random.RandomState(7).rand(2, 32, 32, 3).astype(np.float32)
    x11, x12, xproj = TC.encode_image(tp, tcfg, torch.from_numpy(img))
    o11, o12, oproj = vit_forward(sd, img.transpose(0, 3, 1, 2).copy(), stride=8,
                                  n_layers=3, n_heads=2)
    for g, w in ((x11, o11), (x12, o12), (xproj, oproj)):
        _close(g, w)
