"""tpu_reid_torch.weights.convert (and the tokenizer and pos-embed resize it
keeps its own copies of) against tpu_reid's on the same state dict."""

import os

import jax
import numpy as np
import pytest
import torch

from tests.torch_oracle import make_clip_state_dict
from tpu_reid.configs import PromptDesign as JPromptDesign
from tpu_reid.models import clip_model as JC
from tpu_reid.models import tokenizer as JTok
from tpu_reid.weights import convert as JW
from tpu_reid_torch.configs import PromptDesign, vit_b16_reid
from tpu_reid_torch.models import clip_model as TC
from tpu_reid_torch.models import tokenizer as TTok
from tpu_reid_torch.weights import convert as TW


def _sd(**kw):
    args = dict(vision_width=64, vision_layers=2, patch=8, grid=4, text_width=64,
                text_layers=2, vocab=100, context=16, embed_dim=24)
    args.update(kw)
    return make_clip_state_dict(np.random.RandomState(0), **args)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


@pytest.mark.parametrize("design", [{}, dict(trainer="IVLP", vision_depth=2, vision_ctx=2,
                                             language_depth=2, language_ctx=2)])
def test_convert_clip_matches_jax_leaf_for_leaf(design):
    sd = _sd()
    if design:  # an IVLP checkpoint's learned prompt tokens
        rng = np.random.RandomState(1)
        sd["visual.VPT"] = rng.randn(2, 64).astype(np.float32)
        sd["visual.transformer.resblocks.1.VPT_shallow"] = rng.randn(2, 64).astype(np.float32)
        sd["transformer.resblocks.1.VPT_shallow"] = rng.randn(2, 64).astype(np.float32)
    jcfg, jp = JW.convert_clip(sd, image_hw=(32, 16), stride=6, design=JPromptDesign(**design))
    tcfg, tp = TW.convert_clip(sd, image_hw=(32, 16), stride=6, design=PromptDesign(**design),
                               device="cpu")
    assert (tcfg.vision.h_grid, tcfg.vision.w_grid, tcfg.vision.seq_len) == (
        jcfg.vision.h_grid, jcfg.vision.w_grid, jcfg.vision.seq_len)
    assert tcfg.text.__dict__.keys() == jcfg.text.__dict__.keys()
    for field in ("layers", "width", "heads", "vocab_size", "context_length", "output_dim"):
        assert getattr(tcfg.text, field) == getattr(jcfg.text, field)
    jl = dict(_leaves(jax.tree.map(np.asarray, jp)))
    tl = dict(_leaves(tp))
    assert jl.keys() == tl.keys()
    for k in jl:
        assert isinstance(tl[k], torch.Tensor) and tl[k].device.type == "cpu"
        np.testing.assert_array_equal(tl[k].numpy(), jl[k], err_msg=k)


def test_from_jax_params_runs_the_same_weights():
    sd = _sd()
    jcfg, jp = JW.convert_clip(sd, image_hw=(32, 16), stride=6)
    tcfg, _ = TW.convert_clip(sd, image_hw=(32, 16), stride=6, device="cpu")
    tp = TW.from_jax_params(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    for k, v in _leaves(tp):
        np.testing.assert_array_equal(v.numpy(), dict(_leaves(jp))[k])
    bad = TW.infer_config(_sd(patch=4), image_hw=(32, 16), stride=6)
    with pytest.raises(ValueError, match="patch-embed"):
        TW.from_jax_params(jax.tree.map(np.asarray, jp), bad, device="cpu")


def test_infer_config_vit_b16_geometry():
    """ViT-B/16 shapes at 256x128, stride 12: a 21x10 grid, 211 tokens."""
    cfg = vit_b16_reid()
    assert (cfg.vision.h_grid, cfg.vision.w_grid, cfg.vision.seq_len) == (21, 10, 211)
    assert cfg.vision.heads == 12 and cfg.text.heads == 8
    sd = TW.random_clip_state_dict(0, vision_width=64, vision_layers=2, text_width=64,
                                   text_layers=1, vocab=50, context=8, embed_dim=16)
    inferred = TW.infer_config(sd, image_hw=(256, 128), stride=12)
    assert (inferred.vision.h_grid, inferred.vision.w_grid) == (21, 10)
    assert inferred.vision.patch_size == 16 and inferred.text.context_length == 8
    jcfg = JW.infer_config(sd, image_hw=(256, 128), stride=12)
    assert inferred.vision.seq_len == jcfg.vision.seq_len
    # without visual.proj a state dict is a ModifiedResNet's, read as JAX reads it
    rn = TW.random_clip_state_dict(0, vision="rn50", rn_layers=(1, 1, 1, 1), rn_width=16,
                                   grid=2, text_width=64, text_layers=1, vocab=50, context=8)
    got, want = TW.infer_config(rn, image_hw=(256, 128)), JW.infer_config(rn, image_hw=(256, 128))
    assert got.vision is None and (got.resnet.h_grid, got.resnet.w_grid) == (16, 8)
    assert (got.resnet.layers, got.resnet.width, got.resnet.output_dim, got.embed_dim) == (
        want.resnet.layers, want.resnet.width, want.resnet.output_dim, want.embed_dim)


def test_random_state_dict_is_seeded_and_openai_shaped():
    a = TW.random_clip_state_dict(3, vision_width=64, vision_layers=1, text_width=64,
                                  text_layers=1, vocab=50, context=8, embed_dim=16)
    b = TW.random_clip_state_dict(3, vision_width=64, vision_layers=1, text_width=64,
                                  text_layers=1, vocab=50, context=8, embed_dim=16)
    ref = _sd(vision_layers=1, text_layers=1, vocab=50, context=8, embed_dim=16, patch=16,
              grid=14)
    assert a.keys() == ref.keys()
    for k in a:
        assert a[k].shape == ref[k].shape and a[k].dtype == np.float32, k
        np.testing.assert_array_equal(a[k], b[k])


def test_resize_pos_embed_copy_matches_jax():
    rng = np.random.RandomState(2)
    pos = rng.randn(1 + 14 * 14, 8).astype(np.float32)
    np.testing.assert_array_equal(TC.resize_pos_embed(pos, 21, 10),
                                  JC.resize_pos_embed(pos, 21, 10))


def test_load_state_dict_reads_plain_and_wrapped_checkpoints(tmp_path):
    sd = _sd()
    for name, obj in (("plain.pth", {k: torch.from_numpy(v) for k, v in sd.items()}),
                      ("wrapped.pth", {"state_dict": {k: torch.from_numpy(v)
                                                      for k, v in sd.items()}})):
        path = os.path.join(tmp_path, name)
        torch.save(obj, path)
        got = TW.load_state_dict(path)
        want = JW.load_state_dict(path)
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])


def test_tokenizer_copy_matches_jax(tmp_path):
    merges = [("a", "b"), ("ab", "c</w>"), ("t", "h"), ("th", "e</w>"), ("p", "e"),
              ("r", "s"), ("o", "n</w>"), ("pe", "rs")]
    path = os.path.join(tmp_path, "merges.txt.gz")
    TTok.write_test_merges(path, merges)
    jt, tt = JTok.ClipTokenizer(path), TTok.ClipTokenizer(path)
    texts = ["the person abc", "a photo of the small person no.12",
             "Café, naïve — 3 ½ émigrés!", "it's"]
    np.testing.assert_array_equal(tt.tokenize(texts, context_length=24, truncate=True),
                                  jt.tokenize(texts, context_length=24, truncate=True))
    assert tt.decode(tt.encode("the person")) == jt.decode(jt.encode("the person"))
    assert tt.vocab_size == jt.vocab_size
