"""The port's ModifiedResNet (RN50-style) tower against the JAX package's,
fp32 on the CPU, from one random OpenAI-format RN state dict
(tests/torch_oracle.make_rn50_state_dict): apply_resnet at layers
(1, 1, 1, 1), width 8, 64x32 within 2e-4 of max|JAX| (by convert_clip and by
from_jax_params), infer_config and the converter (both downsample key
layouts, the attention pool's positional grid resized), the zero-shot
embedding within 1e-4, the zero-shot CLI with an RN checkpoint against the
JAX CLI (mAP within 1e-5), and the stem's XLA "SAME" padding pinned."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import tests.torch_oracle as oracle
from tests.test_torch_cli import _argv, assets  # noqa: F401  (fixture)
from tpu_reid.data import transforms as JT
from tpu_reid.models import clip_model as JC
from tpu_reid.models import resnet as JR
from tpu_reid.pipelines import zero_shot as JZ
from tpu_reid.weights import convert as JW
from tpu_reid_torch.cli import zero_shot as TCLI
from tpu_reid_torch.configs import CLIPConfig, ResNetConfig, TextConfig
from tpu_reid_torch.data import transforms as TT
from tpu_reid_torch.models import clip_model as TC
from tpu_reid_torch.models import resnet as TR
from tpu_reid_torch.pipelines import zero_shot as TZ
from tpu_reid_torch.weights import convert as TW

HW = (64, 32)


def _sd(seed=0, **kw):
    kw = dict(dict(width=8, layers=(1, 1, 1, 1), embed_dim=16), **kw)
    return oracle.make_rn50_state_dict(np.random.RandomState(seed), **kw)


def _images(seed=1, b=2):
    return np.random.RandomState(seed).randn(b, *HW, 3).astype(np.float32)


def _nhwc(t):
    return t.permute(0, 2, 3, 1) if t.dim() == 4 else t


def _rel_close(got, want, tol):
    want = np.asarray(want)
    err = float(np.abs(_nhwc(got).detach().numpy() - want).max())
    assert err <= tol * float(np.abs(want).max()), (err, float(np.abs(want).max()))


@pytest.fixture(scope="module")
def towers():
    sd = _sd()
    jcfg, jp = JW.convert_clip(sd, image_hw=HW)
    tcfg, tp = TW.convert_clip(sd, image_hw=HW, device="cpu")
    return sd, jcfg, jp, tcfg, tp


@pytest.mark.parametrize("route", ["convert_clip", "from_jax_params"])
def test_apply_resnet_matches_jax(towers, route):
    sd, jcfg, jp, tcfg, tp = towers
    if route == "from_jax_params":
        tp = TW.from_jax_params(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    x = _images()
    want = JR.apply_resnet(jp["visual"], jcfg.resnet, jnp.asarray(x))
    got = TR.apply_resnet(tp["visual"], tcfg.resnet, torch.from_numpy(x))
    shapes = [(2, 4, 2, 8 * 4 * 4), (2, 4, 2, 8 * 8 * 4), (2, 1 + 4 * 2, 16)]
    for g, w, shape in zip(got, want, shapes, strict=True):
        assert tuple(_nhwc(g).shape) == tuple(w.shape) == shape
        _rel_close(g, w, 2e-4)
    # the CLIP-level entry point takes the configured tower
    _rel_close(TC.encode_image(tp, tcfg, torch.from_numpy(x))[2], want[2], 2e-4)


def test_infer_config_and_convert_resnet_match_jax(towers):
    sd, jcfg, jp, tcfg, tp = towers
    assert tcfg.vision is None and tcfg.resnet == ResNetConfig(**vars(jcfg.resnet))
    assert tcfg.resnet.heads == jcfg.resnet.heads == 4
    assert tcfg.embed_dim == jcfg.embed_dim == 16
    assert tcfg.text.width == jcfg.text.width and tcfg.text.layers == jcfg.text.layers
    # the attention pool's 2x2 pretrained grid resized to the 4x2 ReID grid
    pos = tp["visual"]["attnpool"]["positional_embedding"]
    assert tuple(pos.shape) == (9, 8 * 32)
    np.testing.assert_allclose(pos.numpy(), jp["visual"]["attnpool"]["positional_embedding"],
                               atol=1e-6)
    # every leaf: the JAX one, conv weights OIHW in the port
    jtree = TW.resnet_from_jax(jax.tree.map(np.asarray, jp["visual"]))
    want = dict(paths_of(jtree))
    got = dict(paths_of(tp["visual"]))
    assert got.keys() == want.keys()
    for k, t in got.items():
        np.testing.assert_array_equal(t.numpy(), want[k], err_msg=str(k))
    assert tuple(tp["visual"]["conv1"]["w"].shape) == (4, 3, 3, 3)
    assert "down_conv" in tp["visual"]["layer1"][0]
    # the other downsample layout, [conv 1x1, bn] at indices 0 and 1
    alt = {k.replace("downsample.1", "downsample.0").replace("downsample.2", "downsample.1"): v
           for k, v in sd.items()}
    _, ap = TW.convert_clip(alt, image_hw=HW, device="cpu")
    for (pa, a), (pb, b) in zip(paths_of(ap["visual"]), paths_of(tp["visual"]), strict=True):
        assert pa == pb and torch.equal(a, b)


def paths_of(tree, prefix=()):
    """(path, leaf) pairs of nested dicts and lists."""
    if isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from paths_of(v, prefix + (i,))
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from paths_of(v, prefix + (k,))
    else:
        yield prefix, tree


def test_the_configs_take_exactly_one_tower():
    with pytest.raises(ValueError, match="exactly one"):
        CLIPConfig(text=TextConfig())
    vit = TW.infer_config(oracle.make_clip_state_dict(np.random.RandomState(0))).vision
    with pytest.raises(ValueError, match="exactly one"):
        CLIPConfig(vision=vit, resnet=ResNetConfig())
    assert ResNetConfig.grid_for((256, 128)) == (16, 8)
    assert ResNetConfig().total_stride == 16 and ResNetConfig().heads == 32


def test_rn50_state_dict_has_openai_rn50_shapes():
    sd = TW.random_clip_state_dict(0, vision="rn50", text_layers=1, vocab=64)
    cfg = TW.infer_config(sd, image_hw=(256, 128))
    assert cfg.resnet == ResNetConfig(layers=(3, 4, 6, 3), width=64, output_dim=1024,
                                      h_grid=16, w_grid=8)
    assert cfg.embed_dim == 1024 and cfg.text.width == 512 and cfg.text.heads == 8
    assert sd["visual.attnpool.positional_embedding"].shape == (50, 2048)
    n = sum(v.size for k, v in sd.items() if k.startswith("visual."))
    assert 38.0e6 < n < 38.5e6  # RN50's visual tower: 38.3 M parameters
    jcfg = JW.infer_config(sd, image_hw=(256, 128))
    assert jcfg.resnet.layers == cfg.resnet.layers and jcfg.embed_dim == cfg.embed_dim
    again = TW.random_clip_state_dict(0, vision="rn50", text_layers=1, vocab=64)
    assert all(np.array_equal(sd[k], again[k]) for k in sd)
    with pytest.raises(ValueError, match="vision"):
        TW.random_clip_state_dict(0, vision="rn101")


def test_zero_shot_embedding_matches_jax(towers):
    """cat(mean of the layer-4 map, the attention-pooled token) on
    preprocessed uint8 images (ImageNet statistics, no fold), within 1e-4."""
    sd, jcfg, jp, tcfg, tp = towers
    u8 = np.random.RandomState(3).randint(0, 256, (3, 80, 40, 3)).astype(np.uint8)
    jx = JT.DevicePreprocess(HW, "rn").eval_batch(jnp.asarray(u8))
    tx = TT.DevicePreprocess(HW, "rn").eval_batch(torch.from_numpy(u8))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-5)
    want = JZ.make_zeroshot_embed(jp, jcfg)(jp, jx)
    got = TZ.make_zeroshot_embed(tp, tcfg)(tp, tx)
    assert tuple(got.shape) == (3, 8 * 32 + 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_the_stem_pads_as_xla_same_not_as_openai():
    """The stride-2 stem conv on an even input: XLA's "SAME" pads (0, 1),
    OpenAI CLIP's nn.Conv2d(padding=1) pads (1, 1). Both packages keep
    XLA's; the two paddings give one shape and other numbers, so a change
    to one package alone shows here."""
    rng = np.random.RandomState(11)
    x = rng.randn(2, 8, 8, 3).astype(np.float32)
    w_hwio = rng.randn(3, 3, 3, 4).astype(np.float32)
    want = JR.conv2d({"w": jnp.asarray(w_hwio)}, jnp.asarray(x), stride=2)
    w = torch.from_numpy(np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1)))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = TR.conv2d({"w": w}, xt, stride=2)
    np.testing.assert_allclose(_nhwc(got).numpy(), np.asarray(want), atol=1e-5)
    assert TR.same_padding(8, 3, 2) == (0, 1) and TR.same_padding(7, 3, 2) == (1, 1)
    assert TR.same_padding(8, 3, 1) == (1, 1) and TR.same_padding(8, 1, 1) == (0, 0)
    openai = F.conv2d(xt, w, stride=2, padding=1)
    assert openai.shape == got.shape
    assert float((openai - got).abs().max()) > 0.5


@pytest.fixture(scope="module")
def rn_ckpt(tmp_path_factory):
    """A small RN checkpoint with the He-scaled convs of
    random_clip_state_dict: the oracle's 0.05-scaled convs shrink the signal
    layer by layer until every image's features agree to 1e-4 and ranks
    tie."""
    sd = TW.random_clip_state_dict(5, vision="rn50", rn_layers=(1, 1, 1, 1), rn_width=16,
                                   grid=2, text_width=64, text_layers=1, vocab=520,
                                   embed_dim=16)
    path = str(tmp_path_factory.mktemp("rn") / "rn_clip.pth")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    return path


@pytest.mark.parametrize("extra", [(), ("--rerank",)])
def test_zero_shot_cli_with_an_rn_checkpoint_matches_jax(assets, rn_ckpt, monkeypatch, capsys,
                                                        extra):
    """Both CLIs on the synthetic Market-1501 directory (64x32) with an RN
    checkpoint, fp32 extraction in both (bf16 rounds at other points in the
    two frameworks), one decoder in both: CMC within 1e-5, mAP within 1e-5
    and the same result line."""
    from tpu_reid.cli import zero_shot as JCLI

    argv = _argv(dict(assets, ckpt=rn_ckpt), "--height", "64", *extra)  # a 4x2 grid
    monkeypatch.setattr(sys, "argv", ["zero_shot", *argv])
    with monkeypatch.context() as m:
        m.setattr(jnp, "bfloat16", jnp.float32)  # the JAX CLI's extraction dtype
        jcmc, jmap = JCLI.main()
    jline = capsys.readouterr().out.strip().splitlines()[-1]
    monkeypatch.setattr(TCLI, "EXTRACT_DTYPE", torch.float32)
    tcmc, tmap = TCLI.main(argv + ["--device", "cpu"])
    tline = capsys.readouterr().out.strip().splitlines()[-1]
    assert tcmc.shape == np.asarray(jcmc).shape == (30,)
    np.testing.assert_allclose(tcmc, np.asarray(jcmc), atol=1e-5)
    assert abs(tmap - float(jmap)) <= 1e-5
    assert 0.05 < tmap < 0.999  # the metrics hold something
    assert tline == jline


def test_zero_shot_cli_runs_an_rn_checkpoint_in_bf16(assets, rn_ckpt):
    cmc, mAP = TCLI.main(_argv(dict(assets, ckpt=rn_ckpt), "--height", "64", "--mm",
                               "--device", "cpu"))
    assert np.isfinite(cmc).all() and 0.0 < mAP <= 1.0


def test_clip_model_encode_image_takes_the_vit_too():
    sd = oracle.make_clip_state_dict(np.random.RandomState(0))
    cfg, p = TW.convert_clip(sd, image_hw=(32, 32), stride=8, device="cpu")
    jcfg, jp = JW.convert_clip(sd, image_hw=(32, 32), stride=8)
    x = np.random.RandomState(2).randn(2, 32, 32, 3).astype(np.float32)
    got = TC.encode_image(p, cfg, torch.from_numpy(x))
    want = JC.encode_image(jp, jcfg, jnp.asarray(x))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=1e-4)
