"""The port's zero-shot CLI and its data layer against the JAX package's:
the CLI end to end on a synthetic Market-1501 directory with a tiny random
CLIP checkpoint (with and without --rerank, --device cpu), the dataset
parsers on every synthetic layout, the attribute prompts, the loader, and
the flags the port refuses."""

import os
import sys

import numpy as np
import pytest
import torch

import tests.torch_oracle as oracle
from tpu_reid.data import attributes as JA
from tpu_reid.data import datasets as JD
from tpu_reid.data import loader as JL
from tpu_reid.tools import synth_market as SM
from tpu_reid_torch.cli import zero_shot as TCLI
from tpu_reid_torch.data import attributes as TA
from tpu_reid_torch.data import datasets as TD
from tpu_reid_torch.data import loader as TL
from tpu_reid_torch.models.tokenizer import write_test_merges
from tpu_reid_torch.weights import convert as TW


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """A Market1501 directory of identity-patterned 64x32 JPEGs, a tiny
    OpenAI-format CLIP checkpoint, BPE merges and an attribute .mat."""
    root = tmp_path_factory.mktemp("cli")
    rng = np.random.RandomState(0)
    SM.write_images(str(root / "Market1501"), rng, n_train_ids=2, n_test_ids=5, n_query=10,
                    n_gallery=30, hw=(64, 32))
    sd = oracle.make_clip_state_dict(
        np.random.RandomState(1), vision_width=64, vision_layers=2, patch=8, grid=4,
        text_width=128, text_layers=2, vocab=520, context=77, embed_dim=32,
    )
    ckpt = str(root / "tiny_clip.pth")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, ckpt)
    merges = str(root / "merges.txt.gz")
    write_test_merges(merges, [("p", "h"), ("ph", "o"), ("o", "f</w>")])
    attr = str(root / "market_attribute.mat")
    SM.write_attributes(attr, 7)
    return {"root": str(root), "ckpt": ckpt, "merges": merges, "attr": attr, "sd": sd}


def _argv(assets, *extra):
    return ["--root", assets["root"], "--model_path", assets["ckpt"],
            "--bpe_path", assets["merges"], "--height", "32", "--stride", "8", "--bs", "8",
            "--test_dataset", "market1501", *extra]


@pytest.mark.parametrize("extra", [(), ("--rerank",), ("--rerank", "--mm"),
                                   ("--attributes", "ATTR", "--augmented_template")])
def test_cli_matches_jax(assets, monkeypatch, capsys, extra):
    _check_cli_against_jax(assets, monkeypatch, capsys, extra)


def test_cli_ivlp_with_prompt_tokens_matches_jax(assets, monkeypatch, capsys, tmp_path):
    """--training_mode ivlp with a checkpoint that carries IVLP prompt
    tokens (vision shallow + deep, text deep) runs through the port's
    convert_clip/apply_vit splice like the JAX CLI."""
    rng = np.random.RandomState(3)
    sd = dict(assets["sd"])
    sd["visual.VPT"] = 0.02 * rng.randn(2, 64).astype(np.float32)
    sd["visual.transformer.resblocks.1.VPT_shallow"] = rng.randn(2, 64).astype(np.float32)
    sd["transformer.resblocks.1.VPT_shallow"] = rng.randn(2, 128).astype(np.float32)
    ckpt = str(tmp_path / "ivlp.pth")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, ckpt)
    _check_cli_against_jax(dict(assets, ckpt=ckpt), monkeypatch, capsys,
                           ("--training_mode", "ivlp", "--rerank"))


def _check_cli_against_jax(assets, monkeypatch, capsys, extra):
    """The same flags through both CLIs: CMC and mAP within 1e-4, and the
    same result line.

    Both decode with PIL (the JAX loader's native C++ decoder rounds some
    pixels differently and is not ported yet), and both extract in fp32:
    the two frameworks round bf16 at other points (features differ by up to
    2.3e-2 on a max of 2.7 here, fp32 by 7e-7), which flips near-tied ranks
    of a random tiny model. The bf16 CLI itself runs in
    test_cli_runs_in_bf16."""
    import jax.numpy as jnp

    from tpu_reid import native
    from tpu_reid.cli import zero_shot as JCLI

    monkeypatch.setattr(native, "available", lambda: False)
    extra = [assets["attr"] if e == "ATTR" else e for e in extra]
    monkeypatch.setattr(sys, "argv", ["zero_shot", *_argv(assets, *extra)])
    with monkeypatch.context() as m:
        m.setattr(jnp, "bfloat16", jnp.float32)  # the JAX CLI's extraction dtype
        jcmc, jmap = JCLI.main()
    jline = capsys.readouterr().out.strip().splitlines()[-1]
    monkeypatch.setattr(TCLI, "EXTRACT_DTYPE", torch.float32)
    tcmc, tmap = TCLI.main(_argv(assets, *extra, "--device", "cpu"))
    tline = capsys.readouterr().out.strip().splitlines()[-1]
    assert tcmc.shape == np.asarray(jcmc).shape == (30,)
    np.testing.assert_allclose(tcmc, np.asarray(jcmc), atol=1e-4)
    assert abs(tmap - float(jmap)) < 1e-4
    assert 0.05 < tmap < 0.999  # the metrics hold something
    assert tline.startswith("Rank@1: ") and tline == jline


def test_cli_runs_in_bf16(assets, capsys):
    """The CLI as users run it (bf16 extraction), with re-ranking: a result
    line and metrics in range."""
    cmc, mAP = TCLI.main(_argv(assets, "--rerank", "--mm", "--device", "cpu"))
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line == (f"Rank@1: {cmc[0]:.4f}, Rank@5: {cmc[4]:.4f}, Rank@10: {cmc[9]:.4f}, "
                    f"mAP: {mAP:.4f}, mINP: {line.split('mINP: ')[1]}")
    assert np.isfinite(cmc).all() and 0.05 < mAP < 0.999


def test_cli_defaults_to_the_card(assets, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TCLI.main(_argv(assets))


@pytest.mark.parametrize("extra,match", [
    (("--devices", "2"), "slice 7"),
    (("--tp", "2"), "slice 7"),
    (("--multihost", "localhost:1234"), "slice 7"),
    (("--training_mode", "ivlp"), "train them with tpu_reid_torch.cli.prompt_learning"),
])
def test_cli_refuses_what_is_not_ported(assets, extra, match):
    with pytest.raises(NotImplementedError, match=match):
        TCLI.main(_argv(assets, *extra, "--device", "cpu"))


def test_overlay_and_prefix_helpers_match_jax(assets):
    from tpu_reid.weights import convert as JW

    base = {k: assets["sd"][k] for k in list(assets["sd"])[:6]}
    reid = {"image_encoder.proj": np.ones((2, 2), np.float32),
            "text_encoder.ln_final.weight": np.zeros(3, np.float32),
            "prompt_learner.ctx": np.ones(4, np.float32)}
    got, want = TW.overlay_clip_reid(base, reid), JW.overlay_clip_reid(base, reid)
    assert got.keys() == want.keys() and all(got[k] is want[k] for k in got)
    sd = {"module.a.b": 1, "module.c": 2, "d": 3}
    assert TW.drop_prefix(sd) == JW.drop_prefix(sd) == {"a.b": 1, "c": 2, "d": 3}
    assert TW.strip_prefix(sd, "module.a.") == JW.strip_prefix(sd, "module.a.") == {"b": 1}


def _write_layouts(root):
    """Every dataset family's synthetic layout, with the writers of
    tpu_reid.tools.synth_market (MSMT17-V1 by hand, as tests/test_cli.py)."""
    from PIL import Image

    rng = np.random.RandomState(0)
    hw = (16, 8)
    SM.write_images(os.path.join(root, "Market1501"), rng, 2, 3, 4, 9, hw)
    SM.write_images_duke(os.path.join(root, "DukeMTMC-reID"), rng, 2, 3, 4, 9, hw)
    SM.write_images_veri(os.path.join(root, "VeRi"), rng, 2, 3, 4, 9, hw)
    SM.write_images_msmt(os.path.join(root, "MSMT17_V2"), rng, 2, 3, 4, 9, hw)
    SM.write_images_vehicleid(os.path.join(root, "VehicleID_V1.0"), rng, n_train_ids=2,
                              n_test_ids=3, n_query=6, n_gallery=3, hw=hw)
    SM.write_images_personx(os.path.join(root, "PersonX_v1"), rng, n_train_ids=2,
                            n_test_ids=2, n_query=4, n_gallery=6, hw=hw)
    v1 = os.path.join(root, "MSMT17_V1")
    for sub in ("bounding_box_train", "bounding_box_test"):
        os.makedirs(os.path.join(v1, sub))
    for pid in (1, 2):
        for k in range(3):
            for sub in ("bounding_box_train", "bounding_box_test"):
                Image.fromarray(rng.randint(0, 255, (16, 8, 3), np.uint8)).save(
                    os.path.join(v1, sub, f"{pid:04d}_c{1 + k}_{k:06d}.jpg"))


def test_datasets_match_jax(tmp_path):
    _write_layouts(str(tmp_path))
    names = ("market1501", "dukemtmc", "msmt17", "msmt17_v1", "veri", "vehicleid", "personx")
    for name in names:
        got, want = TD.get_dataset(str(tmp_path), name), JD.get_dataset(str(tmp_path), name)
        assert (got.name, got.train, got.query, got.gallery, got.car_types_train) == \
            (want.name, want.train, want.query, want.gallery, want.car_types_train), name
        assert got.query and got.gallery, name
        assert got.describe() == want.describe()
    a, b = (TD.get_dataset(str(tmp_path), n) for n in ("market1501", "dukemtmc"))
    merged = TD.merge_datasets(a, b)
    want = JD.merge_datasets(*(JD.get_dataset(str(tmp_path), n)
                               for n in ("market1501", "dukemtmc")))
    assert merged.train == want.train and merged.num_train_pids == want.num_train_pids
    with pytest.raises(NotImplementedError):
        TD.get_dataset(str(tmp_path), "cuhk03")


def test_attribute_prompts_match_jax(assets):
    for fn in ("get_prompts", "get_prompts_augmented"):
        assert getattr(TA, fn)(assets["attr"]) == getattr(JA, fn)(assets["attr"]), fn
    ids = [f"{i:04d}" for i in range(5)]
    assert TA.get_prompts_simple(ids, 4) == JA.get_prompts_simple(ids, 4)


def test_loader_batches_match_jax(assets):
    """The PIL decode path: the same fixed-shape batches, padded tail and
    validity mask included; the native decoder is refused."""
    records = TD.get_dataset(assets["root"], "market1501").gallery[:11]
    got = list(TL.BatchLoader(records, 4, (32, 16), num_workers=2))
    want = list(JL.BatchLoader(records, 4, (32, 16), num_workers=2, backend="pil"))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for field in ("images", "pids", "camids", "seqids", "idxs", "valid"):
            np.testing.assert_array_equal(getattr(g, field), getattr(w, field))
    assert got[-1].n_valid == 3
    with pytest.raises(NotImplementedError, match="native"):
        TL.BatchLoader(records, 4, (32, 16), backend="native")
