"""The port's multitask CLI (--device cpu) on synthetic Market-1501,
DukeMTMC-reID and VeRi directories with a tiny random CLIP checkpoint: the
hard variant against the JAX package's CLI from the same initial parameters
(fp32, equal metrics within 1e-4); the soft (coop) and hard_ivlp variants
on their own, each resumed after a finished run with the same metrics;
without --device it wants the card; the flag combinations it cannot run
are refused."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_oracle as oracle
from chip_smoke import write_veri_dir
from tpu_reid.tools import synth_market as SM
from tpu_reid_torch.cli import multitask as TCLI
from tpu_reid_torch.data.transforms import DevicePreprocess
from tpu_reid_torch.models.tokenizer import write_test_merges
from tpu_reid_torch.weights import convert as TW


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """Market1501 (4 training identities of 17 images), DukeMTMC-reID (3
    of 17) and VeRi (4 of 4, 64x64) directories, a tiny OpenAI-format CLIP
    checkpoint and BPE merges."""
    root = tmp_path_factory.mktemp("mtcli")
    SM.write_images(str(root / "Market1501"), np.random.RandomState(0), n_train_ids=4,
                    n_test_ids=5, n_query=10, n_gallery=30, hw=(64, 32))
    SM.write_images_duke(str(root / "DukeMTMC-reID"), np.random.RandomState(1),
                         n_train_ids=3, n_test_ids=4, n_query=8, n_gallery=16, hw=(64, 32))
    write_veri_dir(str(root), n_ids=4, n_query=2, n_gallery=4, n_train=4, hw=(64, 64))
    sd = oracle.make_clip_state_dict(
        np.random.RandomState(1), vision_width=64, vision_layers=2, patch=8, grid=4,
        text_width=128, text_layers=2, vocab=520, context=77, embed_dim=32,
    )
    ckpt = str(root / "tiny_clip.pth")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, ckpt)
    merges = str(root / "merges.txt.gz")
    write_test_merges(merges, [("p", "h"), ("ph", "o"), ("o", "f</w>"), ("p", "e")])
    return {"root": str(root), "ckpt": ckpt, "merges": merges}


def _argv(assets, save, *extra):
    return ["--root", assets["root"], "--model_path", assets["ckpt"],
            "--bpe_path", assets["merges"], "--height", "32", "--stride", "8", "--bs", "8",
            "--save_path", str(save), *extra]


def test_hard_cli_matches_jax_from_the_same_initial_parameters(assets, monkeypatch, capsys,
                                                               tmp_path):
    """--variant hard on Market-1501 + DukeMTMC-reID, one epoch of each
    stage, --rerank, fp32 training and extraction. The JAX CLI's initial
    parameters are carried into the port's build_model
    (from_jax_multitask_params); the train augmentation, whose draws come
    from jax.random in one package and torch.Generators in the other, is
    the eval transform in both for this comparison."""
    from tpu_reid.cli import multitask as JCLI
    from tpu_reid.data.transforms import DevicePreprocess as JPre
    from tpu_reid.parallel import extract as JX
    from tpu_reid.train import multitask as JMT

    extra = ("--variant", "hard", "--epochs_stage1", "1", "--epochs_stage2", "1", "--rerank")
    monkeypatch.setattr(JPre, "train_batch", lambda self, images, key, pad_hw=(10, 10):
                        self.eval_batch(images))
    monkeypatch.setattr(DevicePreprocess, "train_batch",
                        lambda self, images, draws, pad_hw=(10, 10): self.eval_batch(images))
    captured = {}
    j_init = JMT.init_multitask_model

    def capture(*a, **k):
        captured["jax"] = out = j_init(*a, **k)
        return out

    j_make = JX.make_extractor
    monkeypatch.setattr(JMT, "init_multitask_model", capture)
    monkeypatch.setattr(JX, "make_extractor",
                        lambda *a, **k: j_make(*a, **dict(k, dtype=jnp.float32)))
    monkeypatch.setattr(sys, "argv", ["multitask", *_argv(assets, tmp_path / "j", *extra)])
    jcmc, jmap = JCLI.main()
    jline = capsys.readouterr().out.strip().splitlines()[-1]

    t_build = TCLI.build_model

    def carried(args, n1, n2, device=None):
        mcfg, _ = t_build(args, n1, n2, device)
        jp = jax.tree.map(np.asarray, captured["jax"])
        return mcfg, TW.from_jax_multitask_params(jp, mcfg, device=device)

    monkeypatch.setattr(TCLI, "build_model", carried)
    monkeypatch.setattr(TCLI, "EXTRACT_DTYPE", torch.float32)
    tcmc, tmap = TCLI.main(_argv(assets, tmp_path / "t", *extra, "--device", "cpu"))
    out = capsys.readouterr().out
    tline = out.strip().splitlines()[-1]
    assert "[mt-stage1] epoch 1/1" in out and "[mt-stage2] epoch 1/1" in out
    assert tcmc.shape == np.asarray(jcmc).shape
    np.testing.assert_allclose(tcmc, np.asarray(jcmc), atol=1e-4)
    assert abs(tmap - float(jmap)) < 1e-4
    assert 0.05 < tmap < 0.999  # the metrics hold something
    assert tline.startswith("Rank@1: ") and tline == jline


@pytest.mark.parametrize("variant,extra", [
    ("soft", ("--training_mode", "coop", "--train_dataset_multitask", "dukemtmc")),
    ("hard_ivlp", ("--train_dataset_multitask", "veri", "--height_multitask", "32",
                   "--ratio_multitask", "1.0", "--dtype", "bf16", "--eval_every", "1",
                   "--keep_best")),
])
def test_cli_runs_and_resumes(assets, capsys, tmp_path, variant, extra):
    """One epoch of stage 1 and two of stage 2, then the same command with
    --resume: both stages are skipped and the metrics come back within
    1e-5. hard_ivlp: dataset 2 is VeRi at 32x32 (a 4x4 grid beside
    Market's 4x2: the second positional embedding), bf16 activations, an
    evaluation after stage-2 epoch 1 and --keep_best."""
    argv = _argv(assets, tmp_path, "--variant", variant, "--epochs_stage1", "1",
                 "--epochs_stage2", "2", *extra, "--device", "cpu")
    cmc, mAP = TCLI.main(argv)
    out = capsys.readouterr().out
    stage1, stage2 = (("[stage1] epoch 1/1", "[stage2] epoch 2/2") if variant == "soft"
                      else ("[mt-stage1] epoch 1/1", "[mt-stage2] epoch 2/2"))
    assert stage1 in out and stage2 in out
    losses = [float(line.split(" loss ")[1].split()[0]) for line in out.splitlines()
              if "/1 loss" in line or "/2 loss" in line]
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert np.isfinite(cmc).all() and 0.0 < mAP <= 1.0
    if "--keep_best" in extra:
        assert "[eval] stage2_epoch=1" in out and "[best] epoch=" in out
    cmc2, mAP2 = TCLI.main(argv + ["--resume"])
    out = capsys.readouterr().out
    assert "[resume] stage=2 epoch=3" in out and " loss " not in out
    assert abs(mAP2 - mAP) < 1e-5
    np.testing.assert_allclose(cmc2, cmc, atol=1e-5)


def test_cli_defaults_to_the_card(assets, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TCLI.main(_argv(assets, tmp_path))


@pytest.mark.parametrize("extra,match", [
    (("--cache_device", "--multihost", "localhost:1234"), "single-process feature"),
    (("--devices", "3"), "--bs 8 must divide by --devices 3"),
    (("--num_hosts", "2"), "--num_hosts > 1 needs --multihost"),
])
def test_cli_refuses_what_is_not_ported(assets, tmp_path, extra, match):
    """--devices and --multihost run (tests/test_torch_multidevice_cli.py);
    what stays refused, with a ValueError: --cache_device across hosts (as
    the JAX CLI asserts), a batch that does not divide by the ranks,
    --num_hosts without an address."""
    with pytest.raises(ValueError, match=match):
        TCLI.main(_argv(assets, tmp_path, *extra, "--device", "cpu"))
