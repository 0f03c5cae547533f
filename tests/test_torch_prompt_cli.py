"""The port's prompt-learning CLI against the JAX package's, on a synthetic
Market-1501 directory with a tiny random CLIP checkpoint (--device cpu):
ivlp with --epochs_stage2 0 from the same initial parameters gives equal
metrics in fp32. `assets` and `_argv` are shared with
tests/test_torch_prompt_cli_run.py."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_oracle as oracle
from tpu_reid.tools import synth_market as SM
from tpu_reid_torch.cli import prompt_learning as TCLI
from tpu_reid_torch.models.tokenizer import write_test_merges
from tpu_reid_torch.runtime.checkpoint import CheckpointManager
from tpu_reid_torch.weights import convert as TW


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """A Market1501 directory (4 training identities of 17 images, 5 test
    identities) of 64x32 JPEGs, a tiny OpenAI-format CLIP checkpoint and BPE
    merges."""
    root = tmp_path_factory.mktemp("plcli")
    rng = np.random.RandomState(0)
    SM.write_images(str(root / "Market1501"), rng, n_train_ids=4, n_test_ids=5, n_query=10,
                    n_gallery=30, hw=(64, 32))
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


def test_cli_matches_jax_from_the_same_initial_parameters(assets, monkeypatch, capsys,
                                                          tmp_path):
    """ivlp, one stage-1 epoch (live encoder, the VPT tokens and the prompts
    train), no stage-2 epoch, --rerank, fp32 training and extraction. The
    port's own initialisation draws from torch.Generators, so the JAX CLI's
    initial parameters are carried into the port's build_model
    (from_jax_reid_params); everything after it is each CLI's own."""
    from tpu_reid.cli import prompt_learning as JCLI
    from tpu_reid.parallel import extract as JX

    extra = ("--training_mode", "ivlp", "--epochs_stage1", "1", "--epochs_stage2", "0",
             "--rerank")
    captured = {}
    j_build = JCLI.build_model

    def capture(*a, **k):
        captured["jax"] = out = j_build(*a, **k)
        return out

    j_make = JX.make_extractor
    monkeypatch.setattr(JCLI, "build_model", capture)
    monkeypatch.setattr(JX, "make_extractor",
                        lambda *a, **k: j_make(*a, **dict(k, dtype=jnp.float32)))
    monkeypatch.setattr(sys, "argv", ["prompt_learning", *_argv(assets, tmp_path / "j", *extra)])
    jcmc, jmap = JCLI.main()
    jline = capsys.readouterr().out.strip().splitlines()[-1]

    t_build = TCLI.build_model

    def carried(args, n_cls, car_types=None, device=None, n_sie_ids=0):
        mcfg, _, hw = t_build(args, n_cls, car_types, device, n_sie_ids)
        jp = jax.tree.map(np.asarray, captured["jax"][1])
        return mcfg, TW.from_jax_reid_params(jp, mcfg, device=device), hw

    monkeypatch.setattr(TCLI, "build_model", carried)
    monkeypatch.setattr(TCLI, "EXTRACT_DTYPE", torch.float32)
    tcmc, tmap = TCLI.main(_argv(assets, tmp_path / "t", *extra, "--device", "cpu"))
    out = capsys.readouterr().out
    tline = out.strip().splitlines()[-1]
    assert tcmc.shape == np.asarray(jcmc).shape
    np.testing.assert_allclose(tcmc, np.asarray(jcmc), atol=1e-4)
    assert abs(tmap - float(jmap)) < 1e-4
    assert 0.05 < tmap < 0.999  # the metrics hold something
    assert tline.startswith("Rank@1: ") and tline == jline
    # the end-of-stage checkpoint: epoch 1 + 0, stage 2 done
    mgr = CheckpointManager(str(tmp_path / "t" / "ivlp" / "market1501"))
    assert mgr.latest_epoch() == 1
    saved = mgr.restore()
    mgr.close()
    assert saved["stage"] == 2 and saved["epoch_in_stage"] == -1
    assert "vpt_deep" in saved["params"]["clip"]["visual"]
