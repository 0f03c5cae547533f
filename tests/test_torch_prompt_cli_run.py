"""The port's prompt-learning CLI on its own (--device cpu): a run of both
stages (bf16, fast softmax, --rerank, --eval_every) ends with finite losses
and metrics; without --device it wants the card; the flags the port does
not take yet are refused with their ROADMAP item."""

import numpy as np
import pytest
import torch

from tests.test_torch_prompt_cli import _argv, assets  # noqa: F401  (fixture)
from tpu_reid_torch.cli import prompt_learning as TCLI
from tpu_reid_torch.ops.attention import set_fast_softmax


def test_cli_trains_both_stages(assets, capsys, tmp_path):
    """Both stages in bf16 activations with the fast softmax, a periodic
    evaluation and re-ranking: finite losses, finite metrics."""
    try:
        cmc, mAP = TCLI.main(_argv(assets, tmp_path, "--training_mode", "ivlp",
                                   "--epochs_stage1", "1", "--epochs_stage2", "2",
                                   "--eval_every", "1", "--dtype", "bf16", "--fast_softmax",
                                   "--rerank", "--device", "cpu"))
    finally:
        set_fast_softmax(False)
    out = capsys.readouterr().out
    losses = [float(line.split(" loss ")[1].split()[0]) for line in out.splitlines()
              if "[stage1] epoch" in line or "[stage2] epoch" in line]
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert "[eval] stage2_epoch=1" in out
    assert np.isfinite(cmc).all() and 0.0 < mAP <= 1.0


def test_pretrained_vpt_overlay_matches_jax(assets, tmp_path):
    """--pretrained_vpt lays a checkpoint's VPT keys over the fresh prompt
    tokens as the JAX CLI does (whole arrays where the shapes match; layers
    the checkpoint lacks are zero), and leaves the rest of the model alone."""
    from tpu_reid.cli import prompt_learning as JCLI

    rng = np.random.RandomState(4)
    vpt = {"visual.VPT": rng.randn(2, 64), "visual.transformer.resblocks.1.VPT_shallow":
           rng.randn(2, 64), "transformer.resblocks.1.VPT_shallow": rng.randn(2, 128)}
    path = str(tmp_path / "vpt.pth")
    torch.save({k: torch.from_numpy(v.astype(np.float32)) for k, v in vpt.items()}, path)
    argv = _argv(assets, tmp_path, "--training_mode", "ivlp", "--pretrained_vpt", path)
    tcfg, tp, _ = TCLI.build_model(TCLI.params_parser(argv + ["--device", "cpu"]), 4,
                                   device="cpu")
    jargs = TCLI.params_parser(argv)  # the same flag values, as JAX's parser reads them
    _, jp, _ = JCLI.build_model(jargs, 4)
    for tower, key in (("visual", "vpt_shallow"), ("visual", "vpt_deep"), ("text", "vpt_deep")):
        np.testing.assert_array_equal(tp["clip"][tower][key].numpy(),
                                      np.asarray(jp["clip"][tower][key]))
    np.testing.assert_array_equal(tp["clip"]["visual"]["vpt_shallow"].numpy(),
                                  vpt["visual.VPT"].astype(np.float32))
    assert float(tp["clip"]["visual"]["vpt_deep"][0].abs().max()) == 0.0
    assert tuple(tp["prompt_learner"]["cls_ctx"].shape) == (4, 4, 128)


def test_cli_defaults_to_the_card(assets, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TCLI.main(_argv(assets, tmp_path))


@pytest.mark.parametrize("extra,match", [
    (("--resume",), "item 21"),
    (("--keep_best",), "item 21"),
    (("--training_mode", "maple"), "item 22"),
    (("--jpm",), "item 23"),
    (("--sie_camera",), "item 23"),
    (("--augmented_prompts",), "item 24"),
    (("--captions_file", "captions.txt"), "item 24"),
    (("--cache_device",), "slice 6"),
    (("--devices", "2"), "slice 7"),
    (("--multihost", "localhost:1234"), "slice 7"),
])
def test_cli_refuses_what_is_not_ported(assets, tmp_path, extra, match):
    with pytest.raises(NotImplementedError, match=match):
        TCLI.main(_argv(assets, tmp_path, *extra, "--device", "cpu"))
