"""The port's prompt-learning CLI on its own (--device cpu): a run of both
stages (bf16, fast softmax, --rerank, --eval_every) ends with finite losses
and metrics; --resume after a finished run skips both stages and gives the
same metrics; --keep_best keeps the best evaluated parameters; without
--device it wants the card; the flags the port does not take yet are
refused with their ROADMAP item."""

import numpy as np
import pytest
import torch

from tests.test_torch_prompt_cli import _argv, assets  # noqa: F401  (fixture)
from tpu_reid_torch.cli import prompt_learning as TCLI
from tpu_reid_torch.ops.attention import set_fast_softmax
from tpu_reid_torch.runtime.checkpoint import CheckpointManager


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
    (("--cache_device", "--devices", "2"), "queue 1 item 7"),
    (("--devices", "2"), "queue 1 item 7"),
    (("--multihost", "localhost:1234"), "queue 1 item 7"),
])
def test_cli_refuses_what_is_not_ported(assets, tmp_path, extra, match):
    with pytest.raises(NotImplementedError, match=match):
        TCLI.main(_argv(assets, tmp_path, *extra, "--device", "cpu"))


@pytest.mark.parametrize("flag", ["--resume", "--keep_best"])
def test_cli_runs_what_was_refused(assets, capsys, tmp_path, flag):
    """--resume: a second call on a finished run (1 + 1 epochs) restores
    the final checkpoint, runs no epoch and reproduces the metrics.
    --keep_best with --eval_every 1 (1 + 2 epochs):
    <save_path>/ivlp/market1501/best holds the parameters of the best mAP
    among the evaluated epochs and the final test."""
    argv = _argv(assets, tmp_path, "--training_mode", "ivlp", "--epochs_stage1", "1",
                 "--device", "cpu")
    if flag == "--keep_best":
        argv += ["--epochs_stage2", "2", "--eval_every", "1", flag]
    else:
        argv += ["--epochs_stage2", "1"]
    cmc, mAP = TCLI.main(argv)
    out = capsys.readouterr().out
    if flag == "--resume":
        cmc2, mAP2 = TCLI.main(argv + [flag])
        out = capsys.readouterr().out
        assert "[resume] stage=2 epoch=2" in out
        assert "[stage1] epoch" not in out and "[stage2] epoch" not in out
        assert abs(mAP2 - mAP) < 1e-5
        np.testing.assert_allclose(cmc2, cmc, atol=1e-5)
        return
    mgr = CheckpointManager(str(tmp_path / "ivlp" / "market1501" / "best"))
    best = mgr.restore()
    mgr.close()
    evals = [float(line.split("mAP=")[1].split()[0]) for line in out.splitlines()
             if line.startswith("[eval]")]
    kept = [int(line.split("epoch=")[1].split()[0]) for line in out.splitlines()
            if line.startswith("[best]")]
    assert len(evals) == 1 and kept and kept[-1] == best["epoch"]
    # the logged mAP has 4 significant digits
    assert best["mAP"] >= mAP and best["mAP"] >= evals[0] - 1e-4
    assert set(best["params"]) >= {"clip", "head", "prompt_learner"}
