"""The port's prompt-learning CLI with the variants on its own, on the
synthetic Market-1501 directory and the tiny random checkpoint of
tests/test_torch_prompt_cli.py (--device cpu): both stages of maple and of
--jpm --sie_camera --sie_view in bf16 end with finite losses and metrics,
and a --resume of a MaPLe run from its stage-1 checkpoint reproduces the
straight run."""

import os

import numpy as np
import pytest

from tests.test_torch_prompt_cli import _argv, assets  # noqa: F401  (fixture)
from tpu_reid_torch.cli import prompt_learning as TCLI


@pytest.mark.parametrize("extra", [
    ("--training_mode", "maple"),
    ("--training_mode", "adapter", "--jpm", "--sie_camera", "--sie_view"),
])
def test_cli_trains_both_stages_of_a_variant(assets, capsys, tmp_path, extra):
    cmc, mAP = TCLI.main(_argv(assets, tmp_path, *extra, "--epochs_stage1", "1",
                               "--epochs_stage2", "1", "--dtype", "bf16", "--device", "cpu"))
    out = capsys.readouterr().out
    losses = [float(line.split(" loss ")[1].split()[0]) for line in out.splitlines()
              if "[stage1] epoch" in line or "[stage2] epoch" in line]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert np.isfinite(cmc).all() and 0.0 < mAP <= 1.0


def test_maple_cli_resumes_stage2_from_its_stage1_checkpoint(assets, capsys, tmp_path):
    """A finished MaPLe run (1 + 1 epochs) with its final checkpoint taken
    away: --resume restores the stage-1 checkpoint (couplings included),
    runs stage 2 and reproduces the straight run's metrics."""
    argv = _argv(assets, tmp_path, "--training_mode", "maple", "--epochs_stage1", "1",
                 "--epochs_stage2", "1", "--device", "cpu")
    cmc, mAP = TCLI.main(argv)
    capsys.readouterr()
    ckpt = tmp_path / "maple" / "market1501"
    for name in ("2.pt", "extras_2.pt"):
        if (ckpt / name).exists():
            os.remove(ckpt / name)
    cmc2, mAP2 = TCLI.main(argv + ["--resume"])
    out = capsys.readouterr().out
    assert "[resume] stage=1 epoch=1" in out
    assert "[stage1] epoch" not in out and "[stage2] epoch 1/1" in out
    np.testing.assert_array_equal(cmc2, cmc)
    assert mAP2 == mAP
