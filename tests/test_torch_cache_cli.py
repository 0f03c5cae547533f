"""--cache_device in the port's prompt-learning CLI (--device cpu): the
train split held by a DeviceImageCache, the live stage 1 through
run_stage1_live_cached, the coop stage 1 and the precompute from the cache,
stage 2 through run_stage2_cached. The orders and draws are the loader
path's, so each command equals the same command without the flag (cmc and
mAP within 1e-5); --resume after a finished cached run reproduces the
metrics; SIE ids are refused with the JAX CLI's message, more than one
device with ROADMAP.md's item 7."""

import numpy as np
import pytest
import torch

from tests.test_torch_prompt_cli import _argv, assets  # noqa: F401  (fixture)
from tpu_reid_torch.cli import prompt_learning as TCLI


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this file's tiny models: more gain them
    nothing, and the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("mode", ["coop", "ivlp"])
def test_cache_device_changes_no_result(assets, capsys, tmp_path, mode):
    base = _argv(assets, tmp_path / "loader", "--training_mode", mode, "--epochs_stage1", "2",
                 "--epochs_stage2", "2", "--device", "cpu")
    cmc, mAP = TCLI.main(base)
    plain = capsys.readouterr().out
    cached = _argv(assets, tmp_path / "cache", "--training_mode", mode, "--epochs_stage1", "2",
                   "--epochs_stage2", "2", "--device", "cpu", "--cache_device")
    cmc2, mAP2 = TCLI.main(cached)
    out = capsys.readouterr().out
    assert "[cache_device] n=68 mb=0.1" in out and "sharded=False" in out
    assert abs(mAP2 - mAP) < 1e-5
    np.testing.assert_allclose(cmc2, cmc, atol=1e-5)

    def epochs(text):
        return [line.split("] ", 1)[1].split(" lr ")[0] for line in text.splitlines()
                if "[stage1] epoch" in line or "[stage2] epoch" in line]

    assert epochs(out) == epochs(plain) and len(epochs(out)) == 4


def test_cache_device_resumes(assets, capsys, tmp_path):
    """A finished --cache_device run, then the same command with --resume:
    no epoch runs and the metrics come back."""
    argv = _argv(assets, tmp_path, "--training_mode", "ivlp", "--epochs_stage1", "1",
                 "--epochs_stage2", "1", "--device", "cpu", "--cache_device")
    cmc, mAP = TCLI.main(argv)
    capsys.readouterr()
    cmc2, mAP2 = TCLI.main(argv + ["--resume"])
    out = capsys.readouterr().out
    assert "[resume] stage=2 epoch=2" in out
    assert "[stage1] epoch" not in out and "[stage2] epoch" not in out
    assert abs(mAP2 - mAP) < 1e-5
    np.testing.assert_allclose(cmc2, cmc, atol=1e-5)


@pytest.mark.parametrize("sie", ["--sie_camera", "--sie_view"])
def test_cache_device_refuses_sie(assets, tmp_path, sie):
    with pytest.raises(ValueError, match="does not carry SIE side-info ids"):
        TCLI.main(_argv(assets, tmp_path, "--cache_device", sie, "--device", "cpu"))
