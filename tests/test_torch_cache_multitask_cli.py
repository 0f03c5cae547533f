"""--cache_device in the port's multitask CLI (--device cpu): one
DeviceImageCache per (dataset, size), stage 2's PK batches gathered there
with the loader path's orders and draws, stage 1 on the loader as in the
JAX package. The hard variant on Market-1501 + DukeMTMC-reID and the
hard_ivlp variant on Market-1501 + VeRi at its own size equal the same
commands without the flag (cmc and mAP within 1e-5)."""

import numpy as np
import pytest
import torch

from tests.test_torch_multitask_cli import _argv, assets  # noqa: F401  (fixture)
from tpu_reid_torch.cli import multitask as TCLI


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this file's tiny models: more gain them
    nothing, and the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("extra,caches", [
    (("--variant", "hard", "--train_dataset_multitask", "dukemtmc"), 2),
    (("--variant", "hard_ivlp", "--train_dataset_multitask", "veri", "--height_multitask", "32",
      "--ratio_multitask", "1.0"), 2),
])
def test_cache_device_changes_no_result(assets, capsys, tmp_path, extra, caches):
    common = ("--epochs_stage1", "1", "--epochs_stage2", "2", *extra, "--device", "cpu")
    cmc, mAP = TCLI.main(_argv(assets, tmp_path / "loader", *common))
    plain = capsys.readouterr().out
    cmc2, mAP2 = TCLI.main(_argv(assets, tmp_path / "cache", *common, "--cache_device"))
    out = capsys.readouterr().out
    assert out.count("[cache_device] dataset=") == caches
    assert abs(mAP2 - mAP) < 1e-5
    np.testing.assert_allclose(cmc2, cmc, atol=1e-5)

    def epochs(text):
        return [line for line in text.splitlines() if "/1 loss" in line or "/2 loss" in line]

    assert epochs(out) == epochs(plain) and len(epochs(out)) == 3
