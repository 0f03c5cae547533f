"""The port's entry points run cuDNN's convolutions in full fp32.

PyTorch lets cuDNN round fp32 convolution operands to TF32 by default
(`torch.backends.cudnn.allow_tf32` is True in a fresh interpreter), so a
standalone fp32 run on the card would compute the patch embed and the
ResNet's convolutions with a 10-bit mantissa where the JAX package and the
port's plain path compute them in fp32. Every `main` of the port,
`entry.entry` and every rank that `parallel/launch.run` spawns clear it
(`device.full_fp32_convs`). Each test starts with the flag set as a fresh
interpreter has it, and a fixture puts back whatever the process had, so no
other test sees it changed.

The CLIs' and tools' mains run with `--device cpu` and their work replaced
by a recorder of the flag (the rank body, or the parity harness): what is
held is the process state that work starts under, and that main leaves
behind. A spawned rank is a fresh interpreter, so two gloo ranks report
their own flag.
"""

import pytest
import torch

from tpu_reid_torch import entry
from tpu_reid_torch.cli import multitask as MT
from tpu_reid_torch.cli import prompt_learning as PL
from tpu_reid_torch.cli import zero_shot as ZS
from tpu_reid_torch.device import full_fp32_convs
from tpu_reid_torch.parallel import launch
from tpu_reid_torch.tools import parity_run as PR
from tpu_reid_torch.tools import runbook_market_parity as RB


@pytest.fixture(autouse=True)
def tf32_as_torch_starts():
    """Each test starts from torch's default (TF32 allowed in cuDNN) and
    leaves the process's flag as it found it."""
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    yield
    torch.backends.cudnn.allow_tf32 = before


def cudnn_tf32_of_rank(mesh):
    """Rank body for launch.run: this rank's flag; a rank other than 0
    raises if its flag is set (launch.run then fails naming it)."""
    if mesh.rank != 0 and torch.backends.cudnn.allow_tf32:
        raise RuntimeError(f"rank {mesh.rank} runs with cuDNN's TF32 on")
    return torch.backends.cudnn.allow_tf32


def test_full_fp32_convs_clears_cudnn_tf32_only():
    matmul = torch.backends.cuda.matmul.allow_tf32
    full_fp32_convs()
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 == matmul is False


CLI_ARGV = ["--model_path", "ckpt.pth", "--bpe_path", "merges.txt", "--device", "cpu"]


@pytest.mark.parametrize("cli, extra", [
    (ZS, []),
    (PL, ["--training_mode", "ivlp"]),
    (MT, ["--variant", "hard_ivlp"]),
], ids=["zero_shot", "prompt_learning", "multitask"])
def test_each_cli_main_runs_its_ranks_with_full_fp32_convs(cli, extra, monkeypatch):
    seen = {}

    def record(fn, args=(), **kw):
        seen["flag"] = torch.backends.cudnn.allow_tf32
        seen["device"] = kw.get("device")
        return [1.0], 1.0

    monkeypatch.setattr(launch, "run", record)
    cli.main(CLI_ARGV + extra)
    assert seen == {"flag": False, "device": "cpu"}
    assert torch.backends.cudnn.allow_tf32 is False


def test_parity_run_main_runs_the_harness_with_full_fp32_convs(monkeypatch):
    seen = {}

    def record(args):
        seen["flag"] = torch.backends.cudnn.allow_tf32
        seen["device"] = args.device
        return 0

    monkeypatch.setattr(PR, "run_parity", record)
    PR.main(["--root", "data", "--model_path", "ckpt.pth", "--device", "cpu"])
    assert seen == {"flag": False, "device": "cpu"}
    assert torch.backends.cudnn.allow_tf32 is False


def test_runbook_main_runs_with_full_fp32_convs(monkeypatch):
    seen = {}

    def record(argv):
        seen["flag"] = torch.backends.cudnn.allow_tf32
        seen["argv"] = argv
        return 0

    monkeypatch.setattr(PR, "main", record)
    RB.main(["--synthetic", "--device", "cpu"])
    assert seen["flag"] is False and seen["argv"][0] == "--synthetic"
    assert torch.backends.cudnn.allow_tf32 is False


def test_the_entry_point_clears_it():
    entry.entry(tiny=True, device="cpu")
    assert torch.backends.cudnn.allow_tf32 is False


def test_spawned_ranks_run_with_full_fp32_convs():
    """launch.run spawns fresh interpreters (torch's default is TF32 on);
    each rank clears the flag before the rank body runs."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the ranks split this process's threads
    try:
        flag = launch.run(cudnn_tf32_of_rank, (), devices=2, device="cpu", timeout_s=120,
                          join_timeout_s=600)
    finally:
        torch.set_num_threads(threads)
    assert flag is False
