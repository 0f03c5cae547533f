"""The port's CLIs over several ranks (--devices 2 --device cpu: two gloo
ranks; --multihost: two host processes meeting at a TCP address on
localhost) against the JAX package's zero-shot CLI with --devices 2 on its
virtual CPU devices (fp32 extraction in both, as tests/test_torch_cli.py
holds the single-device CLIs) and against the port's own single-device runs
(bf16, as users run them): the zero-shot CLI with --rerank, the
prompt-learning CLI (ivlp, one epoch per stage, with and without
--cache_device, then --resume under --devices 2), and the multitask CLI
(hard_ivlp with --cache_device). The --devices 2 runs share one spawned
world of two ranks, in which each goes through its CLI's main in turn
(tests/torch_dist_workers.cli_mains); the --multihost run is its own world
of two host processes."""

import multiprocessing as mp
import os
import sys

import numpy as np
import pytest
import torch

import tests.torch_oracle as oracle
from tests import torch_dist_workers as W
from tests.test_torch_cli import _argv as zs_argv
from tests.test_torch_multitask_cli import _argv as mt_argv
from tests.test_torch_prompt_cli import _argv as pl_argv
from tpu_reid.tools import synth_market as SM
from tpu_reid_torch.cli import multitask as MCLI
from tpu_reid_torch.cli import prompt_learning as PCLI
from tpu_reid_torch.cli import zero_shot as ZCLI
from tpu_reid_torch.models.tokenizer import write_test_merges
from tpu_reid_torch.parallel import launch


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """The directories of tests/test_torch_prompt_cli.py and
    test_torch_multitask_cli.py: Market1501 (4 training identities of 17
    64x32 JPEGs, 5 test identities) and DukeMTMC-reID (3 of 17), a tiny
    OpenAI-format CLIP checkpoint and BPE merges."""
    root = tmp_path_factory.mktemp("multicli")
    SM.write_images(str(root / "Market1501"), np.random.RandomState(0), n_train_ids=4,
                    n_test_ids=5, n_query=10, n_gallery=30, hw=(64, 32))
    SM.write_images_duke(str(root / "DukeMTMC-reID"), np.random.RandomState(1),
                         n_train_ids=3, n_test_ids=4, n_query=8, n_gallery=16, hw=(64, 32))
    sd = oracle.make_clip_state_dict(
        np.random.RandomState(1), vision_width=64, vision_layers=2, patch=8, grid=4,
        text_width=128, text_layers=2, vocab=520, context=77, embed_dim=32)
    ckpt = str(root / "tiny_clip.pth")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, ckpt)
    merges = str(root / "merges.txt.gz")
    write_test_merges(merges, [("p", "h"), ("ph", "o"), ("o", "f</w>"), ("p", "e")])
    return {"root": str(root), "ckpt": ckpt, "merges": merges}


@pytest.fixture(autouse=True)
def one_thread():
    """The ranks split this process's intra-op threads (parallel/launch.py):
    one each, so that two ranks of six pytest workers do not oversubscribe."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def two_ranks(assets, tmp_path_factory):
    """Every --devices 2 --device cpu run of the module, in order, in one
    world of two gloo ranks: rank 0's (cmc, mAP) of each, by name."""
    save = tmp_path_factory.mktemp("multi")
    pl = ["--training_mode", "ivlp", "--epochs_stage1", "1", "--epochs_stage2", "1",
          "--rerank", "--device", "cpu", "--devices", "2"]
    pl_devices = pl_argv(assets, save / "devices", *pl)
    runs = {
        "zs_fp32": ("zero_shot", zs_argv(assets, "--rerank", "--devices", "2", "--device",
                                         "cpu"), True),
        "zs": ("zero_shot", zs_argv(assets, *ZS_FLAGS, "--devices", "2"), False),
        "pl_devices": ("prompt_learning", pl_devices, False),
        "pl_resume": ("prompt_learning", pl_devices + ["--resume"], False),
        "pl_cache": ("prompt_learning", pl_argv(assets, save / "cache", *pl, "--cache_device"),
                     False),
        "mt_cache": ("multitask", mt_argv(assets, save / "mt", *MT_FLAGS, "--devices", "2",
                                          "--cache_device"), False),
    }
    got = W.spawn(W.cli_mains, [(f"tpu_reid_torch.cli.{m}", a, fp32)
                                for m, a, fp32 in runs.values()])
    return dict(zip(runs, got)), save


ZS_FLAGS = ("--rerank", "--mm", "--device", "cpu")
MT_FLAGS = ("--variant", "hard_ivlp", "--train_dataset", "market1501",
            "--train_dataset_multitask", "dukemtmc", "--epochs_stage1", "1",
            "--epochs_stage2", "1", "--device", "cpu")


def test_zero_shot_over_two_ranks_matches_jax(assets, two_ranks, monkeypatch):
    """--devices 2 --rerank in both packages, fp32 extraction: CMC and mAP
    within 1e-4."""
    import jax.numpy as jnp

    from tpu_reid.cli import zero_shot as JCLI

    argv = zs_argv(assets, "--rerank", "--devices", "2")
    monkeypatch.setattr(sys, "argv", ["zero_shot", *argv])
    with monkeypatch.context() as m:
        m.setattr(jnp, "bfloat16", jnp.float32)
        jcmc, jmap = JCLI.main()
    tcmc, tmap = two_ranks[0]["zs_fp32"]
    np.testing.assert_allclose(tcmc, np.asarray(jcmc), atol=1e-4)
    assert abs(tmap - float(jmap)) < 1e-4 and 0.05 < tmap < 0.999


def _hosts(module, argv, out_dir, n=2):
    """`module`.main(argv + --multihost) in n host processes; host 0's
    result."""
    addr = f"127.0.0.1:{launch.free_port()}"
    ctx = mp.get_context("spawn")
    out = os.path.join(out_dir, "host0.pt")
    procs = [ctx.Process(target=W.cli_host, args=(module, argv + [
        "--multihost", addr, "--num_hosts", str(n), "--host_id", str(h)], out))
        for h in range(n)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=300)
    assert [p.exitcode for p in procs] == [0] * n
    return torch.load(out, weights_only=False)


def test_zero_shot_devices_and_multihost_match_one_device(assets, two_ranks, tmp_path):
    """The CLI as users run it (bf16 extraction, --rerank --mm): --devices 2,
    and --multihost over two host processes, give the single-device CMC and
    mAP (within 1e-4: each rank's matmuls sum a batch of 4 rows where one
    device sums 8)."""
    argv = zs_argv(assets, *ZS_FLAGS)
    cmc, mAP = ZCLI.main(argv)
    for got in (two_ranks[0]["zs"],
                _hosts("tpu_reid_torch.cli.zero_shot", argv, str(tmp_path))):
        np.testing.assert_allclose(got[0], cmc, atol=1e-4)
        assert abs(got[1] - mAP) < 1e-4


def test_prompt_learning_over_two_ranks_matches_one_device(assets, two_ranks, tmp_path):
    """Both stages over two ranks (the global batch's loss on both, the
    averaged gradient): the single-device metrics within 1e-4, with the
    train split in a cache sharded over the ranks too; rank 0 alone wrote
    the checkpoints."""
    runs, save = two_ranks
    cmc, mAP = PCLI.main(pl_argv(assets, tmp_path, "--training_mode", "ivlp",
                                 "--epochs_stage1", "1", "--epochs_stage2", "1", "--rerank",
                                 "--device", "cpu"))
    for kind in ("pl_devices", "pl_cache"):
        np.testing.assert_allclose(runs[kind][0], cmc, atol=1e-4)
        assert abs(runs[kind][1] - mAP) < 1e-4, kind
    files = sorted(os.listdir(save / "devices" / "ivlp" / "market1501"))
    assert files == ["1.pt", "2.pt"]  # the end of each stage, written once


def test_prompt_learning_resumes_over_two_ranks(two_ranks):
    """--resume under --devices 2 after a finished run: every rank restores
    the same files (their leaves checked identical), both stages are
    skipped, the metrics are the straight run's."""
    runs, _ = two_ranks
    np.testing.assert_allclose(runs["pl_resume"][0], runs["pl_devices"][0], atol=1e-6)
    assert abs(runs["pl_resume"][1] - runs["pl_devices"][1]) < 1e-6


def test_multitask_over_two_ranks_matches_one_device(assets, two_ranks, tmp_path):
    """hard_ivlp on Market-1501 + DukeMTMC-reID with --cache_device, one
    epoch per stage, over two ranks: the single-device metrics within 1e-4."""
    cmc, mAP = MCLI.main(mt_argv(assets, tmp_path / "single", *MT_FLAGS))
    got = two_ranks[0]["mt_cache"]
    np.testing.assert_allclose(got[0], cmc, atol=1e-4)
    assert abs(got[1] - mAP) < 1e-4
