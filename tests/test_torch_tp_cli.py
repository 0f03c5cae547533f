"""The port's zero-shot CLI with --tp 2 --device cpu (a world of 2 gloo
ranks on a 1 x 2 mesh, spawned once for the module) against the JAX CLI
with --tp 2 on its virtual CPU devices: fp32 extraction in both, the same
decoder in both (the native C++ decoder, one source, where it builds; PIL
where it does not). The features the evaluation was handed within 1e-4;
CMC, mAP and mINP as printed. Then a 2 x 2 world (--devices 2 --tp 2, 4
gloo ranks: extraction and the streamed re-ranking over the data axis of a
2-D mesh) against the 1 x 2 run, and the TP refusal that only a world can
reach: a ResNet tower."""

import sys

import numpy as np
import pytest
import torch

import tests.torch_oracle as oracle
from tests import torch_dist_workers as W
from tests.test_torch_cli import _argv
from tpu_reid.tools import synth_market as SM
from tpu_reid_torch.models.tokenizer import write_test_merges
from tpu_reid_torch.weights import convert as TW

MODULE = "tpu_reid_torch.cli.zero_shot"


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """A Market1501 directory of 64x32 JPEGs, a tiny OpenAI-format CLIP
    checkpoint with 2 vision heads of 64 (so that --tp 2 divides them), an
    RN checkpoint and BPE merges."""
    root = tmp_path_factory.mktemp("tpcli")
    SM.write_images(str(root / "Market1501"), np.random.RandomState(0), n_train_ids=2,
                    n_test_ids=5, n_query=10, n_gallery=30, hw=(64, 32))
    sd = oracle.make_clip_state_dict(
        np.random.RandomState(1), vision_width=128, vision_layers=2, patch=8, grid=4,
        text_width=128, text_layers=2, vocab=520, context=77, embed_dim=32)
    ckpt = str(root / "tiny_clip.pth")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, ckpt)
    rn = TW.random_clip_state_dict(5, vision="rn50", rn_layers=(1, 1, 1, 1), rn_width=16,
                                   grid=2, text_width=64, text_layers=1, vocab=520,
                                   embed_dim=16)
    rn_ckpt = str(root / "rn_clip.pth")
    torch.save({k: torch.from_numpy(v) for k, v in rn.items()}, rn_ckpt)
    merges = str(root / "merges.txt.gz")
    write_test_merges(merges, [("p", "h"), ("ph", "o"), ("o", "f</w>")])
    return {"root": str(root), "ckpt": ckpt, "rn_ckpt": rn_ckpt, "merges": merges}


@pytest.fixture(scope="module")
def tp_world(assets):
    """The port's CLI runs of the module in one world of 2 gloo ranks."""
    runs = [(MODULE, _argv(assets, *extra, "--tp", "2", "--device", "cpu"), True)
            for extra in ((), ("--rerank", "--mm"))]
    runs.append((MODULE, _argv(dict(assets, ckpt=assets["rn_ckpt"]), "--height", "64", "--tp",
                               "2", "--device", "cpu"), False))
    return W.spawn(W.cli_runs_with_features, runs, devices=1, tp=2)


def _line(cmc, mAP, mINP):
    """The CLI's result line."""
    def rank(k):
        return float(cmc[min(k - 1, len(cmc) - 1)])

    return (f"Rank@1: {rank(1):.4f}, Rank@5: {rank(5):.4f}, Rank@10: {rank(10):.4f}, "
            f"mAP: {float(mAP):.4f}, mINP: {float(mINP):.4f}")


@pytest.mark.parametrize("case,extra", [(0, ()), (1, ("--rerank", "--mm"))])
def test_tp_cli_matches_jax(assets, tp_world, monkeypatch, capsys, case, extra):
    import jax.numpy as jnp

    from tpu_reid.cli import zero_shot as JCLI
    from tpu_reid.pipelines import zero_shot as JZ

    seen = {}
    evaluate = JZ.evaluate_zero_shot

    def keep(qf, gf, *a, **kw):
        seen["q"], seen["g"] = np.asarray(qf), np.asarray(gf)
        seen["metrics"] = out = evaluate(qf, gf, *a, **kw)
        return out

    monkeypatch.setattr(JZ, "evaluate_zero_shot", keep)
    monkeypatch.setattr(sys, "argv", ["zero_shot", *_argv(assets, *extra, "--tp", "2")])
    with monkeypatch.context() as m:
        m.setattr(jnp, "bfloat16", jnp.float32)  # the JAX CLI's extraction dtype
        jcmc, jmap = JCLI.main()
    jline = capsys.readouterr().out.strip().splitlines()[-1]

    status, (tcmc, tmap), got = tp_world[case]
    assert status == "ok"
    for k in ("q", "g"):
        assert got[k].shape == seen[k].shape
        np.testing.assert_allclose(got[k].numpy(), seen[k], atol=1e-4)
    np.testing.assert_allclose(tcmc, np.asarray(jcmc), atol=1e-4)
    assert abs(tmap - float(jmap)) < 1e-4 and 0.05 < tmap < 0.999
    assert _line(*got["metrics"]) == jline and jline.startswith("Rank@1: ")


def test_tp_cli_over_a_2x2_mesh_matches_1x2(assets, tp_world):
    """--devices 2 --tp 2 --rerank --mm: each data index decodes and embeds
    its half of every batch, the streamed re-ranking shards over the data
    axis; the features within 1e-5 and the metrics within 1e-4 of the 1 x 2
    run."""
    argv = _argv(assets, "--rerank", "--mm", "--devices", "2", "--tp", "2", "--device", "cpu")
    ((status, (cmc, mAP), got),) = W.spawn(W.cli_runs_with_features, [(MODULE, argv, True)],
                                           devices=2, tp=2)
    assert status == "ok"
    _, (want_cmc, want_map), want = tp_world[1]
    for k in ("q", "g"):
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=1e-5)
    np.testing.assert_allclose(cmc, want_cmc, atol=1e-4)
    assert abs(mAP - want_map) < 1e-4


def test_tp_cli_refuses_a_resnet_tower(tp_world):
    assert tp_world[2] == ("error", "ValueError: --tp shards the ViT tower only")
