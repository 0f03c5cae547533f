"""The port's prompt-learning CLI with the variants against the JAX
package's CLI, on the synthetic Market-1501 directory and the tiny random
checkpoint of tests/test_torch_prompt_cli.py (--device cpu, fp32 training
and extraction, one stage-1 epoch and no stage-2 epoch, from the JAX CLI's
initial parameters carried across): --training_mode maple; --training_mode
coop --jpm --sie_camera --augmented_prompts; --captions_file. CMC and mAP
within 1e-5. Then --jpm with a prompted tower refused as in JAX, and the SIE
ids. The port's CLI alone runs the variants in
tests/test_torch_variant_cli_run.py."""

import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_prompt_cli import _argv, assets  # noqa: F401  (fixture)
from tpu_reid_torch.cli import prompt_learning as TCLI
from tpu_reid_torch.weights import convert as TW

N_TRAIN_IDS = 4  # the assets' training identities


def _run_both(assets, monkeypatch, capsys, tmp_path, extra):
    """The JAX CLI, then the port's from the JAX CLI's initial parameters;
    returns ((cmc, mAP, result line) of JAX, of the port)."""
    from tpu_reid.cli import prompt_learning as JCLI
    from tpu_reid.parallel import extract as JX

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
    tline = capsys.readouterr().out.strip().splitlines()[-1]
    return (np.asarray(jcmc), float(jmap), jline), (tcmc, float(tmap), tline)


def _captions(tmp_path):
    path = tmp_path / "captions.txt"
    path.write_text("".join(f"{i}: a person in a {c} coat with a bag\n"
                            for i, c in enumerate(("red", "blue", "green", "grey"))))
    return str(path)


@pytest.mark.parametrize("variant", ["maple", "jpm_sie_augmented", "captions"])
def test_cli_variant_matches_jax(assets, monkeypatch, capsys, tmp_path, variant):
    extra = {
        "maple": ("--training_mode", "maple"),
        "jpm_sie_augmented": ("--training_mode", "coop", "--jpm", "--sie_camera",
                              "--sie_coe", "2.0", "--augmented_prompts"),
        "captions": ("--training_mode", "coop", "--captions_file", _captions(tmp_path)),
    }[variant] + ("--epochs_stage1", "1", "--epochs_stage2", "0", "--rerank")
    (jcmc, jmap, jline), (tcmc, tmap, tline) = _run_both(assets, monkeypatch, capsys,
                                                         tmp_path, extra)
    assert tcmc.shape == jcmc.shape
    np.testing.assert_allclose(tcmc, jcmc, atol=1e-5)
    assert abs(tmap - jmap) <= 1e-5
    assert 0.05 < tmap < 0.999  # the metrics hold something
    assert tline == jline


def test_jpm_with_a_prompted_tower_is_refused_as_in_jax(assets, tmp_path, monkeypatch):
    from tpu_reid.cli import prompt_learning as JCLI

    argv = _argv(assets, tmp_path, "--training_mode", "ivlp", "--jpm")
    with pytest.raises(ValueError, match="--jpm requires a prompt-free vision tower"):
        TCLI.main(argv + ["--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["prompt_learning", *argv])
    with pytest.raises(AssertionError, match="--jpm requires a prompt-free vision tower"):
        JCLI.build_model(JCLI.params_parser(), N_TRAIN_IDS)


@pytest.mark.parametrize("camera,view", [(True, False), (False, True), (True, True)])
def test_sie_ids_compose_cameras_and_views(camera, view):
    """The table is cameras x views (either factor alone with one flag);
    ids are camera * n_views + view, the view clipped to the table."""
    recs = [("a", 0, 0, 0), ("b", 1, 5, 2), ("c", 2, 3, 1)]
    ds = SimpleNamespace(train=recs[:1], query=recs[1:2], gallery=recs[2:])
    args = SimpleNamespace(sie_camera=camera, sie_view=view)
    n, ids_of = TCLI.sie_table(args, ds)
    assert n == (6 if camera else 1) * (3 if view else 1)
    batch = SimpleNamespace(pids=np.zeros(3), camids=np.array([0, 5, 2]),
                            seqids=np.array([1, 2, 7]))
    cams = np.array([0, 5, 2]) * (3 if view else 1) if camera else np.zeros(3, np.int64)
    views = np.array([1, 2, 2]) if view else 0
    np.testing.assert_array_equal(ids_of(batch), cams + views)
    assert TCLI.sie_table(SimpleNamespace(sie_camera=False, sie_view=False), ds) == (0, None)
