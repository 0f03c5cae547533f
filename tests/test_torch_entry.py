"""tpu_reid_torch.entry against __graft_entry__: the tiny flagship's
configuration and its eval_embed forward (entry(tiny=True)) on the JAX
flagship's parameters carried across (from_jax_reid_params) within the
extraction parity bound 1e-4 (fp32), the bf16 forward close to it, and
dryrun_multichip over 2 gloo ranks."""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as G
from tpu_reid.models import reid_clip as JM
from tpu_reid_torch import entry
from tpu_reid_torch.weights.convert import from_jax_reid_params


@pytest.fixture(scope="module")
def flagships():
    jcfg, jparams, hw = G._flagship(tiny=True)
    fn, (params, example) = entry.entry(tiny=True, dtype=torch.float32, device="cpu")
    return jcfg, jparams, hw, fn, params, example


def test_tiny_flagship_has_the_jax_geometry(flagships):
    jcfg, _, hw, _, params, example = flagships
    mcfg, _ = entry.flagship("cpu", tiny=True)
    assert example.shape == (8, *hw, 3) and hw == entry.TINY["image_hw"]
    for a, b in ((mcfg.clip.vision, jcfg.clip.vision), (mcfg.clip.text, jcfg.clip.text)):
        for f in ("layers", "width", "heads", "seq_len") if hasattr(b, "seq_len") else (
                "layers", "width", "heads", "vocab_size", "context_length"):
            assert getattr(a, f) == getattr(b, f), f
    assert mcfg.n_cls == jcfg.n_cls == 16 and mcfg.mode == jcfg.mode == "ivlp"


def test_entry_forward_matches_jax(flagships):
    jcfg, jparams, hw, fn, _, example = flagships
    mcfg, _ = entry.flagship("cpu", tiny=True)
    carried = from_jax_reid_params(jax.tree.map(np.asarray, jparams), mcfg, device="cpu")
    images = np.random.default_rng(0).normal(size=(8, *hw, 3)).astype(np.float32)
    want = np.asarray(JM.eval_embed(jparams, jcfg, images))
    got = fn(carried, torch.from_numpy(images))
    assert got.shape == want.shape == (8, 96)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    bf16, _ = entry.entry(tiny=True, device="cpu")  # entry()'s own profile: bf16 activations
    got16 = bf16(carried, torch.from_numpy(images)).float()
    assert torch.isfinite(got16).all()
    assert float((got16 - got).abs().max()) <= 5e-2 * float(got.abs().max())
    assert fn(carried, example).shape == (8, 96)


def test_dryrun_multichip_over_two_ranks(capsys):
    out = entry.dryrun_multichip(2)
    assert out["ranks"] == 2
    assert out["extract_max_abs_diff"] < 1e-4 and out["rerank_max_abs_diff"] < 1e-4
    assert np.isfinite(out["stage1_loss"]) and np.isfinite(out["stage2_loss"])
    assert "-- OK" in capsys.readouterr().out
    with pytest.raises(ValueError, match="at least 2 ranks"):
        entry.dryrun_multichip(1)
