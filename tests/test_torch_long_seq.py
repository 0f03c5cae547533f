"""The vehicle geometry (256x256 input, stride 12: a 21x21 patch grid, 442
tokens, 444 with IVLP's two vision prompts) in the port against the JAX
package, on the CPU: mha_core's plain version beyond 256 tokens against the
Pallas kernel in interpret mode, the plain block at 444 tokens with the
splice, a tiny CLIP converted at 256x256 in both packages (weights, extraction
parity), and the zero-shot and prompt-learning CLIs of both packages on a
synthetic VeRi directory."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import tests.torch_oracle as oracle
from tpu_reid.data import datasets as JD
from tpu_reid.data.transforms import DevicePreprocess as JPre
from tpu_reid.models import layers as JL
from tpu_reid.models import vit as JV
from tpu_reid.ops import attention as JA
from tpu_reid.ops import fused_attention as JFA
from tpu_reid.parallel import extract as JX
from tpu_reid.pipelines import zero_shot as JZ
from tpu_reid.weights import convert as JW
from tpu_reid_torch.cli import prompt_learning as TPCLI
from tpu_reid_torch.cli import zero_shot as TCLI
from tpu_reid_torch.data import datasets as TD
from tpu_reid_torch.data.transforms import DevicePreprocess
from tpu_reid_torch.models import layers as TL
from tpu_reid_torch.models import vit as TV
from tpu_reid_torch.models.tokenizer import write_test_merges
from tpu_reid_torch.ops import attention as TA
from tpu_reid_torch.ops import fused_attention as TFA
from tpu_reid_torch.parallel import extract as TX
from tpu_reid_torch.pipelines import zero_shot as TZ
from tpu_reid_torch.weights import convert as TW

ATOL, RTOL = 5e-5, 1e-4  # fp32 block tolerance of tests/test_ops.py
FAST_TOL = 3e-2  # the fast softmax's exp2 clamp, ~3e-2 before normalisation
EMB_TOL = 1e-4  # extraction parity tolerance of __graft_entry__.py
HW, STRIDE = (256, 256), 12


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


# ---------------------------------------------------------------------------
# the attention core and the block beyond 256 tokens
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("s", [257, 300, 442])
def test_mha_core_reference_matches_pallas_interpret_beyond_256(s, masked):
    """S = 257 is the first length of the key-tile kernel, 300 a ragged last
    key tile, 442 the vehicle geometry; the Pallas kernel pads each to a
    multiple of 8."""
    rng = np.random.RandomState(s + masked)
    b, h, dh = 2, 2, 16
    q, k, v = (rng.randn(b, s, h, dh).astype(np.float32) for _ in range(3))
    mask = np.triu(np.full((s, s), -np.inf, np.float32), k=1) if masked else None
    want = JA.mha_core(_j(q), _j(k), _j(v), _j(mask), interpret=True)
    got = TA.mha_core_reference(_t(q), _t(k), _t(v), _t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    # the wrapper on CPU tensors is the plain version and launches nothing
    before = (TA.mha_core.launches, TA.mha_core_long.launches)
    assert torch.equal(TA.mha_core(_t(q), _t(k), _t(v), _t(mask)), got)
    assert before == (TA.mha_core.launches, TA.mha_core_long.launches)
    # fast: the exp2 form before the clamp is exp, equal to the exact form in fp32
    fast = TA.mha_core_reference(_t(q), _t(k), _t(v), _t(mask), fast=True)
    np.testing.assert_allclose(fast.numpy(), got.numpy(), atol=1e-5, rtol=1e-4)


def test_fast_clamp_holds_a_row_of_444_keys():
    """The fast softmax saturates at 2^120: a row of 444 keys overflows its
    fp32 sum only with more than 256 of them at the clamp. With 200 keys
    there (logits far above any real one) the result is finite and the
    saturated keys share the weight."""
    s = 444
    q = torch.zeros(1, s, 1, 64)
    k = torch.zeros(1, s, 1, 64)
    q[..., 0] = 1.0
    k[0, :200, 0, 0] = 8 * 200.0  # scaled score 200: over the clamp of 120 / log2(e)
    v = torch.randn(1, s, 1, 64, generator=torch.Generator().manual_seed(0))
    out = TA.mha_core_reference(q, k, v, fast=True)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out[0, 0, 0], v[0, :200, 0].mean(dim=0), atol=1e-5, rtol=1e-5)


def _block_args(seed, b, s, d, hid):
    rng = np.random.RandomState(seed)
    f = lambda *shape, sc=0.05: (rng.randn(*shape) * sc).astype(np.float32)  # noqa: E731
    args = dict(
        ln1_scale=1 + f(d), ln1_bias=f(d), w_in=f(d, 3 * d), b_in=f(3 * d, sc=0.01),
        w_out=f(d, d), b_out=f(d, sc=0.01), ln2_scale=1 + f(d), ln2_bias=f(d),
        w_fc=f(d, hid), b_fc=f(hid, sc=0.01), w_proj=f(hid, d), b_proj=f(d, sc=0.01),
    )
    pmask = np.zeros((s, 1), np.float32)
    pmask[s - 2:] = 1.0  # vision deep prompts: the last rows
    return f(b, s, d, sc=1.0), args, f(s, d, sc=1.0), pmask


@pytest.mark.parametrize("fast", [False, True])
def test_fused_block_reference_matches_pallas_interpret_at_444_tokens(fast):
    """The whole block at the vehicle IVLP length with the deep-prompt
    splice, narrow width, against the Pallas whole-block kernel."""
    x, args, plane, pmask = _block_args(5 + fast, b=2, s=444, d=32, hid=128)
    want = JFA.fused_block(_j(x), *(_j(v) for v in args.values()), 2, None, block_b=2,
                           interpret=True, fast=fast, prompt_plane=_j(plane),
                           prompt_mask=_j(pmask))
    t = {k: _t(v) for k, v in args.items()}
    got = TFA.fused_block_reference(_t(x), **t, n_heads=2, fast=fast, prompt_plane=_t(plane),
                                    prompt_mask=_t(pmask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FAST_TOL if fast else ATOL,
                               rtol=RTOL)
    # the wrapper chain and the autograd Function on CPU tensors are the plain version
    wrapped = TFA.fused_block_autograd(_t(x), *t.values(), 2, None, prompt_plane=_t(plane),
                                       prompt_mask=_t(pmask), fast=fast)
    assert torch.equal(wrapped, got)


# ---------------------------------------------------------------------------
# a tiny CLIP at 256x256, stride 12, in both packages
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def clip():
    sd = oracle.make_clip_state_dict(np.random.RandomState(0), vision_width=64, vision_layers=2,
                                     patch=16, grid=4, text_width=64, text_layers=2, vocab=530,
                                     context=16, embed_dim=24)
    jcfg, jp = JW.convert_clip(sd, image_hw=HW, stride=STRIDE)
    tcfg, tp = TW.convert_clip(sd, image_hw=HW, stride=STRIDE, device="cpu")
    return dict(sd=sd, jcfg=jcfg, jp=jp, tcfg=tcfg, tp=tp)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        elif v is not None:
            yield prefix + k, v


def test_convert_clip_at_the_vehicle_geometry(clip):
    """A 21x21 grid and 442 tokens in both packages, the position embedding
    resized from the 4x4 pretrained grid to it, every leaf equal; and JAX
    parameters carried across give the same tree."""
    for cfg in (clip["jcfg"], clip["tcfg"]):
        assert (cfg.vision.h_grid, cfg.vision.w_grid, cfg.vision.seq_len) == (21, 21, 442)
    jl, tl = dict(_leaves(clip["jp"])), dict(_leaves(clip["tp"]))
    assert jl.keys() == tl.keys()
    assert tl["visual/positional_embedding"].shape == (442, 64)
    for k in jl:
        np.testing.assert_allclose(tl[k].numpy(), np.asarray(jl[k]), atol=1e-6, err_msg=k)
    carried = TW.from_jax_params(jax.tree.map(np.asarray, clip["jp"]), clip["tcfg"],
                                 device="cpu")
    for k, v in _leaves(carried):
        np.testing.assert_array_equal(v.numpy(), np.asarray(jl[k]), err_msg=k)
    ivlp = TW.infer_config(clip["sd"], image_hw=HW, stride=STRIDE,
                           design=clip["tcfg"].vision.design.__class__(
                               trainer="IVLP", vision_depth=2, vision_ctx=2, language_depth=2,
                               language_ctx=2))
    assert ivlp.vision.seq_len == 444


def _images(seed, n, n_ids=4, src_hw=(272, 264)):
    """Per-identity base images plus noise, stored larger than the model
    input so the antialiased resize runs."""
    rng = np.random.RandomState(seed)
    base = rng.uniform(0, 255, (n_ids, *src_hw, 3))
    pids = np.arange(n) % n_ids
    noise = rng.uniform(0, 255, (n, *src_hw, 3))
    return np.clip(0.4 * base[pids] + 0.6 * noise, 0, 255).astype(np.uint8), pids


@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_extraction_at_the_vehicle_geometry_matches_jax(clip, impl):
    """Flip-TTA extraction with the folded input norm at 442 tokens, fp32:
    embeddings within 1e-4 of the JAX package's."""
    images, _ = _images(1, 6)
    jp = jax.tree.map(jnp.asarray, clip["jp"])
    jfold = lambda p: dict(p, visual=JV.fold_visual_input_norm(p["visual"]))  # noqa: E731
    with JL.attention_impl("xla"):
        jext = JX.make_extractor(JZ.make_zeroshot_embed(jp, clip["jcfg"]),
                                 JPre(HW, "vit", dtype=jnp.float32), dtype=jnp.float32,
                                 fold=jfold)
        want = np.asarray(jext(jp, jnp.asarray(images)))
    tfold = lambda p: dict(p, visual=TV.fold_visual_input_norm(p["visual"]))  # noqa: E731
    with TL.kernel_impl(impl):
        text = TX.make_extractor(TZ.make_zeroshot_embed(clip["tp"], clip["tcfg"]),
                                 DevicePreprocess(HW, "vit", dtype=torch.float32),
                                 dtype=torch.float32, fold=tfold, device="cpu")
        got = text(clip["tp"], torch.from_numpy(images))
    assert tuple(got.shape) == (6, 64 + 24)
    np.testing.assert_allclose(got.numpy(), want, atol=EMB_TOL)


def test_preprocess_at_256x256_matches_jax():
    images, _ = _images(2, 3)
    want = JPre(HW, "vit", dtype=jnp.float32).eval_batch(jnp.asarray(images))
    got = DevicePreprocess(HW, "vit", dtype=torch.float32).eval_batch(torch.from_numpy(images))
    assert tuple(got.shape) == (3, 256, 256, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


# ---------------------------------------------------------------------------
# the zero-shot CLI on a synthetic VeRi directory
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def veri(tmp_path_factory):
    """A VeRi directory of 256x256 JPEGs from the smoke script's writer (4
    test identities of 1 query + 3 gallery images, 4 training identities of
    2), a tiny OpenAI-format CLIP checkpoint (patch 16, 77-token context)
    and BPE merges."""
    root = tmp_path_factory.mktemp("veri")
    nq, ng = chip_smoke.write_veri_dir(str(root), n_ids=4, n_query=1, n_gallery=3, n_train=2)
    sd = oracle.make_clip_state_dict(np.random.RandomState(1), vision_width=64, vision_layers=2,
                                     patch=16, grid=4, text_width=128, text_layers=2, vocab=520,
                                     context=77, embed_dim=32)
    ckpt = str(root / "tiny_clip.pth")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, ckpt)
    merges = str(root / "merges.txt.gz")
    write_test_merges(merges, [("c", "a"), ("ca", "r</w>"), ("v", "a")])
    return {"root": str(root), "ckpt": ckpt, "merges": merges, "nq": nq, "ng": ng}


def test_veri_directory_parses_alike(veri):
    """The smoke script's VeRi writer lays out what both parsers read: the
    same records, viewpoints and car types."""
    got, want = TD.get_dataset(veri["root"], "veri"), JD.get_dataset(veri["root"], "veri")
    assert (got.train, got.query, got.gallery, got.car_types_train) == \
        (want.train, want.query, want.gallery, want.car_types_train)
    assert len(got.query) == veri["nq"] == 4 and len(got.gallery) == veri["ng"] == 12
    assert len(got.train) == 8 and all(got.car_types_train)


@pytest.mark.parametrize("extra", [(), ("--rerank", "--mm")])
def test_zero_shot_cli_on_veri_at_256x256_matches_jax(veri, monkeypatch, capsys, extra):
    """--height 256 --ratio 1.0 --stride 12 --test_dataset veri through both
    CLIs, PIL decoding and fp32 extraction in both (as tests/test_torch_cli.py):
    equal metrics and the same result line."""
    from tpu_reid import native
    from tpu_reid.cli import zero_shot as JCLI

    argv = ["--root", veri["root"], "--model_path", veri["ckpt"], "--bpe_path", veri["merges"],
            "--height", "256", "--ratio", "1.0", "--stride", "12", "--bs", "4",
            "--test_dataset", "veri", *extra]
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(sys, "argv", ["zero_shot", *argv])
    with monkeypatch.context() as m:
        m.setattr(jnp, "bfloat16", jnp.float32)  # the JAX CLI's extraction dtype
        jcmc, jmap = JCLI.main()
    jline = capsys.readouterr().out.strip().splitlines()[-1]
    monkeypatch.setattr(TCLI, "EXTRACT_DTYPE", torch.float32)
    tcmc, tmap = TCLI.main([*argv, "--device", "cpu"])
    tline = capsys.readouterr().out.strip().splitlines()[-1]
    assert tcmc.shape == np.asarray(jcmc).shape == (12,)
    np.testing.assert_allclose(tcmc, np.asarray(jcmc), atol=1e-4)
    assert abs(tmap - float(jmap)) < 1e-4
    assert 0.05 < tmap <= 1.0
    assert tline.startswith("Rank@1: ") and tline == jline


def test_prompt_learning_cli_on_veri_at_256x256_matches_jax(veri, monkeypatch, capsys,
                                                            tmp_path):
    """--train_dataset veri (car-type prompts) in ivlp mode at 444 tokens:
    one live stage-1 epoch of one batch, no stage-2 epoch, fp32 training and
    extraction, from the JAX CLI's initial parameters carried into the
    port's build_model (as tests/test_torch_prompt_cli.py): equal metrics."""
    from tpu_reid import native
    from tpu_reid.cli import prompt_learning as JCLI

    def argv(save):
        return ["--root", veri["root"], "--model_path", veri["ckpt"], "--bpe_path",
                veri["merges"], "--height", "256", "--ratio", "1.0", "--stride", "12",
                "--bs", "8", "--save_path", str(save), "--training_mode", "ivlp",
                "--train_dataset", "veri", "--epochs_stage1", "1", "--epochs_stage2", "0"]

    monkeypatch.setattr(native, "available", lambda: False)
    captured = {}
    j_build, j_make = JCLI.build_model, JX.make_extractor

    def capture(*a, **k):
        captured["jax"] = out = j_build(*a, **k)
        return out

    monkeypatch.setattr(JCLI, "build_model", capture)
    monkeypatch.setattr(JX, "make_extractor",
                        lambda *a, **k: j_make(*a, **dict(k, dtype=jnp.float32)))
    monkeypatch.setattr(sys, "argv", ["prompt_learning", *argv(tmp_path / "j")])
    jcmc, jmap = JCLI.main()
    jline = capsys.readouterr().out.strip().splitlines()[-1]

    t_build = TPCLI.build_model

    def carried(args, n_cls, car_types=None, device=None, n_sie_ids=0):
        mcfg, _, hw = t_build(args, n_cls, car_types, device, n_sie_ids)
        assert mcfg.clip.vision.seq_len == 444 and hw == (256, 256)
        jp = jax.tree.map(np.asarray, captured["jax"][1])
        return mcfg, TW.from_jax_reid_params(jp, mcfg, device=device), hw

    monkeypatch.setattr(TPCLI, "build_model", carried)
    monkeypatch.setattr(TPCLI, "EXTRACT_DTYPE", torch.float32)
    tcmc, tmap = TPCLI.main([*argv(tmp_path / "t"), "--device", "cpu"])
    tline = capsys.readouterr().out.strip().splitlines()[-1]
    assert tcmc.shape == np.asarray(jcmc).shape
    np.testing.assert_allclose(tcmc, np.asarray(jcmc), atol=1e-4)
    assert abs(tmap - float(jmap)) < 1e-4
    assert 0.05 < tmap <= 1.0
    assert tline.startswith("Rank@1: ") and tline == jline
