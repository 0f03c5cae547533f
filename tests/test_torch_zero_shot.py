"""The whole slice: zero-shot classifier -> flip-TTA fold extraction ->
evaluate_zero_shot(multimodal=True), tpu_reid_torch against tpu_reid on one
random state dict; and the port's hygiene (no JAX, no tpu_reid; entry points
refuse to fall back to the CPU)."""

import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_oracle import make_clip_state_dict
from tpu_reid.data.transforms import DevicePreprocess as JPre
from tpu_reid.models import layers as JL
from tpu_reid.models import tokenizer as JTok
from tpu_reid.models import vit as JV
from tpu_reid.parallel import extract as JX
from tpu_reid.pipelines import zero_shot as JZ
from tpu_reid.weights import convert as JW
from tpu_reid_torch.data.transforms import DevicePreprocess
from tpu_reid_torch.models import tokenizer as TTok
from tpu_reid_torch.models import vit as TV
from tpu_reid_torch.ops._build import kernel_impl
from tpu_reid_torch.parallel import extract as TX
from tpu_reid_torch.pipelines import zero_shot as TZ
from tpu_reid_torch.weights import convert as TW

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EMB_TOL = 1e-4  # extraction parity tolerance of __graft_entry__.py
TEMPLATES = ("itap of a {}", "a bad photo of the {}", "a photo of the small {}")
N_IDS, HW = 6, (32, 16)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    merges = str(tmp_path_factory.mktemp("bpe") / "merges.txt")
    TTok.write_test_merges(merges, [("p", "e"), ("pe", "r"), ("s", "o"), ("n", "</w>"),
                                    ("t", "h"), ("th", "e</w>")])
    sd = make_clip_state_dict(np.random.RandomState(0), vision_width=64, vision_layers=2,
                              patch=8, grid=4, text_width=64, text_layers=2, vocab=530,
                              context=16, embed_dim=24)
    jcfg, jp = JW.convert_clip(sd, image_hw=HW, stride=6)
    tcfg, tp = TW.convert_clip(sd, image_hw=HW, stride=6, device="cpu")
    ids = [str(i) for i in range(N_IDS)]
    aug = {i: [t.format(f"person no.{i}") for t in TEMPLATES] for i in ids}
    simple = {i: f"a photo of person no.{i}" for i in ids}
    return dict(jcfg=jcfg, jp=jax.tree.map(jnp.asarray, jp), tcfg=tcfg, tp=tp, ids=ids,
                aug=aug, simple=simple, jtok=JTok.ClipTokenizer(merges),
                ttok=TTok.ClipTokenizer(merges))


@pytest.mark.parametrize("augmented", [False, True])
@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_zeroshot_classifier_matches_jax(setup, augmented, impl):
    s = setup
    templates = s["aug"] if augmented else s["simple"]
    want = JZ.zeroshot_classifier(s["jp"], s["jcfg"], s["jtok"], s["ids"], templates,
                                  augmented=augmented, batch=4)
    with kernel_impl(impl):
        got = TZ.zeroshot_classifier(s["tp"], s["tcfg"], s["ttok"], s["ids"], templates,
                                     augmented=augmented, batch=4, device="cpu")
    assert tuple(got.shape) == (N_IDS, 24)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def _data(seed, n_q=8, n_g=24, src_hw=(40, 20)):
    """Per-identity base images plus noise, stored larger than the model
    input so the antialiased resize runs."""
    rng = np.random.RandomState(seed)
    base = rng.uniform(0, 255, (N_IDS, *src_hw, 3))
    qp, gp = np.arange(n_q) % N_IDS, np.arange(n_g) % N_IDS

    def draw(p):
        return np.clip(0.4 * base[p] + 0.6 * rng.uniform(0, 255, (len(p), *src_hw, 3)),
                       0, 255).astype(np.uint8)

    return draw(qp), qp, np.zeros(n_q, np.int64), draw(gp), gp, 1 + rng.randint(0, 3, n_g)


def _batches(images, pids, cams, bs):
    out = []
    for i in range(0, len(images), bs):
        n = len(images[i:i + bs])
        valid = np.ones(bs, bool)
        valid[n:] = False

        def pad(a):
            return np.concatenate([a[i:i + bs], np.zeros((bs - n,) + a.shape[1:], a.dtype)])

        out.append(SimpleNamespace(images=pad(images), pids=pad(pids), camids=pad(cams),
                                   seqids=np.zeros(bs, np.int64), idxs=np.arange(bs),
                                   valid=valid))
    return out


@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_slice_matches_jax(setup, impl):
    """classifier -> flip-TTA fold extraction (a padded tail batch) ->
    multimodal CMC/mAP/mINP: embeddings within 1e-4, metrics equal."""
    s = setup
    qi, qp, qc, gi, gp, gc = _data(1)
    zs_j = JZ.zeroshot_classifier(s["jp"], s["jcfg"], s["jtok"], s["ids"], s["aug"],
                                  augmented=True, batch=4)
    jfold = lambda p: dict(p, visual=JV.fold_visual_input_norm(p["visual"]))  # noqa: E731
    with JL.attention_impl("xla"):
        jext = JX.make_extractor(JZ.make_zeroshot_embed(s["jp"], s["jcfg"]),
                                 JPre(HW, "vit", dtype=jnp.float32), dtype=jnp.float32,
                                 fold=jfold)
        jq = JX.extract_embeddings(jext, s["jp"], _batches(qi, qp, qc, 5))
        jg = JX.extract_embeddings(jext, s["jp"], _batches(gi, gp, gc, 5))
    want = JZ.evaluate_zero_shot(jq[0], jg[0], jq[1], jg[1], jq[2], jg[2], zs_weights=zs_j,
                                 proj_dim=24, multimodal=True, with_minp=True)

    tfold = lambda p: dict(p, visual=TV.fold_visual_input_norm(p["visual"]))  # noqa: E731
    with kernel_impl(impl):
        zs_t = TZ.zeroshot_classifier(s["tp"], s["tcfg"], s["ttok"], s["ids"], s["aug"],
                                      augmented=True, batch=4, device="cpu")
        text = TX.make_extractor(TZ.make_zeroshot_embed(s["tp"], s["tcfg"]),
                                 DevicePreprocess(HW, "vit", dtype=torch.float32),
                                 dtype=torch.float32, fold=tfold, device="cpu")
        tq = TX.extract_embeddings(text, s["tp"], _batches(qi, qp, qc, 5), device="cpu")
        tg = TX.extract_embeddings(text, s["tp"], _batches(gi, gp, gc, 5), device="cpu")
    assert tuple(tq[0].shape) == (8, 64 + 24) and tuple(tg[0].shape) == (24, 64 + 24)
    for t, j in ((tq, jq), (tg, jg)):
        np.testing.assert_allclose(t[0].numpy(), np.asarray(j[0]), atol=EMB_TOL)
        for a, b in zip(t[1:], j[1:]):
            np.testing.assert_array_equal(a, b)
    got = TZ.evaluate_zero_shot(tq[0], tg[0], tq[1], tg[1], tq[2], tg[2], zs_weights=zs_t,
                                proj_dim=24, multimodal=True, with_minp=True, device="cpu")
    np.testing.assert_allclose(got[0], np.asarray(want[0]), atol=1e-6)
    assert abs(got[1] - want[1]) < 1e-6 and abs(got[2] - want[2]) < 1e-6
    assert 0.05 < got[1] < 0.999  # the metrics hold something


def test_scan_extractor_is_the_step_in_a_loop(setup):
    s = setup
    qi = _data(2)[0][:8].reshape(2, 4, 40, 20, 3)
    embed = TZ.make_zeroshot_embed(s["tp"], s["tcfg"])
    pp = DevicePreprocess(HW, "vit", dtype=torch.float32)
    fold = lambda p: dict(p, visual=TV.fold_visual_input_norm(p["visual"]))  # noqa: E731
    step = TX.make_extractor(embed, pp, dtype=torch.float32, fold=fold, device="cpu")
    scan = TX.make_scan_extractor(embed, pp, dtype=torch.float32, fold=fold, device="cpu")
    got = scan(s["tp"], torch.from_numpy(qi))
    assert tuple(got.shape) == (2, 4, 88)
    for k in range(2):
        torch.testing.assert_close(got[k], step(s["tp"], torch.from_numpy(qi[k])))


def test_entry_points_refuse_to_fall_back_to_the_cpu(setup, monkeypatch):
    """Without device="cpu" the entry points want CUDA, and raise without it."""
    s = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    embed = TZ.make_zeroshot_embed(s["tp"], s["tcfg"])
    pp = DevicePreprocess(HW)
    sd = make_clip_state_dict(np.random.RandomState(0), vision_layers=1, text_layers=1)
    feats = torch.zeros(2, 88)
    calls = [
        lambda: TX.make_extractor(embed, pp),
        lambda: TX.make_scan_extractor(embed, pp),
        lambda: TX.extract_embeddings(lambda p, x: x, s["tp"], []),
        lambda: TZ.zeroshot_classifier(s["tp"], s["tcfg"], s["ttok"], s["ids"], s["simple"],
                                       augmented=False),
        lambda: TW.convert_clip(sd),
        lambda: TW.from_jax_params({}, s["tcfg"]),
        lambda: TZ.evaluate_zero_shot(feats, feats, [0, 1], [0, 1], [0, 0], [1, 1]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_port_imports_neither_jax_nor_tpu_reid(tmp_path):
    """Every tpu_reid_torch module (the re-ranking modules, the data layer,
    the zero-shot, prompt-learning and multitask CLIs, the ReID model, the
    trainers, the multitask trainers and XBM, the checkpoints, tensor
    parallelism, the tools, the entry points and the native decoder
    included) and chip_smoke import with JAX made
    unimportable, and load no tpu_reid module; chip_smoke run on a machine
    without a card, or alone without the package, prints no result and
    exits non-zero."""
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "import tpu_reid_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(tpu_reid_torch.__path__, "
        "'tpu_reid_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'tpu_reid' or m.startswith('tpu_reid.')]\n"
        "assert not bad, bad\n"
        "need = {'cli.zero_shot', 'ops.minsum', 'retrieval.rerank', 'retrieval.rerank_stream', "
        "'runtime.observe', 'data.attributes', 'data.datasets', 'data.loader', "
        "'cli.prompt_learning', 'models.heads', 'models.prompts', 'models.reid_clip', "
        "'train.losses', 'train.optim', 'train.schedules', 'train.trainer', "
        "'data.sampler', 'runtime.guard', 'runtime.checkpoint', 'train.xbm', "
        "'train.multitask', 'cli.multitask', 'parallel.tp', 'tools.synth_market', "
        "'tools.parity_run', 'tools.caption_prompts', 'tools.runbook_market_parity', "
        "'entry', 'native'}\n"
        "assert {'tpu_reid_torch.' + m for m in need} <= set(names), names\n"
        "assert len(names) >= 57, names\n"
        "print('imported', len(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("imported")

    alone = tmp_path / "chip_smoke.py"
    alone.write_text(open(os.path.join(REPO, "chip_smoke.py")).read())
    env.pop("PYTHONPATH")
    no_card = dict(env, CUDA_VISIBLE_DEVICES="")
    for cwd, run_env in ((REPO, no_card), (str(tmp_path), env)):
        r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=run_env,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode != 0 and '"ok"' not in r.stdout
