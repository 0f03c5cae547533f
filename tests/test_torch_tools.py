"""The port's host tools (tpu_reid_torch/tools) against the JAX package's:
the dataset writers write the same files from the same seed; the numpy
reference tail (ref_cmc_map) gives JAX's numbers; parity_run --synthetic
runs end to end on the port and its results match JAX's run_parity on the
same assets (fp32 extraction in both); the runbook downloads nothing and
refuses missing files by name; the captioner's cases of
tests/test_captioner.py against the port, over a scripted HTTP server on
localhost."""

import gzip
import hashlib
import http.server
import json
import os
import random
import threading

import numpy as np
import pytest
import torch

from tpu_reid.tools import parity_run as JP
from tpu_reid.tools import synth_market as JS
from tpu_reid_torch.tools import caption_prompts as TC
from tpu_reid_torch.tools import parity_run as TP
from tpu_reid_torch.tools import runbook_market_parity as TR
from tpu_reid_torch.tools import synth_market as TS


def _digest(root):
    """{relative path: sha256} of every file under root."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


@pytest.mark.parametrize("writer,kw", [
    ("write_images", {}), ("write_images_duke", {}), ("write_images_veri", {}),
    ("write_images_msmt", {}), ("write_images_vehicleid", {}), ("write_images_personx", {}),
    ("write_images", {"difficulty": 0.7}),
])
def test_writers_write_the_jax_files(tmp_path, writer, kw):
    n = {}
    for name, mod in (("jax", JS), ("port", TS)):
        n[name] = getattr(mod, writer)(str(tmp_path / name), np.random.RandomState(4), 2, 3, 6,
                                       9, (32, 16), **kw)
    assert n["port"] == n["jax"] > 0
    got, want = _digest(tmp_path / "port"), _digest(tmp_path / "jax")
    assert got == want and len(got) > 10


def test_write_attributes_matches_jax(tmp_path):
    from tpu_reid.data.attributes import get_prompts_augmented as j_prompts
    from tpu_reid_torch.data.attributes import get_prompts_augmented as t_prompts

    TS.write_attributes(str(tmp_path / "port.mat"), 9)
    JS.write_attributes(str(tmp_path / "jax.mat"), 9)
    got = t_prompts(str(tmp_path / "port.mat"))
    assert got == j_prompts(str(tmp_path / "jax.mat")) and len(got[0]) == 9


def test_synth_market_main_writes_a_workload(tmp_path):
    TS.main(["--out", str(tmp_path), "--train_ids", "2", "--test_ids", "2", "--query", "2",
             "--gallery", "4", "--hw", "32", "16", "--skip_checkpoint"])
    assert sorted(os.listdir(tmp_path)) == ["Market1501", "market_attribute.mat",
                                           "merges.txt.gz"]


@pytest.mark.parametrize("seed,n_q,n_g,max_rank", [(0, 7, 30, 10), (1, 5, 3, 10), (2, 9, 40, 50)])
def test_ref_cmc_map_matches_jax(seed, n_q, n_g, max_rank):
    rng = np.random.RandomState(seed)
    dist = rng.rand(n_q, n_g).astype(np.float32)
    dist[:, 1] = dist[:, 0]  # a tie
    qp, gp = rng.randint(0, 3, n_q), rng.randint(0, 3, n_g)
    qc, gc = rng.randint(0, 2, n_q), rng.randint(0, 2, n_g)
    qp[0], gp[0], gc[0], qc[0] = 0, 0, 1, 0  # at least one cross-camera hit
    got = TP.ref_cmc_map(dist, qp, gp, qc, gc, max_rank)
    want = JP.ref_cmc_map(dist, qp, gp, qc, gc, max_rank)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    q, g = rng.randn(4, 6).astype(np.float32), rng.randn(5, 6).astype(np.float32)
    np.testing.assert_array_equal(TP.ref_euclidean_distmat(q, g), JP.ref_euclidean_distmat(q, g))
    with pytest.raises(ValueError, match="no query identity"):
        TP.ref_cmc_map(dist[:1], np.array([9]), gp, qc[:1], gc)


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    """The port's synthetic assets and JAX's from the same seed: the same
    files; the port's harness on its own, in bf16 (as users run it), with
    --mm and --baseline."""
    root = tmp_path_factory.mktemp("parity")
    TP.make_synthetic_assets(str(root / "port"))
    JP.make_synthetic_assets(str(root / "jax"))
    baseline = root / "results.json"
    baseline.write_text(json.dumps({"published": {}}))
    res = TP.main(["--synthetic", "--synthetic_dir", str(root / "run"), "--baseline",
                   str(baseline), "--bs", "16", "--mm", "--device", "cpu"])
    return root, res, baseline


def test_synthetic_assets_are_the_jax_files(synthetic):
    root, *_ = synthetic
    got, want = _digest(root / "port"), _digest(root / "jax")
    ckpt = "tiny_clip.pth"  # a torch archive: compared by its tensors
    a = torch.load(root / "port" / ckpt)
    b = torch.load(root / "jax" / ckpt)
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    merges = "merges.txt.gz"  # gzip stamps its header with the time: compared unpacked
    assert gzip.open(root / "port" / merges).read() == gzip.open(root / "jax" / merges).read()
    for k in (ckpt, merges):
        got.pop(k), want.pop(k)
    assert got == want and len(got) > 60


def test_parity_run_synthetic_runs_end_to_end(synthetic):
    _, res, baseline = synthetic
    assert res["synthetic"] and res["n_query"] == 12 and res["n_gallery"] == 48
    assert res["max_abs_diff"] <= 2e-3 and ", mm" in res["protocol"]
    assert 0.05 < res["framework"]["mAP"] <= 1.0
    rec = json.loads(baseline.read_text())["published"]["market1501_synthetic"]
    assert rec["framework"] == res["framework"]


def test_parity_run_matches_jax_run_parity(synthetic, monkeypatch):
    """Both harnesses on the JAX assets, fp32 extraction in both: the
    framework and reference-math results within 1e-4."""
    import jax.numpy as jnp

    root, *_ = synthetic
    argv = ["--root", str(root / "jax"), "--model_path", str(root / "jax" / "tiny_clip.pth"),
            "--bpe_path", str(root / "jax" / "merges.txt.gz"), "--height", "64", "--stride",
            "8", "--bs", "16"]
    with monkeypatch.context() as m:
        m.setattr(jnp, "bfloat16", jnp.float32)
        want = JP.run_parity(JP.params_parser().parse_args(argv))
    monkeypatch.setattr(TP, "EXTRACT_DTYPE", torch.float32)
    got = TP.run_parity(TP.params_parser().parse_args(argv + ["--device", "cpu"]))
    for tail in ("framework", "reference_math"):
        for k, v in want[tail].items():
            assert abs(got[tail][k] - v) <= 1e-4, (tail, k)
    assert (got["n_query"], got["n_gallery"]) == (want["n_query"], want["n_gallery"])


def test_runbook_refuses_missing_files(tmp_path, capsys):
    model = tmp_path / "ViT-B-16.pt"
    model.write_bytes(b"x")
    with pytest.raises(FileNotFoundError) as e:
        TR.main(["--root", str(tmp_path), "--model_path", str(model), "--bpe_path",
                 str(tmp_path / "nope.txt.gz"), "--device", "cpu"])
    msg = str(e.value)
    assert "downloads nothing" in msg and "nope.txt.gz" in msg and "--attributes" in msg
    assert "--model_path" not in msg
    for name in ("bpe.txt.gz", "attr.mat"):
        (tmp_path / name).write_bytes(b"x")
    assert TR.main(["--root", str(tmp_path), "--model_path", str(model), "--bpe_path",
                    str(tmp_path / "bpe.txt.gz"), "--attributes", str(tmp_path / "attr.mat"),
                    "--device", "cpu"]) == 2
    assert "Market-1501 not found" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        TR.main(["--device", "cpu"])


# ---------------------------------------------------------------------------
# the captioner (tests/test_captioner.py's cases against the port)
# ---------------------------------------------------------------------------


class _ScriptedHandler(http.server.BaseHTTPRequestHandler):
    """Replies from a per-server script of canned JSON responses."""

    script = []  # list of dicts; the last one repeats
    seen = []  # parsed request payloads

    def do_POST(self):
        body = self.rfile.read(int(self.headers["Content-Length"]))
        type(self).seen.append(json.loads(body))
        idx = min(len(type(self).seen) - 1, len(type(self).script) - 1)
        data = json.dumps(type(self).script[idx]).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, *a):
        pass


@pytest.fixture
def scripted_server():
    servers = []

    def make(script):
        handler = type("H", (_ScriptedHandler,), {"script": script, "seen": []})
        srv = http.server.HTTPServer(("127.0.0.1", 0), handler)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        servers.append(srv)
        return f"http://127.0.0.1:{srv.server_address[1]}/v1/chat/completions", handler

    yield make
    for srv in servers:
        srv.shutdown()
        srv.server_close()


def _ok(text):
    return {"choices": [{"message": {"content": text}}]}


@pytest.fixture
def crops(tmp_path):
    paths = []
    for i in range(4):
        p = tmp_path / f"0001_c1s1_{i:06d}_00.jpg"
        p.write_bytes(b"\xff\xd8fakejpeg" + bytes([i]))
        paths.append(str(p))
    return paths


def test_caption_success_first_try(scripted_server, crops):
    url, handler = scripted_server([_ok("A photo of a person in red.")])
    out = TC.caption_identity(crops, url, "k", rng=random.Random(0), retry_sleep=0.0)
    assert out == "A photo of a person in red."
    req = handler.seen[0]
    parts = req["messages"][0]["content"]
    assert parts[0] == {"type": "text", "text": TC.CAPTION_INSTRUCTION}
    assert [p["type"] for p in parts[1:]] == ["image_url", "image_url"] and parts[1] != parts[2]
    assert req["model"] == "gpt-4o-mini" and req["max_tokens"] == 256


def test_caption_refusal_escalates_model(scripted_server, crops):
    url, handler = scripted_server([_ok("I'm sorry, I can't identify people."),
                                    _ok("I am unable to help with that."),
                                    _ok("A photo of a person in a blue jacket.")])
    out = TC.caption_identity(crops, url, "k", rng=random.Random(0), retry_sleep=0.0)
    assert out == "A photo of a person in a blue jacket."
    assert [r["model"] for r in handler.seen] == ["gpt-4o-mini", "gpt-4o-mini", "gpt-4o"]


def test_caption_transient_error_retries(scripted_server, crops):
    url, handler = scripted_server([{"error": {"message": "rate limited"}},
                                    _ok("A photo of a person with a backpack.")])
    out = TC.caption_identity(crops, url, "k", rng=random.Random(0), retry_sleep=0.0)
    assert out == "A photo of a person with a backpack." and len(handler.seen) == 2


def test_caption_gives_up_after_max_attempts(scripted_server, crops):
    url, _ = scripted_server([_ok("sorry, no.")])
    with pytest.raises(RuntimeError, match="no usable answer"):
        TC.caption_identity(crops, url, "k", rng=random.Random(0), max_attempts=3,
                            retry_sleep=0.0)


def test_collect_identity_images(tmp_path):
    from tpu_reid.tools.caption_prompts import collect_identity_images as j_collect

    for name in ("0001_c1_000.jpg", "0001_c2_001.jpg", "0007_c1_000.jpg", "-1_c1_000.jpg",
                 "Thumbs.db"):
        (tmp_path / name).write_bytes(b"x")
    by_label = TC.collect_identity_images(str(tmp_path))
    assert sorted(by_label) == [1, 7] and len(by_label[1]) == 2
    assert by_label == j_collect(str(tmp_path))


def test_main_api_mode_writes_prompt_file(scripted_server, tmp_path):
    imgs = tmp_path / "train"
    imgs.mkdir()
    for label in (3, 9):
        for i in range(2):
            (imgs / f"{label:04d}_c1s1_{i:06d}_00.jpg").write_bytes(b"j")
    url, _ = scripted_server([_ok("A photo of a person in green.")])
    out = tmp_path / "prompts.txt"
    TC.main(["--n_cls", "2", "--out", str(out), "--images_root", str(imgs), "--api_url", url,
             "--api_key", "k", "--retry_sleep", "0"])
    lines = out.read_text().strip().split("\n")
    assert lines == ["0: A photo of a person in green.", "1: A photo of a person in green."]
    from tpu_reid_torch.models.prompts import read_caption_prompts

    assert read_caption_prompts(str(out), n_cls=2)[0].startswith("A photo of")


def test_main_offline_renderers_match_jax(tmp_path, monkeypatch):
    """--attributes and the generic placeholders: the JAX tool's files."""
    import sys

    from tpu_reid.tools import caption_prompts as JC

    attr = str(tmp_path / "attr.mat")
    TS.write_attributes(attr, 5)
    for extra in (["--attributes", attr], []):
        TC.main(["--n_cls", "4", "--out", str(tmp_path / "port.txt"), *extra])
        monkeypatch.setattr(sys, "argv", ["caption_prompts", "--n_cls", "4", "--out",
                                          str(tmp_path / "jax.txt"), *extra])
        JC.main()
        assert (tmp_path / "port.txt").read_text() == (tmp_path / "jax.txt").read_text()
