"""Whole runs of the harness on the CPU at the tiny configuration: the
result line's keys, the exits without a card or a program, the check
passing sound runs and failing each fault the cells can have."""

import json
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import harness as H
from portbench import run as R
from portbench.tests.tiny import tiny_cell

CPU = torch.device("cpu")
SEED = 2**31 + 4321  # larger than 32 signed bits hold


def run_tiny(name, seconds=0.3):
    return R.run_cell(tiny_cell(name), SEED, seconds, False, CPU, H.SetupClock(0.0))


@pytest.mark.parametrize("name", ["market.embed", "market.train"])
def test_sound_run_is_correct(name):
    res = run_tiny(name)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    want = {m["name"] for m in tiny_cell(name).end_to_end}
    assert set(res["metrics"]) == want
    assert all(v["value"] > 0 for v in res["metrics"].values())


def test_same_seed_same_inputs():
    from portbench.kinds import embed

    runs = [embed.Run(tiny_cell("market.embed"), SEED, CPU, H.SetupClock(0.0))
            for _ in range(2)]
    pools = [r._pool() for r in runs]
    assert (pools[0] == pools[1]).all()


def test_answer_altered_where_produced_is_caught(monkeypatch):
    from tpu_reid_torch.models import reid_clip as M

    real = M.eval_embed

    def altered(*a, **kw):
        out = real(*a, **kw).clone()
        out[:, 0] += 0.1 * out.float().norm(dim=1).to(out.dtype)
        return out

    monkeypatch.setattr(M, "eval_embed", altered)
    assert not run_tiny("market.embed")["correct"]


def test_state_left_unchanged_is_caught(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    res = run_tiny("market.train")
    assert not res["correct"]
    assert res["checks"]["delta_norm_gap"]["value"] > 0.5


def test_half_the_batch_is_caught(monkeypatch):
    from tpu_reid_torch.train import trainer as TR

    real = TR.stage2_loss

    def half(cfg, tcfg, params, images, labels, text, valid=None, *rest, **kw):
        n = images.shape[0] // 2
        return real(cfg, tcfg, params, images[:n], labels[:n], text,
                    None if valid is None else valid[:n], *rest, **kw)

    monkeypatch.setattr(TR, "stage2_loss", half)
    assert not run_tiny("market.train")["correct"]


def stub_cell(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(R, "open_card", lambda: CPU)
    cell = tiny_cell(name)
    monkeypatch.setattr(H, "cell", lambda n, man=None: cell)


@pytest.mark.parametrize("name", ["market.embed", "market.train"])
def test_result_line(monkeypatch, capsys, name):
    stub_cell(monkeypatch, name)
    assert R.main(["--workload", name, "--seed", str(SEED), "--seconds", "0.2",
                   "--trace", "0"]) == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert all(t.startswith("check ") and " limit " in t for t in tail)


def test_forbidden_module_gives_no_result(monkeypatch, capsys):
    stub_cell(monkeypatch, "market.embed")
    monkeypatch.setattr(H, "forbidden_loaded", lambda: ["jax"])
    assert R.main(["--workload", "market.embed", "--seed", "1", "--seconds", "0.1"]) == 3
    assert capsys.readouterr().out == ""


def test_no_card_gives_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert R.main(["--workload", "market.embed", "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


def test_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(H.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(H.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "market.embed",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=tmp_path, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
