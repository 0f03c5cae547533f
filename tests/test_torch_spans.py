"""The port's spans (runtime/observe.span) on the CPU: with no profiler a
span records nothing and changes no result; under a profiler the extraction
loop and the stage-2 loop show their spans, nested as the layers are, with
their indices; every MetricLogger phase is a span of its name."""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tpu_reid_torch import entry
from tpu_reid_torch.data.transforms import DevicePreprocess
from tpu_reid_torch.models import reid_clip as M
from tpu_reid_torch.parallel import extract as TX
from tpu_reid_torch.runtime import observe
from tpu_reid_torch.train import trainer as TR

BS = 8


@pytest.fixture(scope="module")
def tiny():
    mcfg, params = entry.flagship("cpu", tiny=True)
    return mcfg, params


def _gallery(n_batches, seed=0):
    rng = np.random.RandomState(seed)
    return [SimpleNamespace(images=rng.randint(0, 256, (BS, 32, 16, 3), dtype=np.uint8),
                            pids=np.arange(BS), camids=np.zeros(BS, np.int64),
                            seqids=np.zeros(BS, np.int64), valid=np.ones(BS, bool))
            for _ in range(n_batches)]


def _extract(mcfg, params, n_batches=3):
    ext = TX.make_extractor(lambda p, im: M.eval_embed(p, mcfg, im),
                            DevicePreprocess((32, 16), "vit", dtype=torch.float32),
                            flip_tta=True, dtype=torch.float32,
                            fold=lambda p: M.fold_input_norm(p, mcfg, "vit"), device="cpu")
    return TX.extract_embeddings(ext, params, _gallery(n_batches), device="cpu")[0]


def _stage2(mcfg, params, steps=2):
    rng = np.random.RandomState(1)
    batches = [(rng.randn(BS, 32, 16, 3).astype(np.float32),
                np.repeat(rng.choice(mcfg.n_cls, BS // 4, replace=False), 4),
                np.ones(BS, bool)) for _ in range(steps)]
    log = []
    out = TR.run_stage2(params, mcfg, TR.TrainConfig(), lambda e: iter(batches), epochs=1,
                        log=log.append)
    return out, log


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        out = fn()
    return out, prof.events()


def _spans(events, prefix="reid."):
    """The events named under `prefix`, as (name, start, end, kwargs), by start."""
    out = [(e.name, e.time_range.start, e.time_range.end, dict(e.kwinputs))
           for e in events if e.name.startswith(prefix)]
    return sorted(out, key=lambda s: (s[1], -s[2]))


def _inside(spans, outer, name=None):
    """The spans strictly nested in `outer` (named `name`, if given)."""
    return [s for s in spans if s is not outer and outer[1] <= s[1] and s[2] <= outer[2]
            and (name is None or s[0] == name)]


def _leaves_equal(a, b):
    for (pa, x), (pb, y) in zip(TR.O.paths(a), TR.O.paths(b), strict=True):
        assert pa == pb
        if x is not None:
            assert torch.equal(x, y), pa


def test_no_profiler_no_record_and_the_same_results(tiny, monkeypatch):
    mcfg, params = tiny
    feats_traced, _ = _profiled(lambda: _extract(mcfg, params))
    (trained_traced, log_traced), _ = _profiled(lambda: _stage2(mcfg, params))

    def refuse(*a, **kw):
        raise AssertionError("a span recorded with no profiler")

    # the spans' only way to record (torch's own code keeps its
    # record_function ranges, e.g. Optimizer.step's)
    monkeypatch.setattr(observe, "_RecordFunctionFast", refuse)
    assert observe.span("reid.train.step", step=0) is observe.span("reid.extract.next")
    feats = _extract(mcfg, params)
    trained, log = _stage2(mcfg, params)
    assert torch.equal(feats, feats_traced)
    assert log == log_traced
    _leaves_equal(trained, trained_traced)


def test_extract_embeddings_spans_each_batch(tiny):
    mcfg, params = tiny
    _, events = _profiled(lambda: _extract(mcfg, params, n_batches=3))
    spans = _spans(events)
    batches = [s for s in spans if s[0] == "reid.extract.batch"]
    assert [s[3] for s in batches] == [{"batch": i, "rows": BS} for i in range(3)]
    for b in batches:
        inner = _inside(spans, b)
        names = [s[0] for s in inner]
        for child in ("reid.extract.upload", "reid.extract.embed", "reid.extract.wait",
                      "reid.extract.next"):
            assert names.count(child) == 1, (child, names)
        # the extractor's own layers nest in its call: the fold and the two
        # passes' preprocessing, the stem of each pass
        (embed,) = _inside(spans, b, "reid.extract.embed")
        assert len(_inside(spans, embed, "reid.embed.preprocess")) == 3
        assert len(_inside(spans, embed, "reid.vit.stem")) == 2
        assert len(inner) <= 15
    # the first batch's pull comes before it: one more pull than batches
    assert sum(s[0] == "reid.extract.next" for s in spans) == 4


def test_run_stage2_spans_each_step(tiny):
    mcfg, params = tiny
    _, events = _profiled(lambda: _stage2(mcfg, params, steps=2))
    spans = _spans(events)
    steps = [s for s in spans if s[0] == "reid.train.step"]
    assert [s[3] for s in steps] == [{"step": 0}, {"step": 1}]
    assert sum(s[0] == "reid.train.next" for s in spans) == 3  # 2 batches and the end
    for st in steps:
        inner = _inside(spans, st)
        top = [s[0] for s in inner if s[0] in ("reid.train.forward", "reid.train.backward",
                                                 "reid.train.optimizer")]
        # forward and losses, backward, Adam, then the BNNeck statistics
        assert top == ["reid.train.forward", "reid.train.backward", "reid.train.optimizer",
                       "reid.train.optimizer"]
        assert len(inner) <= 15
    # the lag-1 loss read: inside the second step (the first step's loss)
    assert _inside(spans, steps[1], "reid.train.sync")
    assert not _inside(spans, steps[0], "reid.train.sync")
    # the backward's ops run inside reid.train.backward
    (bwd,) = _inside(spans, steps[0], "reid.train.backward")
    assert any("Backward" in e.name and bwd[1] <= e.time_range.start <= bwd[2]
               for e in events)


def test_phases_are_spans(tmp_path):
    log = observe.MetricLogger(str(tmp_path), console=False)

    def run():
        with log.phase("stage2"):
            torch.ones(4) + 1
        with observe.synced_phase(log, "rerank.pass_a", torch.device("cpu")):
            torch.ones(4) * 2

    _, events = _profiled(run)
    spans = _spans(events, prefix="")
    for name, op in (("stage2", "aten::add"), ("rerank.pass_a", "aten::mul")):
        (ph,) = [s for s in spans if s[0] == name]
        assert any(e.name == op and ph[1] <= e.time_range.start <= ph[2] for e in events)
    log.close()
    assert (tmp_path / "metrics.jsonl").read_text().count('"phase"') == 2


def test_span_ids_reach_the_chrome_trace_as_ints(tmp_path):
    # an index taken from numpy or a tensor is made an int, not handed to the
    # record as it is
    with observe.trace(str(tmp_path)):
        with observe.span("reid.extract.batch", batch=np.int64(3), rows=torch.tensor(5)):
            torch.ones(4) + 1
    (path,) = tmp_path.glob("trace_*.json")
    events = json.loads(path.read_text())["traceEvents"]
    (batch,) = [e for e in events if e.get("name") == "reid.extract.batch"]
    assert (batch["args"]["batch"], batch["args"]["rows"]) == (3, 5)
