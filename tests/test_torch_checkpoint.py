"""The port's runtime/checkpoint.py, the StepWatchdog and the trace (the
counterparts of tests/test_runtime.py and tests/test_guard.py's watchdog
case): torch.save files written atomically
and read back, the manager's cadence, pruning and latest epoch, the extras
with their optimizer leaf order, two_stage_cb / two_stage_resume through
real files, and the missing-extras warning."""

import json
import os
import time

import numpy as np
import pytest
import torch

from tpu_reid_torch.parallel import extract as TX
from tpu_reid_torch.runtime import checkpoint as C
from tpu_reid_torch.runtime.guard import StepWatchdog
from tpu_reid_torch.runtime.observe import span, trace
from tpu_reid_torch.train import optim as O


def _adam_state(steps=1):
    """A trained optimizer over a small tree: (params, optimizer)."""
    params = {"w": torch.ones(3, 2, requires_grad=True), "b": torch.zeros(2, requires_grad=True)}
    opt = O.make_stage_optimizer(params, 1e-3, bias_lr_mult=2.0)
    for _ in range(steps):
        for t in params.values():
            t.grad = torch.ones_like(t)
        opt.step()
    return params, opt


def _equal(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b)
    else:
        assert a == b


def test_save_load_roundtrip(tmp_path):
    payload = {"params": {"w": torch.arange(6.0).reshape(2, 3), "b": torch.zeros(3),
                          "eot": torch.tensor([3, 4], dtype=torch.int32)},
               "epoch": 7, "lr": 1e-3, "name": "x", "none": None, "pair": (1, 2.5)}
    path = str(tmp_path / "sub" / "ckpt.pt")
    C.save_checkpoint(path, payload)
    assert os.listdir(tmp_path / "sub") == ["ckpt.pt"]  # no temporary file left
    _equal(C.load_checkpoint(path), payload)


def test_save_snapshots_before_it_returns(tmp_path):
    """The manager copies the payload to host memory in save(): a leaf the
    trainer updates in place right after is saved as it was."""
    mgr = C.CheckpointManager(str(tmp_path), save_interval=1)
    w = torch.zeros(1000)
    mgr.save(0, {"w": w})
    w.add_(1.0)
    got = mgr.restore(0)
    mgr.close()
    assert float(got["w"].abs().max()) == 0.0


def test_manager_cadence_latest_and_pruning(tmp_path):
    mgr = C.CheckpointManager(str(tmp_path / "run"), max_to_keep=2, save_interval=20)
    assert mgr.latest_epoch() is None
    saved = [e for e in range(40)
             if mgr.maybe_save(e, {"w": torch.full((2,), float(e)), "stage": 0},
                               last_epoch=(e == 39))]
    for e in saved:
        mgr.save_extras(e, {"e": e})
    assert saved == [19, 39]
    assert mgr.latest_epoch() == 39
    np.testing.assert_array_equal(mgr.restore()["w"].numpy(), [39.0, 39.0])
    # three more saves: only the newest two epochs and their extras stay
    for e in (40, 41, 42):
        mgr.save(e, {"w": torch.zeros(1)})
        mgr.save_extras(e, {"e": e})
    mgr.close()
    names = sorted(os.listdir(tmp_path / "run"))
    assert names == ["41.pt", "42.pt", "extras_41.pt", "extras_42.pt"]


def test_checkpoint_extras_roundtrip_and_leaf_order(tmp_path):
    """The optimizer's state dict round-trips through extras with its leaf
    order; a restoring run whose leaf order differs is refused."""
    params, opt = _adam_state(steps=2)
    paths = O.leaf_order(params, bias_lr_mult=2.0)
    assert paths == ["w", "b"]  # the non-bias group, then the bias group
    mgr = C.CheckpointManager(str(tmp_path / "ck"), save_interval=1)
    assert mgr.maybe_save(0, {"params": params, "stage": 0, "epoch_in_stage": 0})
    mgr.save_extras(0, {"optimizer": opt.state_dict(), "opt_paths": paths})
    got = mgr.restore_extras(0, paths)
    _equal(got["optimizer"], C._to_host(opt.state_dict()))
    fresh, opt2 = _adam_state(steps=0)
    opt2.load_state_dict(got["optimizer"])
    _equal(opt2.state_dict()["state"], opt.state_dict()["state"])
    with pytest.raises(ValueError, match="other leaves"):
        mgr.restore_extras(0, ["b", "w"])
    assert mgr.restore_extras(7, paths) is None
    mgr.close()


def _tree(v):
    return {"w": torch.full((4,), float(v)), "b": torch.ones(2) * v}


@pytest.mark.parametrize("stage", [0, 1])
def test_two_stage_cb_resume_roundtrip(tmp_path, stage):
    """two_stage_cb saves the stage marker with the extras (optimizer state
    and leaf order, GPA, XBM banks) and two_stage_resume hands them back as
    the trainers' kwargs, mid-stage 1 and mid-stage 2."""
    mgr = C.CheckpointManager(str(tmp_path), save_interval=1)
    _, opt = _adam_state()
    paths = ["w", "b"]
    xbms = [{"feats": torch.ones(4, 2), "labels": torch.arange(4, dtype=torch.int32),
             "ptr": 1, "filled": 4}]
    cb = C.two_stage_cb(mgr, stage, lambda e: 10 * stage + e)
    cb(3, _tree(3), {"optimizer": opt.state_dict(), "opt_paths": paths, "gpa": _tree(0.5),
                     "xbms": xbms if stage else None})
    params, done, kw1, kw2 = C.two_stage_resume(
        mgr, _tree(0), lambda p: paths, lambda p: paths, gpa1_used=True, gpa2_used=True,
        xbms_used=True, log=lambda s: None)
    mgr.close()
    _equal(params, _tree(3))
    assert done == stage
    mine, other = (kw1, kw2) if stage == 0 else (kw2, kw1)
    assert mine["start_epoch"] == 4
    _equal(mine["init_opt_state"], C._to_host(opt.state_dict()))
    _equal(mine["init_gpa"], _tree(0.5))
    assert other["init_opt_state"] is None and other["start_epoch"] == (1 if stage else 0)
    if stage:
        _equal(kw2["init_xbms"], xbms)
    else:
        assert kw2["init_xbms"] is None


def test_two_stage_resume_stage_markers(tmp_path):
    """A finished stage (epoch_in_stage -1) restarts nothing of it; no
    checkpoint leaves the fresh kwargs and the given params."""
    mgr = C.CheckpointManager(str(tmp_path), save_interval=20)
    fresh = C.two_stage_resume(mgr, _tree(9), None, None, False, False, log=lambda s: None)
    assert fresh[1] == 0 and fresh[2]["start_epoch"] == 1 and fresh[3]["start_epoch"] == 0
    _equal(fresh[0], _tree(9))
    for stage in (1, 2):
        mgr.save(5 * stage, {"params": _tree(stage), "stage": stage, "epoch_in_stage": -1})
        params, done, kw1, kw2 = C.two_stage_resume(mgr, _tree(0), None, None, False, False,
                                                    log=lambda s: None)
        assert done == stage and kw1["init_opt_state"] is None and kw2["start_epoch"] == 0
        _equal(params, _tree(stage))
    mgr.close()


def test_two_stage_resume_warns_when_extras_are_missing(tmp_path):
    """A parameter checkpoint without its extras (a crash between the two
    writes) restarts the stage from its first epoch on the restored
    parameters, and says so."""
    mgr = C.CheckpointManager(str(tmp_path), save_interval=1)
    mgr.save(4, {"params": _tree(4), "stage": 1, "epoch_in_stage": 2})
    msgs = []
    params, done, kw1, kw2 = C.two_stage_resume(mgr, _tree(0), lambda p: [], lambda p: [],
                                                False, True, log=msgs.append)
    mgr.close()
    assert done == 1 and kw2["start_epoch"] == 0 and kw2["init_opt_state"] is None
    _equal(params, _tree(4))
    assert len(msgs) == 1 and "no extras companion" in msgs[0] and "stage 2" in msgs[0]


def test_watchdog_fires_and_cancels():
    fired = []
    with StepWatchdog(0.05, on_hang=fired.append, log=lambda s: None) as wd:
        time.sleep(0.15)
    assert wd.hung and len(fired) == 1 and fired[0] >= 0.05

    with StepWatchdog(5.0, on_hang=fired.append, log=lambda s: None) as wd:
        pass
    time.sleep(0.1)
    assert not wd.hung and len(fired) == 1


def test_watchdog_rearmed_fires_once_per_long_wait():
    """One watchdog re-armed around many waits, with a short switch
    interval: short waits never fire and start no thread each; a wait past
    the timeout fires once; the monitor thread ends once disarmed."""
    import sys
    import threading

    fired = []
    wd = StepWatchdog(0.2, on_hang=fired.append, log=lambda s: None)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        before = threading.active_count()
        for _ in range(5000):
            with wd:
                pass
        assert threading.active_count() <= before + 1 and not fired
        with wd:
            time.sleep(0.5)
        assert len(fired) == 1 and wd.hung
        for _ in range(100):
            with wd:
                pass
        time.sleep(0.4)
        assert len(fired) == 1
    finally:
        sys.setswitchinterval(interval)
    for _ in range(50):
        if wd._thread is None:
            break
        time.sleep(0.05)
    assert wd._thread is None


def test_extraction_watchdog_guards_each_batch():
    """extract_embeddings on the CPU arms the watchdog around each
    extractor call: a batch slower than hang_timeout_s fires on_hang, the
    features still come back."""
    from types import SimpleNamespace

    hung = []

    def slow_extractor(params, images):
        time.sleep(0.12)
        return images.float().mean(dim=(1, 2))

    batch = SimpleNamespace(images=np.ones((2, 4, 4, 3), np.uint8), pids=np.arange(2),
                            camids=np.zeros(2), seqids=np.zeros(2), valid=np.ones(2, bool))
    feats, pids, _, _ = TX.extract_embeddings(slow_extractor, {}, [batch, batch],
                                              device="cpu", hang_timeout_s=0.05,
                                              on_hang=hung.append)
    assert tuple(feats.shape) == (4, 3) and len(hung) == 2
    hung.clear()
    TX.extract_embeddings(slow_extractor, {}, [batch], device="cpu", hang_timeout_s=5.0,
                          on_hang=hung.append)
    assert not hung


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path)):
        with span("reid.train.step", step=7):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = [f for f in os.listdir(tmp_path) if f.endswith(".json")]
    assert len(files) == 1
    with open(tmp_path / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    # the program's span, with its argument, on the host's thread around the op
    (step,) = [e for e in events if e.get("name") == "reid.train.step"]
    assert step["args"]["step"] == 7
    mm = next(e for e in events if e.get("name") == "aten::mm")
    assert mm["tid"] == step["tid"]
    assert step["ts"] <= mm["ts"] and mm["ts"] + mm["dur"] <= step["ts"] + step["dur"]
