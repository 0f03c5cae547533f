"""The device-resident training paths of the port on the CPU, where each
step runs eagerly from the same static buffers a CUDA graph replays on the
card: run_stage2_cached against run_stage2 fed the same gathers and draws,
run_stage1_live_cached against run_stage1 and against the JAX package's
run_stage1_live_cached, chunk sizes, the guard's in-place rollback, the
capturable optimizer's lr tensor and state dicts, and StepGraph's card path
with torch.cuda's stream and graph calls stubbed (a failed capture raises,
a step that rebinds its state is refused)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_reid_model import tiny_models
from tests.test_torch_trainer_stage1 import adam_bound, compare_leaves, epoch_losses
from tpu_reid.data.datasets import load_market1501 as j_load_market
from tpu_reid.data.device_cache import DeviceImageCache as JCache
from tpu_reid.data.transforms import DevicePreprocess as JPre
from tpu_reid.tools import synth_market as SM
from tpu_reid.train import trainer as JTR
from tpu_reid_torch.data.datasets import load_market1501
from tpu_reid_torch.data.device_cache import DeviceImageCache
from tpu_reid_torch.data.sampler import PKSampler
from tpu_reid_torch.data.transforms import DevicePreprocess
from tpu_reid_torch.runtime.guard import TrainGuard
from tpu_reid_torch.train import optim as TO
from tpu_reid_torch.train import trainer as TTR

HW = (32, 16)
BS = 8
EPOCHS = 2


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this file's tiny models: more gain them
    nothing, and the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def market(tmp_path_factory):
    """5 training identities of 17 images (relabelled 0-4, within the tiny
    models' 6 classes), decoded by the same decoder in both packages (the
    native one, one C++ source, where it builds)."""
    root = tmp_path_factory.mktemp("cached_training")
    SM.write_images(str(root / "Market1501"), np.random.RandomState(3), n_train_ids=5,
                    n_test_ids=2, n_query=2, n_gallery=4, hw=(64, 32))
    ds = load_market1501(str(root))
    jcache = JCache(j_load_market(str(root)).train, HW)
    return ds, DeviceImageCache(ds.train, HW, device="cpu"), jcache


def stage2_order(ds, cache, n_steps=5):
    """An epoch's first n_steps PK batches of 8 (2 identities x 4)."""
    def order(epoch):
        pk = PKSampler([r[1] for r in ds.train], BS, 4, seed=epoch).epoch()
        return list(cache.epoch_index_batches(pk, BS))[:n_steps]
    return order


def stage1_order(cache, n_steps=3):
    """An epoch's first n_steps shuffled batches of 8, as the CLI's."""
    def order(epoch):
        perm = np.random.default_rng(epoch).permutation(cache.n)[:n_steps * BS]
        return cache.epoch_index_batches(perm, BS, drop_tail=True)
    return order


def epoch_gen(epoch):
    return torch.Generator().manual_seed(10_000 + epoch)


class PoisonedDraws(DevicePreprocess):
    """A preprocess whose `bad`-th train_draws call (0-based, counted over
    the run) erases every image with NaN noise: a step whose loss is not
    finite, as a diverged one."""

    def __init__(self, *a, bad=-1, **kw):
        super().__init__(*a, **kw)
        object.__setattr__(self, "calls", [0, bad])

    def train_draws(self, gen, b, pad_hw=(10, 10), erasing_prob=0.5):
        d = super().train_draws(gen, b, pad_hw, erasing_prob)
        calls = self.calls
        if calls[0] == calls[1]:
            d["apply"] = torch.ones_like(d["apply"])
            d["noise"] = torch.full_like(d["noise"], float("nan"))
        calls[0] += 1
        return d


def host_stage2_batches(cache, order, pp):
    """run_stage2's batches: the same gathers and, from each epoch's own
    generator, the same draws in the same order."""
    def batches(epoch):
        gen = epoch_gen(epoch)
        for sel, pids, _camids, valid in order(epoch):
            yield pp.train_batch(cache.gather(sel), pp.train_draws(gen, BS)), pids, valid
    return batches


def assert_same_tree(a, b):
    for (path, x), (_, y) in zip(TO.paths(a), TO.paths(b)):
        if x is not None:
            assert torch.equal(x, y), path


@pytest.fixture(scope="module")
def stage2_runs(market):
    ds, cache, _ = market
    _, _, tcfg, tp = tiny_models("coop")
    pp = DevicePreprocess(HW, "vit")
    order = stage2_order(ds, cache)
    out = {}
    for name, chunk in (("cached3", 3), ("cached1", 1), ("cached4", 4)):
        log = []
        out[name] = (TTR.run_stage2_cached(tp, tcfg, TTR.TrainConfig(), cache, order, pp,
                                           epoch_gen, epochs=EPOCHS, log=log.append,
                                           chunk=chunk), log)
    log = []
    out["host"] = (TTR.run_stage2(tp, tcfg, TTR.TrainConfig(),
                                  host_stage2_batches(cache, order, pp), epochs=EPOCHS,
                                  log=log.append), log)
    return tp, out


def test_stage2_cached_equals_the_host_loop(stage2_runs):
    """chunk=3 on 5-step epochs (a full chunk and a partial one): the same
    epoch logs, the trained leaves and the BN statistics bit-equal."""
    tp, out = stage2_runs
    (got, glog), (want, wlog) = out["cached3"], out["host"]
    assert glog == wlog and len(epoch_losses(glog, "stage2")) == EPOCHS
    assert_same_tree(got, want)
    assert not torch.equal(got["head"]["bn"]["mean"], tp["head"]["bn"]["mean"])


@pytest.mark.parametrize("chunk", [1, 4])
def test_stage2_cached_does_not_depend_on_chunk(stage2_runs, chunk):
    _, out = stage2_runs
    (got, glog), (want, wlog) = out[f"cached{chunk}"], out["cached3"]
    assert glog == wlog
    assert_same_tree(got, want)


def test_stage2_cached_leaves_the_input_alone(stage2_runs):
    """The BN statistics are written in place into the runner's own copies:
    the caller's parameter dict keeps its tensors and values."""
    tp, out = stage2_runs
    got = out["cached3"][0]
    assert got["head"]["bn"]["mean"] is not tp["head"]["bn"]["mean"]
    assert torch.equal(tp["head"]["bn"]["mean"], torch.zeros_like(tp["head"]["bn"]["mean"]))


@pytest.fixture(scope="module")
def stage1_runs(market):
    ds, cache, jcache = market
    jcfg, jp, tcfg, tp = tiny_models("ivlp")
    pp = DevicePreprocess(HW, "vit")
    order = stage1_order(cache)
    out = {}
    for name, chunk in (("cached", 2), ("cached4", 4)):
        log = []
        out[name] = (TTR.run_stage1_live_cached(tp, tcfg, TTR.TrainConfig(), cache, order, pp,
                                                epochs=EPOCHS, log=log.append, chunk=chunk),
                     log)

    def host(epoch):
        for sel, pids, _camids, valid in order(epoch):
            yield pp.eval_batch(cache.gather(sel)), pids, valid

    log = []
    out["host"] = (TTR.run_stage1(tp, tcfg, TTR.TrainConfig(), host, epochs=EPOCHS,
                                  log=log.append), log)
    jlog = []
    jout = JTR.run_stage1_live_cached(jp, jcfg, JTR.TrainConfig(), jcache,
                                      stage1_order(jcache), JPre(HW, "vit", dtype=jnp.float32),
                                      epochs=EPOCHS, log=jlog.append, chunk=3)
    return (jcfg, tcfg, tp), out, (jout, jlog)


def test_stage1_live_cached_equals_run_stage1(stage1_runs):
    _, out, _ = stage1_runs
    (got, glog), (want, wlog) = out["cached"], out["host"]
    assert glog == wlog and len(epoch_losses(glog, "stage1")) == EPOCHS
    assert_same_tree(got, want)


def test_stage1_live_cached_does_not_depend_on_chunk(stage1_runs):
    _, out, _ = stage1_runs
    assert out["cached4"][1] == out["cached"][1]
    assert_same_tree(out["cached4"][0], out["cached"][0])


def test_stage1_live_cached_matches_jax(stage1_runs):
    """From carried-over parameters, on the same cache and orders: the epoch
    losses, and the trained leaves within the Adam bound."""
    from tpu_reid.models import reid_clip as JM
    from tpu_reid_torch.models import reid_clip as TM

    (jcfg, tcfg, tp), out, (jout, jlog) = stage1_runs
    got, glog = out["cached"]
    np.testing.assert_allclose(epoch_losses(glog, "stage1"), epoch_losses(jlog, "stage1"),
                               atol=2e-4)  # both logged to 4 decimals
    lrs = [TTR.S.cosine_warmup_lr(e, 3.5e-4, EPOCHS) for e in range(1, EPOCHS + 1)]
    bound = adam_bound([lr for lr in lrs for _ in range(3)])
    compare_leaves(got, jout, (lambda p: JM.stage1_trainable(p, jcfg),
                               lambda p: TM.stage1_trainable(p, tcfg)), bound)
    assert not np.allclose(got["clip"]["visual"]["vpt_shallow"].numpy(),
                           tp["clip"]["visual"]["vpt_shallow"].numpy())


@pytest.mark.parametrize("stage,mode", [(0, "ivlp"), (1, "coop"), (1, "promptsrc")])
def test_cached_resume_equals_the_straight_run(market, tmp_path, stage, mode):
    """The cached runners stopped after epoch 1 (their checkpoint written
    through two_stage_cb), restored from disk and run on: equal to the
    straight 3-epoch run bit for bit (the Adam state, the BN statistics and,
    for promptsrc, the GPA sum carry across)."""
    from tests.test_torch_resume import assert_trees_equal, resumed_run

    ds, cache, _ = market
    _, _, tcfg, tp = tiny_models(mode)
    pp = DevicePreprocess(HW, "vit")
    if stage == 0:
        def run(params, **kw):
            return TTR.run_stage1_live_cached(params, tcfg, TTR.TrainConfig(), cache,
                                              stage1_order(cache, 2), pp, epochs=3,
                                              log=lambda s: None, **kw)
        leaf_order = lambda p: TTR.stage1_leaf_order(p, tcfg)  # noqa: E731
    else:
        def run(params, **kw):
            return TTR.run_stage2_cached(params, tcfg, TTR.TrainConfig(), cache,
                                         stage2_order(ds, cache, 3), pp, epoch_gen, epochs=3,
                                         log=lambda s: None, chunk=2, **kw)
        leaf_order = lambda p: TTR.stage2_leaf_order(p, tcfg)  # noqa: E731
    want = run(tp)
    got = resumed_run(tmp_path, run, tp, stage, 1, leaf_order, mode == "promptsrc")
    assert_trees_equal(got, want)


class PointerGuard(TrainGuard):
    """A TrainGuard that records the address of every tensor of the live
    state it is shown (snapshots and checks)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.seen = []

    def _record(self, state):
        ptrs = []

        def walk(x):
            if isinstance(x, dict):
                for v in x.values():
                    walk(v)
            elif isinstance(x, (list, tuple)):
                for v in x:
                    walk(v)
            elif isinstance(x, torch.Tensor):
                ptrs.append(x.data_ptr())

        walk(state)
        self.seen.append(ptrs)

    def maybe_snapshot(self, step, *state):
        self._record(state)
        super().maybe_snapshot(step, *state)

    def check(self, loss, *state):
        out = super().check(loss, *state)
        self._record(out[0])
        return out


def test_a_non_finite_step_rolls_back_in_place(market):
    """Step 3 of the first epoch (of 5) is poisoned (NaN erasing noise): the
    guard rolls back to its snapshot of step 2 and the step is skipped.
    Every leaf, BN statistic and Adam state tensor keeps its address through
    the run, the rollback included, and the run equals the host loop fed the
    same poisoned draws: the same logs, bit-equal leaves."""
    ds, cache, _ = market
    _, _, tcfg, tp = tiny_models("coop")
    order = stage2_order(ds, cache)
    runs = {}
    for name in ("cached", "host"):
        pp = PoisonedDraws(HW, "vit", bad=2)
        guard = PointerGuard(snapshot_every=2, max_restores=1, log=lambda s: None)
        log = []
        if name == "cached":
            out = TTR.run_stage2_cached(tp, tcfg, TTR.TrainConfig(), cache, order, pp,
                                        epoch_gen, epochs=EPOCHS, log=log.append, guard=guard,
                                        chunk=3)
        else:
            out = TTR.run_stage2(tp, tcfg, TTR.TrainConfig(), host_stage2_batches(
                cache, order, pp), epochs=EPOCHS, log=log.append, guard=guard)
        assert guard.restores == 1 and guard.events[0]["restored_to"] == 2
        runs[name] = (out, log, guard)
    (got, glog, guard), (want, wlog, _) = runs["cached"], runs["host"]
    assert glog == wlog and np.isfinite(epoch_losses(glog, "stage2")).all()
    assert_same_tree(got, want)
    assert len(guard.seen) > 4 and all(p == guard.seen[0] for p in guard.seen)


def test_set_lr_writes_a_capturable_lr_in_place():
    leaves = {"w": torch.zeros(3, requires_grad=True), "b": torch.zeros(2, requires_grad=True)}
    opt = TO.make_stage_optimizer(leaves, 1e-3, bias_lr_mult=2.0, capturable=True)
    lrs = [g["lr"] for g in opt.param_groups]
    assert all(isinstance(t, torch.Tensor) and t.dtype == torch.float32 for t in lrs)
    ptrs = [t.data_ptr() for t in lrs]
    TO.set_lr(opt, 5e-6)
    assert [g["lr"] for g in opt.param_groups] == lrs
    assert [t.data_ptr() for t in lrs] == ptrs
    np.testing.assert_allclose([float(t) for t in lrs], [5e-6, 1e-5], rtol=1e-7)
    assert all(g["capturable"] for g in opt.param_groups)
    # the state exists from the start, so it has its addresses before any step
    assert all(set(opt.state[p]) == {"step", "exp_avg", "exp_avg_sq"}
               for g in opt.param_groups for p in g["params"])


def test_optimizer_state_restores_across_modes():
    """A state dict of an eager (float lr) optimizer after two steps loads
    into a capturable one, which keeps its lr tensors and its mode; the
    capturable one's state dict (lr tensors) loads back into an eager one,
    which keeps float lrs and host step counters."""
    def leaves():
        return {"w": torch.ones(4, requires_grad=True), "b": torch.ones(2, requires_grad=True)}

    tr = leaves()
    eager = TO.make_stage_optimizer(tr, 1e-3, bias_lr_mult=2.0)
    for _ in range(2):
        for t in tr.values():
            t.grad = torch.full_like(t, 0.5)
        eager.step()
    TO.set_lr(eager, 2e-3)
    cap = TO.make_stage_optimizer(leaves(), 1e-3, bias_lr_mult=2.0, capturable=True)
    lrs = [g["lr"] for g in cap.param_groups]
    TO.load_state(cap, eager.state_dict())
    assert [g["lr"] for g in cap.param_groups] == lrs
    np.testing.assert_allclose([float(t) for t in lrs], [2e-3, 4e-3], rtol=1e-7)
    assert all(g["capturable"] for g in cap.param_groups)
    for pe, pc in zip(eager.param_groups, cap.param_groups):
        for a, b in zip(pe["params"], pc["params"]):
            for k in ("step", "exp_avg", "exp_avg_sq"):
                assert torch.equal(eager.state[a][k], cap.state[b][k]), k
    back = TO.make_stage_optimizer(leaves(), 1e-3, bias_lr_mult=2.0)
    TO.load_state(back, cap.state_dict())
    assert [g["lr"] for g in back.param_groups] == pytest.approx([2e-3, 4e-3], rel=1e-6)
    assert all(isinstance(g["lr"], float) and not g["capturable"] for g in back.param_groups)
    assert all(back.state[p]["step"].device.type == "cpu" and float(back.state[p]["step"]) == 2
               for g in back.param_groups for p in g["params"])


@pytest.fixture
def fake_capture(monkeypatch):
    """torch.cuda's stream and graph calls stubbed, so that StepGraph's card
    path (warm-up, capture, checks) runs its Python on the CPU; the test
    sets torch.cuda.graph."""
    import contextlib

    class Stream:
        def wait_stream(self, other):
            pass

    monkeypatch.setattr(torch.cuda, "Stream", lambda *a, **k: Stream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a, **k: Stream())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", lambda: object())
    return monkeypatch


def test_a_failed_capture_raises(fake_capture):
    """No fallback: a capture that fails raises with its reason, after the
    warm-up steps (two) wrote the saved state back in place."""
    from tpu_reid_torch.train.step_graph import StepGraph

    def graph(g):
        raise RuntimeError("operation not permitted when stream is capturing")

    fake_capture.setattr(torch.cuda, "graph", graph)
    w = torch.zeros(3)
    ptr, calls = w.data_ptr(), []

    def body():
        calls.append(1)
        w.add_(1.0)
        return w.sum()

    with pytest.raises(RuntimeError, match="capturing the step as a CUDA graph failed: "
                                           "RuntimeError: operation not permitted"):
        StepGraph(body, lambda: [w], "cuda")()
    assert len(calls) == 2 and torch.equal(w, torch.zeros(3)) and w.data_ptr() == ptr


def test_a_step_that_rebinds_its_state_is_refused(fake_capture):
    import contextlib

    fake_capture.setattr(torch.cuda, "graph", lambda g: contextlib.nullcontext())
    from tpu_reid_torch.train.step_graph import StepGraph

    state = [torch.zeros(3)]

    def body():
        state[0] = state[0] + 1.0  # a new tensor: a graph would keep writing the old one
        return state[0].sum()

    with pytest.raises(RuntimeError, match="replaced a state tensor while captured"):
        StepGraph(body, lambda: state, "cuda")()
