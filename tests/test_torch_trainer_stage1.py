"""run_stage1 of the port against the JAX package's on the same tiny model
(carried across by from_jax_reid_params) and the same fixed batches: coop
(cached image features) and ivlp (live encoder), 2 epochs of 2 batches of
8, fp32: per-epoch losses, and the trained leaves within the bound below."""

import jax.numpy as jnp
import numpy as np
import pytest

from tests.test_torch_reid_model import tiny_models
from tpu_reid.train import optim as JO
from tpu_reid.train import trainer as JTR
from tpu_reid_torch.train import optim as TO
from tpu_reid_torch.train import trainer as TTR

EPOCHS = 2


def fixed_batches(n_batches=2, bs=8, n_cls=6, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_batches):
        images = rng.randn(bs, 32, 16, 3).astype(np.float32)
        labels = np.repeat(rng.choice(n_cls, bs // 4, replace=False), 4)
        out.append((images, labels, np.ones(bs, bool)))
    return out


def epoch_losses(lines, stage):
    return [float(s.split(" loss ")[1].split()[0]) for s in lines if s.startswith(f"[{stage}]")]


def adam_bound(lrs, mult=1.0):
    """Adam moves a leaf by at most ~lr per step whatever the gradient's
    size, so a gradient element near zero whose sign the two frameworks'
    fp32 sums order differently can part the two trajectories by up to
    2*lr per step: the bound on max|Δ| of the trained leaves."""
    return 2.0 * mult * sum(lrs) + 1e-6


def compare_leaves(got, want, predicate, bound):
    jt, _ = JO.partition(want, predicate[0])
    tt, _ = TO.partition(got, predicate[1])
    n = 0
    for path, t in TO.paths(tt):
        if t is None:
            continue
        w = jt
        for k in path:
            w = w[k]
        d = np.abs(t.detach().numpy() - np.asarray(w))
        assert float(d.max()) <= bound, (path, float(d.max()), bound)
        assert float(np.median(d)) <= 1e-6, (path, float(np.median(d)))
        n += 1
    assert n > 0


@pytest.fixture(scope="module", params=["coop", "ivlp"])
def stage1(request):
    mode = request.param
    jcfg, jp, tcfg, tp = tiny_models(mode)
    batches = fixed_batches()
    jlog, tlog = [], []
    tcfg_train = JTR.TrainConfig()
    jout = JTR.run_stage1(jp, jcfg, tcfg_train, lambda e: iter(
        [(jnp.asarray(i), jnp.asarray(lab), v) for i, lab, v in batches]), epochs=EPOCHS,
        batch_size=8, log=jlog.append)
    tout = TTR.run_stage1(tp, tcfg, TTR.TrainConfig(), lambda e: iter(batches), epochs=EPOCHS,
                          batch_size=8, log=tlog.append)
    return mode, jcfg, jp, jout, tcfg, tp, tout, jlog, tlog


def test_stage1_losses_match_jax(stage1):
    mode, *_, jlog, tlog = stage1
    jl, tl = epoch_losses(jlog, "stage1"), epoch_losses(tlog, "stage1")
    assert len(tl) == len(jl) == EPOCHS
    np.testing.assert_allclose(tl, jl, atol=2e-4)  # both logged to 4 decimals
    assert all(np.isfinite(tl))


def test_stage1_trained_leaves_match_jax(stage1):
    mode, jcfg, jp, jout, tcfg, tp, tout, *_ = stage1
    from tpu_reid.models import reid_clip as JM
    from tpu_reid_torch.models import reid_clip as TM

    lrs = [TTR.S.cosine_warmup_lr(e, 3.5e-4, EPOCHS) for e in range(1, EPOCHS + 1)]
    steps = 2  # per epoch (the cached path: 16 features in batches of 8)
    bound = adam_bound([lr for lr in lrs for _ in range(steps)])
    compare_leaves(tout, jout, (lambda p: JM.stage1_trainable(p, jcfg),
                                lambda p: TM.stage1_trainable(p, tcfg)), bound)
    # what stage 1 trains moved; the rest is the input, untouched
    before = tp["prompt_learner"]["cls_ctx"]
    assert not np.allclose(tout["prompt_learner"]["cls_ctx"].numpy(), before.numpy())
    assert all(a is b for (_, a), (_, b) in zip(TO.paths(tout["clip"]["visual"]["blocks"]),
                                                TO.paths(tp["clip"]["visual"]["blocks"])))
    if mode == "ivlp":
        assert not np.allclose(tout["clip"]["visual"]["vpt_shallow"].numpy(),
                               tp["clip"]["visual"]["vpt_shallow"].numpy())
