"""One batch's gradients of the port's stage-1 loss against the JAX
package's, leaf by leaf, on the tiny model of tests/test_torch_reid_model.py
(carried across by from_jax_reid_params): coop (cached image features) and
ivlp (live encoder, deep prompts of both towers), fp32, through the plain
blocks and through the blocks' autograd Functions.

The JAX gradients come from JAX's own jitted step (make_stage1_step) given
an optimizer whose state after the step is the step's gradients. Each leaf
is held elementwise within 1e-4 of its own max|grad|: both are fp32
gradients of the same function, apart in the order of their sums only. A
gradient that is wrong on one layer of vpt_deep or one class row of cls_ctx
fails here, where the few-step trajectories of test_torch_trainer_stage1.py
cannot see it."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_torch_reid_model import tiny_models
from tpu_reid.models import reid_clip as JM
from tpu_reid.train import optim as JO
from tpu_reid.train import trainer as JTR
from tpu_reid_torch.models import reid_clip as TM
from tpu_reid_torch.ops._build import kernel_impl
from tpu_reid_torch.train import optim as TO
from tpu_reid_torch.train import trainer as TTR

GRAD_TOL = 1e-4


def grad_capture():
    """An optax transformation that updates nothing and keeps the step's
    gradients as its state."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (jax.tree.map(jnp.zeros_like, grads), grads))


def batch_arrays(seed, bs=8, n_cls=6):
    """Images, PK labels (2 ids x 4) and a valid mask with its last row
    padded out."""
    rng = np.random.RandomState(seed)
    images = rng.randn(bs, 32, 16, 3).astype(np.float32)
    labels = np.repeat(rng.choice(n_cls, bs // 4, replace=False), 4)
    valid = np.ones(bs, bool)
    valid[-1] = False
    return rng, images, labels, valid


def port_grads(tp, predicate, loss_fn, impl):
    """(loss, {path: grad}) of loss_fn(params) over the trainable leaves."""
    tt, tf = TO.partition(tp, predicate)
    tt = TTR._trainable_copy(tt)
    named = [(path, t) for path, t in TO.paths(tt) if t is not None]
    with kernel_impl(impl):
        loss = loss_fn(TO.combine(tt, tf))
        grads = torch.autograd.grad(loss, [t for _, t in named])
    return float(loss.detach()), {path: g for (path, _), g in zip(named, grads)}


def compare_grads(got, jgrads):
    assert got
    for path, g in got.items():
        want = jgrads
        for k in path:
            want = want[k]
        want = np.asarray(want)
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=GRAD_TOL * scale + 1e-12,
                                   err_msg=str(path))


@pytest.fixture(scope="module", params=["coop", "ivlp"])
def stage1(request):
    mode = request.param
    cached = mode == "coop"
    jcfg, jp, tcfg, tp = tiny_models(mode)
    rng, images, labels, valid = batch_arrays(2)
    batch = {"labels": labels, "valid": valid}
    if cached:
        batch["image_features"] = rng.randn(len(labels), 32).astype(np.float32)
    else:
        batch["images"] = images
    jt, jf = JO.partition(jp, lambda p: JM.stage1_trainable(p, jcfg))
    opt = grad_capture()
    step = JTR.make_stage1_step(jcfg, opt, cached)
    _, jgrads, jloss = step(jt, jf, opt.init(jt), {k: jnp.asarray(v) for k, v in batch.items()})
    return mode, tcfg, tp, batch, float(jloss), jgrads


@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_stage1_gradients_match_jax(stage1, impl):
    mode, tcfg, tp, batch, jloss, jgrads = stage1
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, grads = port_grads(tp, lambda p: TM.stage1_trainable(p, tcfg),
                             lambda params: TTR.stage1_loss(tcfg, params, tbatch), impl)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    compare_grads(grads, jgrads)
    names = {path[-1] for path in grads}
    assert "cls_ctx" in names
    if mode == "ivlp":
        assert {"vpt_shallow", "vpt_deep"} <= names
