"""The port's training losses, schedules and optimizer against the JAX
package's: loss values and gradients against jax.grad (tied hardest pairs
included), the two lr schedules, torch Adam with the bias group against
optax's torch_adam over 5 steps, the partitions and GPA."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_reid.train import losses as JLo
from tpu_reid.train import optim as JO
from tpu_reid.train import schedules as JS
from tpu_reid.train import trainer as JTR
from tpu_reid_torch.train import losses as TLo
from tpu_reid_torch.train import optim as TO
from tpu_reid_torch.train import schedules as TS

TOL = 1e-5


def _grad_pair(jfn, tfn, feats, *rest):
    """(value, grad) of jfn and tfn w.r.t. the first argument."""
    jv, jg = jax.value_and_grad(lambda f: jfn(f, *(jnp.asarray(r) for r in rest)))(
        jnp.asarray(feats))
    tf = torch.from_numpy(feats).requires_grad_()
    tv = tfn(tf, *(torch.from_numpy(np.asarray(r)) for r in rest))
    (tg,) = torch.autograd.grad(tv, tf)
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-4, atol=TOL)


def _tied_feats():
    """Anchor 0 has its two positives at exactly equal distance and its two
    negatives at equal distance: the hardest pairs tie."""
    x = np.zeros((8, 4), np.float32)
    x[0] = [0, 0, 0, 0]
    x[1], x[2] = [1, 0, 0, 0], [-1, 0, 0, 0]
    x[3], x[4] = [0, 2, 0, 0], [0, -2, 0, 0]
    x[5:] = np.random.RandomState(0).randn(3, 4)
    labels = np.array([0, 0, 0, 1, 2, 1, 2, 3])
    return x, labels


@pytest.mark.parametrize("margin", [0.3, None])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("tied", [False, True])
def test_triplet_loss_matches_jax(margin, masked, tied):
    if tied:
        feats, labels = _tied_feats()
    else:
        rng = np.random.RandomState(1)
        feats, labels = rng.randn(8, 6).astype(np.float32), np.repeat(np.arange(4), 2)
    valid = np.array([1, 1, 1, 1, 1, 1, 0, 1], bool) if masked else None
    _grad_pair(lambda f, lab, *v: JLo.triplet_loss(f, lab, margin=margin,
                                                   valid=v[0] if v else None),
               lambda f, lab, *v: TLo.triplet_loss(f, lab, margin=margin,
                                                   valid=v[0] if v else None),
               feats, labels, *(() if valid is None else (valid,)))


def test_hard_mining_splits_tied_gradients_evenly():
    feats, labels = _tied_feats()
    d = torch.from_numpy(np.array([[0.0, 2.0, 2.0, 5.0]], np.float32)).requires_grad_()
    ap, _ = TLo.batch_hard_mining(d, torch.tensor([0]), torch.tensor([0, 0, 0, 1]))
    (g,) = torch.autograd.grad(ap.sum(), d)
    np.testing.assert_array_equal(g.numpy(), [[0.0, 0.5, 0.5, 0.0]])
    jd = jnp.asarray(d.detach().numpy())
    jg = jax.grad(lambda x: JLo.batch_hard_mining(x, jnp.array([0]),
                                                  jnp.array([0, 0, 0, 1]))[0].sum())(jd)
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))


@pytest.mark.parametrize("masked", [False, True])
def test_supcon_and_cross_entropies_match_jax(masked):
    rng = np.random.RandomState(2)
    a = rng.randn(6, 8).astype(np.float32)
    c = rng.randn(6, 8).astype(np.float32)
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    labels = np.array([0, 1, 0, 2, 1, 3])
    valid = np.array([1, 1, 1, 0, 1, 1], bool) if masked else None
    kw = lambda v: dict(anchor_valid=v, contrast_valid=v)  # noqa: E731
    _grad_pair(lambda f, cc, lab, *v: JLo.supcon_loss(f, cc, lab, lab, **kw(v[0] if v else None)),
               lambda f, cc, lab, *v: TLo.supcon_loss(f, cc, lab, lab, **kw(v[0] if v else None)),
               a, c, labels, *(() if valid is None else (valid,)))
    logits = rng.randn(6, 5).astype(np.float32) * 3
    lab = np.array([0, 4, 2, 2, 1, 3])
    vkw = {} if valid is None else {"valid": valid}
    _grad_pair(lambda f, lb, *v: JLo.cross_entropy_label_smooth(f, lb, 0.1, *v),
               lambda f, lb, *v: TLo.cross_entropy_label_smooth(f, lb, 0.1, *v),
               logits, lab, *vkw.values())
    _grad_pair(lambda f, lb, *v: JLo.cross_entropy(f, lb, *v),
               lambda f, lb, *v: TLo.cross_entropy(f, lb, *v), logits, lab, *vkw.values())
    x, y = rng.randn(6, 4).astype(np.float32), rng.randn(6, 4).astype(np.float32) * 2
    _grad_pair(lambda f, yy, *v: JTR.smooth_l1(f, yy, *v),
               lambda f, yy, *v: TLo.smooth_l1(f, yy, *v), x, y, *vkw.values())
    np.testing.assert_allclose(TLo.euclidean_dist(torch.from_numpy(a), torch.from_numpy(c)),
                               np.asarray(JLo.euclidean_dist(jnp.asarray(a), jnp.asarray(c))),
                               atol=1e-6)


def test_schedules_match_jax():
    for e in range(0, 130):
        assert TS.cosine_warmup_lr(e, 3.5e-4, 120) == JS.cosine_warmup_lr(e, 3.5e-4, 120)
        assert TS.warmup_multistep_lr(e, 5e-6) == JS.warmup_multistep_lr(e, 5e-6)


@pytest.mark.parametrize("bias_lr_mult", [1.0, 2.0])
def test_adam_with_bias_group_matches_optax_torch_adam(bias_lr_mult):
    """5 steps of coupled-L2 Adam (lr set per step, as per epoch) on a tree
    with bias and non-bias leaves and a leaf without gradient."""
    rng = np.random.RandomState(3)
    tree = {"layer": {"w": rng.randn(4, 3).astype(np.float32), "b": rng.randn(3).astype(
        np.float32)}, "ln": {"scale": rng.randn(3).astype(np.float32),
                             "bias": rng.randn(3).astype(np.float32)},
            "unused": rng.randn(2).astype(np.float32)}
    grads = [jax.tree.map(lambda a, k=k: np.random.RandomState(10 + k).randn(*a.shape).astype(
        np.float32), tree) for k in range(5)]
    for g in grads:
        g["unused"] = np.zeros(2, np.float32)
    lrs = [1e-2, 2e-2, 5e-3, 1e-2, 3e-2]
    opt = JO.make_stage_optimizer(1e-2, 1e-4, bias_lr_mult=bias_lr_mult)
    jp = jax.tree.map(jnp.asarray, tree)
    state = opt.init(jp)
    for g, lr in zip(grads, lrs):
        state = JO.set_lr(state, lr)
        upd, state = opt.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, upd)
    tp = jax.tree.map(lambda a: torch.from_numpy(a.copy()).requires_grad_(), tree)
    topt = TO.make_stage_optimizer(tp, 1e-2, 1e-4, bias_lr_mult=bias_lr_mult)
    assert len(topt.param_groups) == (2 if bias_lr_mult != 1 else 1)
    for g, lr in zip(grads, lrs):
        TO.set_lr(topt, lr)
        for (path, t) in TO.paths(tp):
            gg = g
            for k in path:
                gg = gg[k]
            t.grad = torch.from_numpy(gg)
        topt.step()
    for path, t in TO.paths(tp):
        want = jp
        for k in path:
            want = want[k]
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_partition_combine_count_and_gpa():
    rng = np.random.RandomState(4)
    tree = {"a": {"w": torch.from_numpy(rng.randn(3, 2).astype(np.float32)),
                  "b": torch.zeros(2)},
            "eot": torch.tensor([3, 1], dtype=torch.int32)}
    t, f = TO.partition(tree, lambda p: p[-1] == "w")
    assert t["a"]["b"] is None and f["a"]["w"] is None and f["eot"] is tree["eot"]
    assert TO.count_params(t) == 6 and TO.count_params(f) == 4
    back = TO.combine(t, f)
    assert all(x is y for (_, x), (_, y) in zip(TO.paths(back), TO.paths(tree)))
    w = TO.gauss_weights(60, 45, 10)
    np.testing.assert_allclose(w, JO.gauss_weights(60, 45, 10))
    jtree = jax.tree.map(lambda x: jnp.asarray(x.numpy()), tree)
    jg = tg = None
    for k in range(3):
        jg = JO.gpa_update(jg, jtree, float(w[k]))
        tg = TO.gpa_update(tg, tree, float(w[k]))
    np.testing.assert_allclose(tg["a"]["w"].numpy(), np.asarray(jg["a"]["w"]), rtol=1e-6)
    assert tg["eot"] is tree["eot"]
