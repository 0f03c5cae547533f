"""Gradients through the kernels: the block and tail autograd Functions
(always taken by residual_block / ln_proj_tail under kernel_impl("kernel");
on CPU tensors their forward is the kernels' plain
versions) against jax.vjp of what the JAX package's custom VJPs compute —
`_block_xla_impl` after the splice, and `_tail_xla` — fp32 within 1e-5; the
block's written-out fp32 backward chain (`fused_block_backward`, the route
of fp32 tensors) against autograd of the plain block, and its routing; and
the raw kernel wrappers, which still refuse autograd."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_reid.models import layers as JL
from tpu_reid.ops import fused_tail as JFT
from tpu_reid_torch.models import layers as TL
from tpu_reid_torch.ops import attention as TA
from tpu_reid_torch.ops import fused_attention as TFA
from tpu_reid_torch.ops import fused_tail as TFT
from tpu_reid_torch.train.optim import paths

TOL = 1e-5
D, HID, HEADS = 64, 256, 4


def _block_params(rng):
    def f(*shape, sc=0.05, mean=0.0):
        return (mean + rng.randn(*shape) * sc).astype(np.float32)

    return {
        "attn": {"in_proj": {"w": f(D, 3 * D, sc=0.1), "b": f(3 * D, sc=0.01)},
                 "out_proj": {"w": f(D, D, sc=0.1), "b": f(D, sc=0.01)}},
        "ln_1": {"scale": f(D, mean=1.0), "bias": f(D)},
        "mlp": {"c_fc": {"w": f(D, HID, sc=0.1), "b": f(HID, sc=0.01)},
                "c_proj": {"w": f(HID, D, sc=0.05), "b": f(D, sc=0.01)}},
        "ln_2": {"scale": f(D, mean=1.0), "bias": f(D)},
    }


def _torch_tree(tree, requires_grad=True):
    if isinstance(tree, dict):
        return {k: _torch_tree(v, requires_grad) for k, v in tree.items()}
    return torch.from_numpy(tree).requires_grad_(requires_grad)


def _rel_close(got, want, tol=TOL):
    want = np.asarray(want)
    err = float(np.abs(got.detach().float().numpy() - want).max())
    assert err <= tol * max(float(np.abs(want).max()), 1.0), err


@pytest.mark.parametrize("splice", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_block_function_matches_jax_vjp(splice, causal):
    rng = np.random.RandomState(1 + splice + 2 * causal)
    b, s = 3, 10
    p = _block_params(rng)
    x = rng.randn(b, s, D).astype(np.float32)
    g = rng.randn(b, s, D).astype(np.float32)
    plane = rng.randn(s, D).astype(np.float32)
    pmask = np.zeros((s, 1), np.float32)
    pmask[s - 2:] = 1.0
    jmask = JL.causal_mask(s) if causal else None

    def ref(p_, x_, plane_):
        xs = JL._apply_splice_plane(x_, plane_, jnp.asarray(pmask)) if splice else x_
        return JL._block_xla_impl(p_, xs, HEADS, jmask)

    want, vjp = jax.vjp(ref, jax.tree.map(jnp.asarray, p), jnp.asarray(x), jnp.asarray(plane))
    dp, dx, dplane = vjp(jnp.asarray(g))

    tp = _torch_tree(p)
    tx = torch.from_numpy(x).requires_grad_()
    tplane = torch.from_numpy(plane).requires_grad_()
    kw = dict(prompt_plane=tplane, prompt_mask=torch.from_numpy(pmask)) if splice else {}
    with TL.kernel_impl("kernel"):
        out = TL.residual_block(tp, tx, HEADS, TL.causal_mask(s) if causal else None, **kw)
    assert type(out.grad_fn).__name__ == "_FusedBlockFnBackward"
    _rel_close(out, want)
    named = list(paths(tp))
    inputs = [tx] + [t for _, t in named] + ([tplane] if splice else [])
    grads = torch.autograd.grad(out, inputs, torch.from_numpy(g))
    _rel_close(grads[0], dx)
    for got, (path, _) in zip(grads[1:1 + len(named)], named):
        want_leaf = dp
        for k in path:
            want_leaf = want_leaf[k]
        _rel_close(got, want_leaf)
    if splice:
        _rel_close(grads[-1], dplane)


def test_block_function_bf16_grads_reach_the_fp32_master_weights():
    """bf16 activations, fp32 parameters: the casts stay outside the
    Function, so the gradients arrive in fp32, equal to the plain block's
    (the backward IS the plain block's recompute)."""
    rng = np.random.RandomState(7)
    p = _block_params(rng)
    x = torch.from_numpy(rng.randn(2, 9, D).astype(np.float32)).bfloat16()
    g = torch.from_numpy(rng.randn(2, 9, D).astype(np.float32)).bfloat16()
    grads = {}
    for impl in ("kernel", "plain"):
        tp = _torch_tree(p)
        xi = x.clone().requires_grad_()
        with TL.kernel_impl(impl):
            out = TL.residual_block(tp, xi, HEADS)
        leaves = [t for _, t in paths(tp)]
        grads[impl] = torch.autograd.grad(out, [xi] + leaves, g)
        assert all(gr.dtype == torch.float32 for gr in grads[impl][1:])
    for a, b in zip(grads["kernel"], grads["plain"]):
        assert torch.equal(a, b)


def _block_case(rng, b, s, splice, causal):
    p = _torch_tree(_block_params(rng), requires_grad=False)
    x = torch.from_numpy(rng.randn(b, s, D).astype(np.float32))
    g = torch.from_numpy(rng.randn(b, s, D).astype(np.float32))
    plane = torch.from_numpy(rng.randn(s, D).astype(np.float32)) if splice else None
    pmask = torch.zeros(s, 1)
    pmask[s - 2:] = 1.0
    mask = TL.causal_mask(s) if causal else None
    weights = [p["ln_1"]["scale"], p["ln_1"]["bias"], p["attn"]["in_proj"]["w"],
            p["attn"]["in_proj"]["b"], p["attn"]["out_proj"]["w"], p["attn"]["out_proj"]["b"],
            p["ln_2"]["scale"], p["ln_2"]["bias"], p["mlp"]["c_fc"]["w"], p["mlp"]["c_fc"]["b"],
            p["mlp"]["c_proj"]["w"], p["mlp"]["c_proj"]["b"]]
    return x, g, plane, pmask if splice else None, mask, weights


@pytest.mark.parametrize("rows", [(3, 10), (4, 8)])  # B·S ragged (30) and a multiple of 32
@pytest.mark.parametrize("splice", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_block_backward_chain_matches_autograd(rows, splice, causal):
    """The written-out fp32 chain (the route CUDA tensors take on the
    kernels, here with the plain versions) against autograd of the plain
    block after the splice: x, the 12 tensors and the plane."""
    rng = np.random.RandomState(11 + splice + 2 * causal + 4 * rows[0])
    x, g, plane, pmask, mask, weights = _block_case(rng, *rows, splice, causal)
    assert TFA.block_backward_route(x, weights, HEADS) == "chain"
    needs = (True, splice, False, False, False, False) + (True,) * 12
    dx, dplane, dws = TFA.fused_block_backward(g, x, plane, pmask, mask, HEADS, weights, needs)

    xs = x.clone().requires_grad_()
    ws = [w.clone().requires_grad_() for w in weights]
    inputs = [xs] + ws
    xin = xs
    if splice:
        ps = plane.clone().requires_grad_()
        inputs.append(ps)
        xin = TL._apply_splice_plane(xs, ps, pmask)
    out = TL._block_xla_impl(TFA._block_params(ws), xin, HEADS, mask)
    want = torch.autograd.grad(out, inputs, g)
    got = [dx, *dws] + ([dplane] if splice else [])
    assert len(got) == len(want) == 13 + splice
    for a, w in zip(got, want):
        assert a.shape == w.shape and a.dtype == w.dtype
        _rel_close(a, w.numpy())


def test_block_backward_takes_only_the_gradients_asked_for():
    """A frozen tower (stage 1: only the prompts train) asks for x and the
    plane alone: no weight gradient is computed, and those two are the same
    as with every gradient asked for."""
    rng = np.random.RandomState(23)
    x, g, plane, pmask, mask, weights = _block_case(rng, 2, 9, True, False)
    every = TFA.fused_block_backward(g, x, plane, pmask, mask, HEADS, weights,
                                     (True, True) + (False,) * 4 + (True,) * 12)
    frozen = TFA.fused_block_backward(g, x, plane, pmask, mask, HEADS, weights,
                                      (True, True) + (False,) * 4 + (False,) * 12)
    assert all(w is None for w in frozen[2])
    assert torch.equal(every[0], frozen[0]) and torch.equal(every[1], frozen[1])


def test_block_backward_counters_route_by_dtype():
    """fp32 CPU tensors take the written-out chain on the plain versions (no
    kernel launched, no fallback counted); bf16 keeps the plain block's
    recompute, counted in `.plain`."""
    rng = np.random.RandomState(29)
    fb = TFA.fused_block_backward
    p = _block_params(rng)
    x = torch.from_numpy(rng.randn(2, 9, D).astype(np.float32))
    for dtype, plain in ((torch.float32, 0), (torch.bfloat16, 1)):
        before = (fb.launches, fb.plain)
        tp = _torch_tree(p)
        xi = x.to(dtype).requires_grad_()
        with TL.kernel_impl("kernel"):
            out = TL.residual_block(tp, xi, HEADS)
        out.float().sum().backward()
        assert (fb.launches - before[0], fb.plain - before[1]) == (0, plain)


def test_tail_function_matches_jax_vjp():
    rng = np.random.RandomState(3)
    b, d, e = 5, 32, 16
    x = rng.randn(b, d).astype(np.float32)
    s = (1 + 0.1 * rng.randn(d)).astype(np.float32)
    bb = (0.1 * rng.randn(d)).astype(np.float32)
    proj = (rng.randn(d, e) * 0.1).astype(np.float32)
    gy, gp = rng.randn(b, d).astype(np.float32), rng.randn(b, e).astype(np.float32)
    (wy, wp), vjp = jax.vjp(JFT._tail_xla, *(jnp.asarray(a) for a in (x, s, bb, proj)))
    want = vjp((jnp.asarray(gy), jnp.asarray(gp)))
    ins = [torch.from_numpy(a).requires_grad_() for a in (x, s, bb, proj)]
    with TL.kernel_impl("kernel"):
        y, pr = TFT.ln_proj_tail(ins[0], {"scale": ins[1], "bias": ins[2]}, ins[3])
    assert type(y.grad_fn).__name__ == "_TailFnBackward"
    _rel_close(y, wy)
    _rel_close(pr, wp)
    got = torch.autograd.grad((y, pr), ins, (torch.from_numpy(gy), torch.from_numpy(gp)))
    for a, w in zip(got, want):
        _rel_close(a, w)


def test_raw_kernels_refuse_autograd():
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(2, 6, D).astype(np.float32)).requires_grad_()
    w_in, b_in = torch.zeros(D, 3 * D), torch.zeros(3 * D)
    w_out, b_out = torch.zeros(D, D), torch.zeros(D)
    q = x.reshape(2, 6, HEADS, D // HEADS)
    calls = [
        lambda: TFA.fused_mha(x, w_in, b_in, w_out, b_out, HEADS),
        lambda: TFA.fused_mlp(x, torch.ones(D), torch.zeros(D), torch.zeros(D, HID),
                              torch.zeros(HID), torch.zeros(HID, D), torch.zeros(D)),
        lambda: TA.mha_core(q, q, q),
        lambda: TFA.ln_gemm(x, None, None, w_in, b_in),
        lambda: TFT.ln_proj_tail_kernel(x[:, 0], torch.ones(D), torch.zeros(D),
                                        torch.zeros(D, 8)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="forward-only"):
            call()
        with torch.no_grad():
            call()
