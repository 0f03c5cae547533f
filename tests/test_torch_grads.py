"""Gradients through the kernels: the block and tail autograd Functions
(always taken by residual_block / ln_proj_tail under kernel_impl("kernel");
on CPU tensors their forward is the kernels' plain
versions) against jax.vjp of what the JAX package's custom VJPs compute —
`_block_xla_impl` after the splice, and `_tail_xla` — fp32 within 1e-5; and
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
