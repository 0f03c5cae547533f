"""The port's fused_mha, fused_mlp and mha_core (plain versions) against the
JAX package's Pallas kernels run in interpret mode on the same numpy inputs,
the block rebuilt from them, and multi_head_attention / attention_core
against the JAX layers; the CUDA kernels against their plain versions where
a card is present."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_reid.models import layers as JL
from tpu_reid.ops import attention as JA
from tpu_reid.ops import fused_attention as JFA
from tpu_reid_torch.models import layers as TL
from tpu_reid_torch.ops import attention as TA
from tpu_reid_torch.ops import fused_attention as TFA

ATOL, RTOL = 5e-5, 1e-4  # fp32 block tolerance of tests/test_ops.py
FAST_TOL = 3e-2  # the fast softmax's exp2 clamp, ~3e-2 before normalisation


def _f(rng, *shape, sc=0.05):
    return (rng.randn(*shape) * sc).astype(np.float32)


def _mha_args(seed, b=3, s=9, d=32):
    rng = np.random.RandomState(seed)
    return dict(x=_f(rng, b, s, d, sc=1.0), w_in=_f(rng, d, 3 * d, sc=0.2),
                b_in=_f(rng, 3 * d, sc=0.01), w_out=_f(rng, d, d, sc=0.2),
                b_out=_f(rng, d, sc=0.01), ln_scale=1 + _f(rng, d), ln_bias=_f(rng, d))


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _mask(s, kind):
    if kind == "causal":
        return np.triu(np.full((s, s), -np.inf, np.float32), k=1)
    if kind == "row":  # one query row masked out entirely
        m = np.zeros((s, s), np.float32)
        m[2] = -np.inf
        return m
    return None


@pytest.mark.parametrize("pre_ln", [False, True])
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("mask_kind", [None, "causal", "row"])
def test_fused_mha_reference_matches_pallas_interpret(pre_ln, fast, mask_kind):
    """B=3 with block_b=2: the Pallas grid pads the batch (and S to 128)."""
    a = _mha_args(3 + 2 * pre_ln + 4 * fast)
    s = a["x"].shape[1]
    mask = _mask(s, mask_kind)
    ln = (a["ln_scale"], a["ln_bias"]) if pre_ln else (None, None)
    want = JFA.fused_mha(_j(a["x"]), _j(a["w_in"]), _j(a["b_in"]), _j(a["w_out"]),
                         _j(a["b_out"]), 4, _j(mask), _j(ln[0]), _j(ln[1]), block_b=2,
                         interpret=True, fast=fast)
    got = TFA.fused_mha_reference(_t(a["x"]), _t(a["w_in"]), _t(a["b_in"]), _t(a["w_out"]),
                                  _t(a["b_out"]), 4, _t(mask), _t(ln[0]), _t(ln[1]), fast)
    assert torch.isfinite(got).all()
    tol = FAST_TOL if fast else ATOL
    rows = [r for r in range(s) if not (mask_kind == "row" and not fast and r == 2)]
    # a fully masked row under the exact softmax is uniform over the real
    # columns here and in the CUDA kernel, over the 128 padded ones in the
    # Pallas kernel: only its finiteness is compared
    np.testing.assert_allclose(got.numpy()[:, rows], np.asarray(want)[:, rows], atol=tol,
                               rtol=RTOL)
    if mask_kind == "row" and not fast:
        # the port's semantics for that row: -inf read as -1e30, so the row
        # is uniform over the real columns, as the plain core with that
        # finite mask gives it
        finite = _t(np.where(np.isinf(mask), np.float32(-1e30), mask))
        p = {"in_proj": {"w": _t(a["w_in"]), "b": _t(a["b_in"])},
             "out_proj": {"w": _t(a["w_out"]), "b": _t(a["b_out"])}}
        x = _t(a["x"])
        h = TL.layer_norm({"scale": _t(ln[0]), "bias": _t(ln[1])}, x) if pre_ln else x
        with TL.kernel_impl("plain"):
            plain = TL.multi_head_attention(p, h, 4, finite) + (x if pre_ln else 0)
        np.testing.assert_allclose(got.numpy()[:, 2], plain.numpy()[:, 2], atol=ATOL,
                                   rtol=RTOL)
        v = (h @ p["in_proj"]["w"] + p["in_proj"]["b"])[..., 2 * 32:]
        uniform = v.mean(dim=1) @ p["out_proj"]["w"] + p["out_proj"]["b"]
        np.testing.assert_allclose(got.numpy()[:, 2], (uniform + (x[:, 2] if pre_ln else 0))
                                   .numpy(), atol=ATOL, rtol=RTOL)
    if fast:  # the exp2 form before the clamp is exp: equal to the exact form in fp32
        exact = TFA.fused_mha_reference(_t(a["x"]), _t(a["w_in"]), _t(a["b_in"]),
                                        _t(a["w_out"]), _t(a["b_out"]), 4, _t(mask),
                                        _t(ln[0]), _t(ln[1]), False)
        if mask_kind != "row":
            np.testing.assert_allclose(got.numpy(), exact.numpy(), atol=1e-5, rtol=1e-4)
    # the wrappers on CPU tensors are the plain version and launch nothing
    before = (TFA.fused_mha.launches, TA.mha_core.launches, TFA.ln_gemm.launches)
    wrapped = TFA.fused_mha(_t(a["x"]), _t(a["w_in"]), _t(a["b_in"]), _t(a["w_out"]),
                            _t(a["b_out"]), 4, _t(mask), _t(ln[0]), _t(ln[1]), fast)
    assert torch.equal(wrapped, got)
    assert before == (TFA.fused_mha.launches, TA.mha_core.launches, TFA.ln_gemm.launches)


def test_fused_mha_fast_fully_masked_row_is_zero():
    """Without the max-subtraction a fully masked row sums to 0; the
    denominator floor makes its attention output 0 (so the row is the
    out-projection bias), not inf/NaN."""
    a = _mha_args(21)
    got = TFA.fused_mha_reference(_t(a["x"]), _t(a["w_in"]), _t(a["b_in"]), _t(a["w_out"]),
                                  _t(a["b_out"]), 4, _t(_mask(9, "row")), fast=True)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got[:, 2], _t(a["b_out"]).expand(3, -1))


@pytest.mark.parametrize("seed", [0, 1])
def test_fused_mlp_reference_matches_pallas_interpret(seed):
    rng = np.random.RandomState(40 + seed)
    b, s, d, hid = 3, 7 + seed, 32, 128
    x = _f(rng, b, s, d, sc=1.0)
    args = (1 + _f(rng, d), _f(rng, d), _f(rng, d, hid, sc=0.2), _f(rng, hid, sc=0.01),
            _f(rng, hid, d, sc=0.1), _f(rng, d, sc=0.01))
    want = JFA.fused_mlp(_j(x), *(_j(v) for v in args), block_b=2, interpret=True)
    got = TFA.fused_mlp_reference(_t(x), *(_t(v) for v in args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    assert torch.equal(TFA.fused_mlp(_t(x), *(_t(v) for v in args)), got)
    # bf16: the hidden activation rounds after QuickGELU, as the kernel's
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want_bf = JFA.fused_mlp(xb, *(_j(v) if i in (0, 1) else _j(v).astype(jnp.bfloat16)
                                  for i, v in enumerate(args)), block_b=2, interpret=True)
    got_bf = TFA.fused_mlp_reference(_t(x).bfloat16(), *(
        _t(v) if i in (0, 1) else _t(v).bfloat16() for i, v in enumerate(args)))
    np.testing.assert_allclose(got_bf.float().numpy(),
                               np.asarray(want_bf.astype(jnp.float32)), atol=5e-2, rtol=2e-2)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [5, 13])
def test_mha_core_reference_matches_pallas_interpret(causal, s):
    rng = np.random.RandomState(s + causal)
    b, h, dh = 2, 3, 16
    q, k, v = (rng.randn(b, s, h, dh).astype(np.float32) for _ in range(3))
    mask = _mask(s, "causal" if causal else None)
    want = JA.mha_core(*(_j(t) for t in (q, k, v)), _j(mask), interpret=True)
    got = TA.mha_core_reference(*(_t(t) for t in (q, k, v)), _t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6, rtol=1e-5)
    # the XLA core: the same function, softmax normalised before p@v
    xla = JA.xla_mha_core(*(_j(t) for t in (q, k, v)), _j(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(xla), atol=2e-6, rtol=1e-5)
    # the wrapper on CPU tensors and the dispatcher are the plain versions
    before = TA.mha_core.launches
    assert torch.equal(TA.mha_core(*(_t(t) for t in (q, k, v)), _t(mask)), got)
    assert TA.mha_core.launches == before
    with TL.kernel_impl("plain"):
        core = TA.attention_core(*(_t(t) for t in (q, k, v)), _t(mask))
    np.testing.assert_allclose(core.numpy(), np.asarray(xla), atol=2e-6, rtol=1e-5)
    with TL.kernel_impl("kernel"):
        assert torch.equal(TA.attention_core(*(_t(t) for t in (q, k, v)), _t(mask)), got)


def test_mha_core_divides_and_the_block_core_multiplies():
    """The two normalisations of the JAX kernels (`_attn_kernel` divides,
    `_attention_heads` multiplies by the reciprocal) differ by at most an
    fp32 ulp before the cast."""
    rng = np.random.RandomState(5)
    q, k, v = (torch.from_numpy(rng.randn(2, 11, 2, 64).astype(np.float32)) for _ in range(3))
    div = TA.mha_core_reference(q, k, v)
    mul = TA.softmax_attention(q, k, v, None, False, divide=False)
    assert float((div - mul).abs().max()) <= 2 * float(np.finfo(np.float32).eps) * float(
        div.abs().max())
    qkv = torch.cat([t.reshape(2, 11, 128) for t in (q, k, v)], dim=-1)
    torch.testing.assert_close(TFA.attention_reference(qkv, 2), mul.reshape(2, 11, 128),
                               atol=0, rtol=0)


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("splice", [False, True])
def test_fused_block_is_fused_mlp_of_fused_mha(fast, splice):
    rng = np.random.RandomState(7 + fast + 2 * splice)
    b, s, d, hid = 2, 9, 32, 128
    x = torch.from_numpy(_f(rng, b, s, d, sc=1.0))
    w = [torch.from_numpy(a) for a in (
        1 + _f(rng, d), _f(rng, d), _f(rng, d, 3 * d, sc=0.2), _f(rng, 3 * d),
        _f(rng, d, d, sc=0.2), _f(rng, d), 1 + _f(rng, d), _f(rng, d),
        _f(rng, d, hid, sc=0.2), _f(rng, hid), _f(rng, hid, d, sc=0.1), _f(rng, d))]
    kw = {}
    if splice:
        pm = torch.zeros(s, 1)
        pm[s - 2:] = 1.0
        kw = dict(prompt_plane=torch.from_numpy(_f(rng, s, d, sc=1.0)), prompt_mask=pm)
    mask = TL.causal_mask(s)
    block = TFA.fused_block_reference(x, *w, 4, mask, fast=fast, **kw)
    x1 = TFA.fused_mha_reference(x, w[2], w[3], w[4], w[5], 4, mask, w[0], w[1], fast, **kw)
    assert torch.equal(block, TFA.fused_mlp_reference(x1, *w[6:]))
    assert torch.equal(TFA.fused_block(x, *w, 4, mask, fast=fast, **kw), block)


def test_fused_mha_refuses_the_splice_without_ln():
    a = _mha_args(9)
    plane, pm = torch.zeros(9, 32), torch.ones(9, 1)
    for fn in (TFA.fused_mha, TFA.fused_mha_reference):
        with pytest.raises(ValueError, match="pre-LN"):
            fn(_t(a["x"]), _t(a["w_in"]), _t(a["b_in"]), _t(a["w_out"]), _t(a["b_out"]), 4,
               prompt_plane=plane, prompt_mask=pm)


@pytest.mark.parametrize("impl", ["plain", "kernel"])
@pytest.mark.parametrize("causal", [False, True])
def test_multi_head_attention_matches_jax(impl, causal):
    rng = np.random.RandomState(11 + causal)
    d, s = 64, 10
    p = {"in_proj": {"w": _f(rng, d, 3 * d, sc=0.1), "b": _f(rng, 3 * d)},
         "out_proj": {"w": _f(rng, d, d, sc=0.1), "b": _f(rng, d)}}
    x = _f(rng, 2, s, d, sc=1.0)
    jp = {k: {n: jnp.asarray(v) for n, v in sub.items()} for k, sub in p.items()}
    tp = {k: {n: torch.from_numpy(v) for n, v in sub.items()} for k, sub in p.items()}
    with JL.attention_impl("xla"):
        want = JL.multi_head_attention(jp, jnp.asarray(x), 4,
                                       JL.causal_mask(s) if causal else None)
    with TL.kernel_impl(impl):
        got = TL.multi_head_attention(tp, torch.from_numpy(x), 4,
                                      TL.causal_mask(s) if causal else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


# ---------------------------------------------------------------------------
# on the card: each CUDA kernel against its plain version
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("pre_ln", [False, True])
def test_cuda_fused_mha_and_mlp_match_plain(cuda, dtype, fast, pre_ln):
    rng = np.random.RandomState(0)
    b, s, d, hid = 4, 77, 128, 512

    def f(*shape, sc=0.05, dt=dtype):
        return torch.from_numpy(_f(rng, *shape, sc=sc)).to(cuda, dt)

    x = f(b, s, d, sc=1.0)
    ln = (1 + f(d, dt=torch.float32), f(d, dt=torch.float32)) if pre_ln else (None, None)
    args = (x, f(d, 3 * d, sc=0.1), f(3 * d), f(d, d, sc=0.1), f(d), 2,
            TL.causal_mask(s, device=cuda), *ln, fast)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    got, want = TFA.fused_mha(*args), TFA.fused_mha_reference(*args)
    torch.cuda.synchronize()
    assert float((got.float() - want.float()).abs().max()) <= tol * float(want.abs().max())
    margs = (x, 1 + f(d, dt=torch.float32), f(d, dt=torch.float32), f(d, hid, sc=0.1),
             f(hid), f(hid, d, sc=0.05), f(d))
    got, want = TFA.fused_mlp(*margs), TFA.fused_mlp_reference(*margs)
    torch.cuda.synchronize()
    assert float((got.float() - want.float()).abs().max()) <= tol * float(want.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_mha_core_on_views_and_contiguous(cuda, dtype):
    rng = np.random.RandomState(1)
    b, s, h = 3, 211, 4
    qkv = torch.from_numpy(rng.randn(b, s, 3 * h * 64).astype(np.float32)).to(cuda, dtype)
    views = TFA._qkv_views(qkv, h)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for q, k, v in (views, tuple(t.contiguous() for t in views)):
        got, want = TA.mha_core(q, k, v), TA.mha_core_reference(q, k, v)
        torch.cuda.synchronize()
        assert float((got.float() - want.float()).abs().max()) <= tol * float(
            want.abs().max())
    with pytest.raises(ValueError):
        TA.mha_core(views[0].transpose(1, 2), views[1], views[2])
