"""tpu_reid_torch.ops: the plain versions of the block and tail kernels held
against the JAX package's Pallas kernels (interpret mode) and plain XLA
compositions on the same inputs; the CUDA kernels against their plain
versions where a card is present."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_reid.ops import attention as JA
from tpu_reid.ops import fused_attention as JFA
from tpu_reid.ops import fused_tail as JFT
from tpu_reid_torch.models import layers as TL
from tpu_reid_torch.ops import attention as TA
from tpu_reid_torch.ops import fused_attention as TFA
from tpu_reid_torch.ops import fused_tail as TFT

ATOL, RTOL = 5e-5, 1e-4  # fp32 block tolerance of tests/test_ops.py


def _block_args(seed, b=3, s=9, d=32, hid=128):
    rng = np.random.RandomState(seed)
    f = lambda *shape, sc=0.05: (rng.randn(*shape) * sc).astype(np.float32)  # noqa: E731
    args = dict(
        ln1_scale=1 + f(d), ln1_bias=f(d),
        w_in=f(d, 3 * d), b_in=f(3 * d, sc=0.01),
        w_out=f(d, d), b_out=f(d, sc=0.01),
        ln2_scale=1 + f(d), ln2_bias=f(d),
        w_fc=f(d, hid), b_fc=f(hid, sc=0.01),
        w_proj=f(hid, d), b_proj=f(d, sc=0.01),
    )
    x = f(b, s, d, sc=1.0)
    plane = f(s, d, sc=1.0)
    pmask = np.zeros((s, 1), np.float32)
    pmask[s - 2:] = 1.0  # vision deep prompts: the last rows
    return x, args, plane, pmask


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("splice", [False, True])
def test_fused_block_reference_matches_pallas_interpret(fast, causal, splice):
    x, args, plane, pmask = _block_args(11 + 2 * fast + 4 * causal + 8 * splice)
    s = x.shape[1]
    mask = np.triu(np.full((s, s), -np.inf, np.float32), k=1) if causal else None
    kw = dict(prompt_plane=plane, prompt_mask=pmask) if splice else {}
    want = JFA.fused_block(
        jnp.asarray(x), *(jnp.asarray(v) for v in args.values()), 4,
        None if mask is None else jnp.asarray(mask), block_b=2, interpret=True,
        fast=fast, **{k: jnp.asarray(v) for k, v in kw.items()},
    )
    t = {k: torch.from_numpy(v) for k, v in args.items()}
    tkw = {k: torch.from_numpy(v) for k, v in kw.items()}
    tmask = None if mask is None else torch.from_numpy(mask)
    got = TFA.fused_block_reference(torch.from_numpy(x), **t, n_heads=4, mask=tmask,
                                    fast=fast, **tkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    # the wrapper chain on CPU tensors is the plain version, and launches nothing
    counters = (TFA.ln_gemm, TA.mha_core, TFA.gemm_bias_residual, TFA.fused_mha,
                TFA.fused_mlp, TFA.fused_block)
    before = [c.launches for c in counters]
    wrapped = TFA.fused_block(torch.from_numpy(x), **t, n_heads=4, mask=tmask, fast=fast,
                              **tkw)
    assert torch.equal(wrapped, got)
    assert before == [c.launches for c in counters]


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_attention_reference_matches_xla_core(fast, causal):
    """The attention kernel's plain version == the JAX XLA core on a qkv
    buffer (fp32: the fast exp2 form equals exp before the clamp)."""
    rng = np.random.RandomState(3)
    b, s, h, dh = 2, 13, 4, 16
    qkv = rng.randn(b, s, 3 * h * dh).astype(np.float32) * 0.5
    mask = np.triu(np.full((s, s), -np.inf, np.float32), k=1) if causal else None
    q, k, v = (jnp.asarray(t).reshape(b, s, h, dh) for t in np.split(qkv, 3, axis=-1))
    want = JA.xla_mha_core(q, k, v, None if mask is None else jnp.asarray(mask))
    got = TFA.attention_reference(torch.from_numpy(qkv), h,
                                  None if mask is None else torch.from_numpy(mask), fast)
    np.testing.assert_allclose(got.numpy(), np.asarray(want).reshape(b, s, h * dh),
                               atol=2e-6, rtol=1e-5)


def test_attention_fast_fully_masked_row_is_zero():
    """Without the max-subtraction a fully masked row sums to 0; the
    denominator floor makes its output 0, not inf/NaN."""
    rng = np.random.RandomState(24)
    qkv = torch.from_numpy(rng.randn(1, 5, 3 * 32).astype(np.float32))
    mask = torch.zeros(5, 5)
    mask[2] = float("-inf")
    out = TFA.attention_reference(qkv, 2, mask, fast=True)
    assert torch.isfinite(out).all()
    assert float(out[0, 2].abs().max()) == 0.0


def test_ln_gemm_and_gemm_bias_residual_pieces_match_jax_math():
    """The two GEMM kernels' plain versions against the JAX block's own
    LayerNorm / dot / QuickGELU composition (fp32)."""
    x, args, plane, pmask = _block_args(5, b=2, s=7)
    xs = np.where(pmask[None] > 0, plane[None], x)
    h = JFA._layer_norm(jnp.asarray(xs), args["ln2_scale"], args["ln2_bias"])
    hid = h @ args["w_fc"] + args["b_fc"]
    want = hid * jax.nn.sigmoid(1.702 * hid)
    got = TFA.ln_gemm_reference(torch.from_numpy(x), torch.from_numpy(args["ln2_scale"]),
                                torch.from_numpy(args["ln2_bias"]),
                                torch.from_numpy(args["w_fc"]),
                                torch.from_numpy(args["b_fc"]), True,
                                torch.from_numpy(plane), torch.from_numpy(pmask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)

    a = np.random.RandomState(6).randn(2, 7, 32).astype(np.float32)
    want = a @ args["w_out"] + args["b_out"] + xs
    got = TFA.gemm_bias_residual_reference(
        torch.from_numpy(a), torch.from_numpy(args["w_out"]), torch.from_numpy(args["b_out"]),
        torch.from_numpy(x), torch.from_numpy(plane), torch.from_numpy(pmask))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_fused_block_bf16_rounds_where_the_kernel_does():
    """bf16: the plain version rounds qkv, probabilities, head output, x1 and
    the hidden activation to bf16 at the Pallas kernel's points, so it tracks
    the fp32 block to bf16 precision."""
    x, args, _, _ = _block_args(8)
    t32 = {k: torch.from_numpy(v) for k, v in args.items()}
    tbf = {k: (v if k.startswith("ln") else v.bfloat16()) for k, v in t32.items()}
    ref = TFA.fused_block_reference(torch.from_numpy(x), **t32, n_heads=4)
    got = TFA.fused_block_reference(torch.from_numpy(x).bfloat16(), **tbf, n_heads=4)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref.numpy(), atol=5e-2, rtol=2e-2)


def test_ln_proj_tail_reference_matches_pallas_and_xla():
    rng = np.random.RandomState(31)
    b, d, e = 5, 32, 16
    x = rng.randn(b, d).astype(np.float32)
    s = (1 + 0.1 * rng.randn(d)).astype(np.float32)
    bb = (0.1 * rng.randn(d)).astype(np.float32)
    proj = (rng.randn(d, e) * 0.1).astype(np.float32)
    xla_y, xla_p = JFT._tail_xla(jnp.asarray(x), jnp.asarray(s), jnp.asarray(bb),
                                 jnp.asarray(proj))
    pal_y, pal_p = JFT._tail_pallas(jnp.asarray(x), jnp.asarray(s), jnp.asarray(bb),
                                    jnp.asarray(proj), block_b=8, interpret=True)
    got_y, got_p = TFT.ln_proj_tail_reference(torch.from_numpy(x), torch.from_numpy(s),
                                              torch.from_numpy(bb), torch.from_numpy(proj))
    for want_y, want_p in ((xla_y, xla_p), (pal_y, pal_p)):
        np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), atol=ATOL, rtol=RTOL)
    # bf16: the plain version rounds like _tail_xla (fp32 affine)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want_y, want_p = JFT._tail_xla(xb, jnp.asarray(s), jnp.asarray(bb), jnp.asarray(proj))
    got_y, got_p = TFT.ln_proj_tail_reference(torch.from_numpy(x).bfloat16(),
                                              torch.from_numpy(s), torch.from_numpy(bb),
                                              torch.from_numpy(proj))
    np.testing.assert_allclose(got_y.float().numpy(), np.asarray(want_y.astype(jnp.float32)),
                               atol=1e-2, rtol=1e-2)
    np.testing.assert_allclose(got_p.float().numpy(), np.asarray(want_p.astype(jnp.float32)),
                               atol=2e-2, rtol=2e-2)


def test_ln_proj_tail_dispatch_follows_kernel_impl():
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randn(3, 16).astype(np.float32))
    ln = {"scale": torch.ones(16), "bias": torch.zeros(16)}
    proj = torch.from_numpy(rng.randn(16, 8).astype(np.float32))
    want = TFT.ln_proj_tail_reference(x, ln["scale"], ln["bias"], proj)
    for impl in ("auto", "kernel", "plain"):
        with TL.kernel_impl(impl):
            got = TFT.ln_proj_tail(x, ln, proj)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_fast_softmax_flag_and_plain_core():
    assert TA.fast_softmax_enabled() is False
    TA.set_fast_softmax(True)
    try:
        assert TA.fast_softmax_enabled() is True
        rng = np.random.RandomState(4)
        q, k, v = (rng.randn(2, 6, 2, 8).astype(np.float32) for _ in range(3))
        JA.set_fast_softmax(True)
        try:
            want = JA.xla_mha_core(*(jnp.asarray(t).astype(jnp.bfloat16) for t in (q, k, v)))
        finally:
            JA.set_fast_softmax(False)
        got = TA.xla_mha_core(*(torch.from_numpy(t).bfloat16() for t in (q, k, v)))
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                                   atol=2e-2, rtol=2e-2)
    finally:
        TA.set_fast_softmax(False)


def test_kernels_are_forward_only():
    x, args, _, _ = _block_args(9)
    t = {k: torch.from_numpy(v) for k, v in args.items()}
    t["w_in"].requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward-only"):
        TFA.fused_block(torch.from_numpy(x), **t, n_heads=4)
    with torch.no_grad():
        TFA.fused_block(torch.from_numpy(x), **t, n_heads=4)
    xr = torch.zeros(2, 8, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        TFT.ln_proj_tail_kernel(xr, torch.ones(8), torch.zeros(8), torch.zeros(8, 4))


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
def test_cuda_block_kernels_match_plain(cuda, dtype, fast):
    rng = np.random.RandomState(0)
    b, s, d, hid, h = 4, 77, 128, 512, 2
    f = lambda *shape, sc=0.05, dt=dtype: torch.from_numpy(  # noqa: E731
        (rng.randn(*shape) * sc).astype(np.float32)).to(cuda, dt)
    args = dict(ln1_scale=1 + f(d, dt=torch.float32), ln1_bias=f(d, dt=torch.float32),
                w_in=f(d, 3 * d), b_in=f(3 * d), w_out=f(d, d), b_out=f(d),
                ln2_scale=1 + f(d, dt=torch.float32), ln2_bias=f(d, dt=torch.float32),
                w_fc=f(d, hid), b_fc=f(hid), w_proj=f(hid, d), b_proj=f(d))
    x = f(b, s, d, sc=1.0)
    mask = TL.causal_mask(s, device=cuda)
    got = TFA.fused_block(x, **args, n_heads=h, mask=mask, fast=fast)
    want = TFA.fused_block_reference(x, **args, n_heads=h, mask=mask, fast=fast)
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert float((got.float() - want.float()).abs().max()) <= tol * float(want.abs().max())


def test_cuda_tail_kernel_matches_plain(cuda):
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(40, 256).astype(np.float32)).to(cuda)
    proj = torch.from_numpy(rng.randn(256, 96).astype(np.float32) * 0.06).to(cuda)
    g, bb = torch.ones(256, device=cuda), torch.zeros(256, device=cuda)
    got = TFT.ln_proj_tail_kernel(x, g, bb, proj)
    want = TFT.ln_proj_tail_reference(x, g, bb, proj)
    torch.cuda.synchronize()
    for a, w in zip(got, want):
        assert float((a - w).abs().max()) <= 1e-4 * float(w.abs().max())
