"""The fp32 block backward on the card: `ops.fused_attention.fused_block_backward`
on CUDA tensors, the recompute and every gradient product on the fp32 GEMM
kernel (3xTF32 on wgmma), the attention core on `mha_core_lse` and
`mha_core_backward`, at a stage-2 step's shapes (B 64, S 213 with the
two spliced prompt rows, ViT-B/16's 768 wide block), against float64 autograd
of the same block (every gradient within 2e-5 of the largest entry); two
calls bit for bit; the products alone at ragged shapes; and the attention
core's gradient alone at the sequences the port trains on.

Every test needs a CUDA device and skips without one. The file imports no
JAX, so that it runs where the port runs:
`python -m pytest --noconftest -p no:cacheprovider tests/test_torch_block_backward_card.py`
(tests/conftest.py imports JAX).
"""

import math

import pytest
import torch
import torch.nn.functional as F

from tpu_reid_torch.models import layers as TL
from tpu_reid_torch.ops import attention as TA
from tpu_reid_torch.ops import fused_attention as FA

B, S, D, HID, HEADS = 64, 213, 768, 3072, 12
NAMES = ["x", "ln1_scale", "ln1_bias", "w_in", "b_in", "w_out", "b_out", "ln2_scale",
         "ln2_bias", "w_fc", "b_fc", "w_proj", "b_proj", "plane"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _block(dev, seed=0):
    gen = torch.Generator(device="cpu").manual_seed(seed)

    def t(*shape, std=1.0, mean=0.0):
        return (mean + std * torch.randn(*shape, generator=gen)).to(dev)

    weights = [t(D, std=0.1, mean=1.0), t(D, std=0.1),
               t(D, 3 * D, std=D ** -0.5), t(3 * D, std=0.02),
               t(D, D, std=D ** -0.5), t(D, std=0.02),
               t(D, std=0.1, mean=1.0), t(D, std=0.1),
               t(D, HID, std=D ** -0.5), t(HID, std=0.02),
               t(HID, D, std=HID ** -0.5), t(D, std=0.02)]
    x, plane, g = t(B, S, D), t(S, D), t(B, S, D)
    pmask = torch.zeros(S, 1, device=dev)
    pmask[S - 2:] = 1.0
    return x, plane, pmask, g, weights


def _block64(x, plane, pmask, w):
    """The block after the splice in float64, written plainly."""
    xin = torch.where(pmask.reshape(1, -1, 1) > 0, plane[None], x)
    b, s, d = xin.shape
    dh = d // HEADS
    h = F.layer_norm(xin, (d,), w[0], w[1], 1e-5)
    q, k, v = (h @ w[2] + w[3]).split(d, dim=-1)
    q, k, v = (t.reshape(b, s, HEADS, dh) for t in (q, k, v))
    p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(dh), dim=-1)
    x1 = xin + torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(b, s, d) @ w[4] + w[5]
    hp = F.layer_norm(x1, (d,), w[6], w[7], 1e-5) @ w[8] + w[9]
    return x1 + (hp * torch.sigmoid(1.702 * hp)) @ w[10] + w[11]


def _core64(q, k, v, mask=None):
    """The exact softmax attention core in float64, written plainly."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    if mask is not None:
        s = s + mask.to(s)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)


def _rel(got, want):
    want = want.detach()
    return float((got.double() - want).abs().max() / want.abs().max())


NEEDS = (True, True) + (False,) * 4 + (True,) * 12


def test_card_block_backward_matches_float64(cuda):
    x, plane, pmask, g, w = _block(cuda)
    assert FA.block_backward_route(x, w, HEADS) == "kernel"
    counters = (FA.fused_block_backward, FA.gemm_product, FA.gemm_dgrad, FA.gemm_wgrad)
    core = (TA.mha_core_backward, TA.mha_core)

    def count():
        return ([c.launches for c in counters] + [FA.fused_block_backward.plain],
                [c.launches for c in core])

    before = count()
    dx, dplane, dws = FA.fused_block_backward(g, x, plane, pmask, None, HEADS, w, NEEDS)
    torch.cuda.synchronize()
    # one chain: three recompute products, four dgrads, four wgrads on the
    # kernel; no fallback; the attention core's gradient on its kernel after
    # one recompute of the core
    after = count()
    assert [a - b for a, b in zip(after[0], before[0])] == [1, 3, 4, 4, 0]
    assert [a - b for a, b in zip(after[1], before[1])] == [1, 1]
    ins = [t.double().requires_grad_() for t in (x, *w, plane)]
    out = _block64(ins[0], ins[13], pmask.double(), ins[1:13])
    want = torch.autograd.grad(out, ins, g.double())
    errors = {name: _rel(a, b) for name, a, b in zip(NAMES, [dx, *dws, dplane], want)}
    assert max(errors.values()) <= 2e-5, errors


def test_card_block_backward_is_deterministic(cuda):
    x, plane, pmask, g, w = _block(cuda, seed=1)
    first = FA.fused_block_backward(g, x, plane, pmask, None, HEADS, w, NEEDS)
    second = FA.fused_block_backward(g, x, plane, pmask, None, HEADS, w, NEEDS)
    a = [first[0], first[1], *first[2]]
    b = [second[0], second[1], *second[2]]
    assert all(torch.equal(u, v) for u, v in zip(a, b))


@pytest.mark.parametrize("m,k,n,gelu", [
    (1000, 2304, 776, False),   # ragged rows; N off the 128-wide tile
    (13632, 768, 3072, True),   # c_proj's dgrad at the cell's rows, QuickGELU' in the epilogue
    (7, 32, 8, True),           # the smallest
])
def test_card_dgrad_matches_float64(cuda, m, k, n, gelu):
    gen = torch.Generator(device="cpu").manual_seed(m + k)
    dy = torch.randn(m, k, generator=gen).to(cuda)
    w = (torch.randn(n, k, generator=gen) * k ** -0.5).to(cuda)
    h = torch.randn(m, n, generator=gen).to(cuda) if gelu else None
    act = torch.empty(m, n, device=cuda) if gelu else None
    got = FA.gemm_dgrad(dy, w, h, act)
    want = FA.gemm_dgrad_reference(dy.double(), w.double(), None if h is None else h.double())
    assert _rel(got, want) <= 1e-5
    if gelu:  # the activation the epilogue writes beside it
        h64 = h.double()
        assert _rel(act, h64 * torch.sigmoid(1.702 * h64)) <= 1e-6


@pytest.mark.parametrize("m,k,n,residual", [
    (13632, 768, 2304, False),  # the recompute's qkv at the cell's rows
    (1000, 3072, 776, True),    # ragged rows, N off the tile, with a residual
])
def test_card_product_matches_float64(cuda, m, k, n, residual):
    gen = torch.Generator(device="cpu").manual_seed(m + n)
    a = torch.randn(m, k, generator=gen).to(cuda)
    w = (torch.randn(k, n, generator=gen) * k ** -0.5).to(cuda)
    b = torch.randn(n, generator=gen).to(cuda)
    res = torch.randn(m, n, generator=gen).to(cuda) if residual else None
    got = FA.gemm_product(a, w, b, res)
    want = a.double() @ w.double() + b.double() + (0 if res is None else res.double())
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("r,m,n", [
    (13633, 772, 776),   # a reduction not a multiple of 32; M and N off the tiles; split
    (13632, 768, 2304),  # in_proj's wgrad at the cell's rows
    (30, 64, 192),       # one stage
    (1, 4, 8),
])
def test_card_wgrad_matches_float64(cuda, r, m, n):
    gen = torch.Generator(device="cpu").manual_seed(r + m)
    x = torch.randn(r, m, generator=gen).to(cuda)
    dy = torch.randn(r, n, generator=gen).to(cuda)
    got = FA.gemm_wgrad(x, dy)
    assert _rel(got, FA.gemm_wgrad_reference(x.double(), dy.double())) <= 1e-5
    assert torch.equal(got, FA.gemm_wgrad(x, dy))


# the attention core's gradient alone: (B, S, heads, causal) of a stage-2 step
# (B 64, S 213), the text tower's causal 77 tokens over 8 heads, the vehicle
# geometry's 444, and a sequence ragged to both tiles (130 = 128 + 2 own rows,
# 4 x 32 + 2 streamed)
ATTENTION_CASES = [(64, 213, 12, False), (64, 77, 8, True), (16, 444, 12, False),
                   (8, 130, 12, False)]
# 3xTF32 products hold ~22 bits, and the tensor cores' accumulator adds with
# truncation over S / 32 key or query tiles: the kernels read 1.2e-6 to
# 6.9e-6 of each gradient's largest entry at these cases (dq at S 444 the
# worst), the plain fp32 version 1.2e-6 to 2.9e-6. 2e-5, the block
# backward's limit, leaves ~3x
ATTENTION_TOL = 2e-5


@pytest.mark.parametrize("b,s,heads,causal", ATTENTION_CASES)
def test_card_attention_backward_matches_float64(cuda, b, s, heads, causal):
    gen = torch.Generator(device="cpu").manual_seed(b + s)
    d = 64 * heads
    qkv = torch.randn(b, s, 3 * d, generator=gen).to(cuda)
    do = torch.randn(b, s, heads, 64, generator=gen).to(cuda)
    mask = TL.causal_mask(s, cuda) if causal else None
    views = FA._qkv_views(qkv, heads)
    before = (TA.mha_core_backward.launches, TA.mha_core.launches)
    o, lse = TA.mha_core_lse(*views, mask)
    got = TA.mha_core_backward(*views, o, do, lse, mask)
    torch.cuda.synchronize()
    assert (TA.mha_core_backward.launches - before[0], TA.mha_core.launches - before[1]) == (1, 1)
    x = qkv.double().requires_grad_()
    q, k, v = FA._qkv_views(x, heads)
    want_o = _core64(q, k, v, mask)
    (want,) = torch.autograd.grad(want_o, x, do.double())
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / 8.0
    want_lse = torch.logsumexp(scores if mask is None else scores + mask.double(), dim=-1)
    errors = {name: _rel(got[..., i * d:(i + 1) * d], want[..., i * d:(i + 1) * d])
              for i, name in enumerate(("dq", "dk", "dv"))}
    errors.update(o=_rel(o, want_o), lse=_rel(lse, want_lse))
    assert max(errors.values()) <= ATTENTION_TOL, errors
    assert torch.equal(got, TA.mha_core_backward(*views, o, do, lse, mask))


def test_card_block_backward_out_of_domain_takes_the_recompute(cuda):
    """A head width other than 64 on the card: the attention kernels refuse
    it, as the forward does, and the block backward takes the plain block's
    recompute, counted in `fused_block_backward.plain`."""
    gen = torch.Generator(device="cpu").manual_seed(5)
    d, hid, heads = 128, 256, 4  # head width 32
    w = [1 + 0.1 * torch.randn(d, generator=gen), 0.1 * torch.randn(d, generator=gen),
         d ** -0.5 * torch.randn(d, 3 * d, generator=gen), 0.02 * torch.randn(3 * d, generator=gen),
         d ** -0.5 * torch.randn(d, d, generator=gen), 0.02 * torch.randn(d, generator=gen),
         1 + 0.1 * torch.randn(d, generator=gen), 0.1 * torch.randn(d, generator=gen),
         d ** -0.5 * torch.randn(d, hid, generator=gen), 0.02 * torch.randn(hid, generator=gen),
         hid ** -0.5 * torch.randn(hid, d, generator=gen), 0.02 * torch.randn(d, generator=gen)]
    w = [t.to(cuda) for t in w]
    x, g = torch.randn(4, 50, d, generator=gen).to(cuda), torch.randn(4, 50, d, generator=gen).to(cuda)
    assert FA.block_backward_route(x, w, heads) == "plain"
    views = FA._qkv_views(torch.zeros(4, 50, 3 * d, device=cuda), heads)
    o, do, lse = views[0], views[0], torch.zeros(4, heads, 50, device=cuda)
    with pytest.raises(ValueError):
        TA.mha_core_backward(*views, o, do, lse)
    before = (TA.mha_core_backward.launches, FA.fused_block_backward.plain)
    needs = (True, False) + (False,) * 4 + (True,) * 12
    dx, _, dws = FA.fused_block_backward(g, x, None, None, None, heads, w, needs)
    torch.cuda.synchronize()
    assert (TA.mha_core_backward.launches, FA.fused_block_backward.plain) == (before[0],
                                                                              before[1] + 1)
    ins = [t.double().requires_grad_() for t in (x, *w)]
    xin, ws = ins[0], ins[1:]
    h = F.layer_norm(xin, (d,), ws[0], ws[1], 1e-5)
    qkv = h @ ws[2] + ws[3]
    a = _core64(*FA._qkv_views(qkv, heads)).reshape(xin.shape)
    x1 = xin + a @ ws[4] + ws[5]
    hp = F.layer_norm(x1, (d,), ws[6], ws[7], 1e-5) @ ws[8] + ws[9]
    out = x1 + (hp * torch.sigmoid(1.702 * hp)) @ ws[10] + ws[11]
    want = torch.autograd.grad(out, ins, g.double())
    errors = [_rel(a_, b_) for a_, b_ in zip([dx, *dws], want)]
    assert max(errors) <= 2e-5, errors
