"""The fp32 block backward on the card: `ops.fused_attention.fused_block_backward`
on CUDA tensors, the recompute and every gradient product on the fp32 GEMM
kernel (3xTF32 on wgmma), at a stage-2 step's shapes (B 64, S 213 with the
two spliced prompt rows, ViT-B/16's 768 wide block), against float64 autograd
of the same block (every gradient within 2e-5 of the largest entry); two
calls bit for bit; and the products alone at ragged shapes.

Every test needs a CUDA device and skips without one. The file imports no
JAX, so that it runs where the port runs:
`python -m pytest --noconftest -p no:cacheprovider tests/test_torch_block_backward_card.py`
(tests/conftest.py imports JAX).
"""

import math

import pytest
import torch
import torch.nn.functional as F

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


def _rel(got, want):
    return float((got.double() - want).abs().max() / want.abs().max())


NEEDS = (True, True) + (False,) * 4 + (True,) * 12


def test_card_block_backward_matches_float64(cuda):
    x, plane, pmask, g, w = _block(cuda)
    assert FA.block_backward_route(x, w) == "kernel"
    counters = (FA.fused_block_backward, FA.gemm_product, FA.gemm_dgrad, FA.gemm_wgrad)
    before = [c.launches for c in counters] + [FA.fused_block_backward.plain]
    dx, dplane, dws = FA.fused_block_backward(g, x, plane, pmask, None, HEADS, w, NEEDS)
    torch.cuda.synchronize()
    # one chain: three recompute products, four dgrads, four wgrads on the
    # kernel; no fallback
    after = [c.launches for c in counters] + [FA.fused_block_backward.plain]
    assert [a - b for a, b in zip(after, before)] == [1, 3, 4, 4, 0]
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
