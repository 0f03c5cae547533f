"""The bf16 LayerNorm products on the card (`ln_gemm` and
`gemm_bias_residual` with LayerNorm parameters: `ln_rows`' kernel into
scratch, then the GEMM without LayerNorm, in one call), held against their
plain versions at the shapes that run them:

  * the IVLP ViT-B/16 serving cells: qkv with the deep-prompt splice and
    c_fc with QuickGELU at 213 tokens, batch 512 (`market.embed`, each of
    its two passes) and at 444 tokens, batch 256 (`veri.embed`);
  * EVA02-L's attention output: its sub-LN (epsilon 1e-6) with the residual,
    K = N = 1024, 327 tokens, batch 256 (`eva-veri.embed`);
  * the text tower's qkv (K 512, N 1536, 77 tokens a class, 751 classes);
  * one row, one query (213 rows) and its flip (426), and a ragged M;
  * rows whose mean is large against their spread (mean 30, std 0.5).

Each output is within one bf16 rounding of the plain version (`_one_rounding`,
the tolerance of tests/test_torch_eva02_card.py: the kernel and the plain
version round the same fp32 value, summed in another order, to bf16) and
counts as one launch of its wrapper and none of `ln_rows`' wrapper. The
normalised rows are what `ln_rows` writes, so the output equals `ln_rows`
followed by the product without LayerNorm, bit for bit.

Every test needs a CUDA device and skips without one. The file imports no
JAX: `python -m pytest --noconftest -p no:cacheprovider tests/test_torch_ln_gemm_card.py`.
"""

import pytest
import torch

from tpu_reid_torch.ops import fused_attention as FA


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _draw(seed, dev):
    gen = torch.Generator(device="cpu").manual_seed(seed)

    def t(*shape, std=1.0, mean=0.0, dtype=torch.bfloat16):
        return (mean + std * torch.randn(*shape, generator=gen)).to(dtype).to(dev)

    return t


def _one_rounding(got, want):
    g, w = got.float(), want.float()
    err = (g - w).abs()
    bound = 2.0 ** -7 * w.abs() + 2.0 ** -9 * w.abs().max()
    assert bool((err <= bound).all()), (
        f"largest gap {float(err.max())}, at a bound of {float(bound.flatten()[err.argmax()])}")


# (id, B, S, K, N, mode, eps, mean, std): mode qkv (the splice), gelu, bias,
# residual (the sub-LN with the residual, through gemm_bias_residual)
CASES = [
    ("market_qkv", 512, 213, 768, 2304, "qkv", 1e-5, 0.0, 1.0),
    ("market_c_fc", 512, 213, 768, 3072, "gelu", 1e-5, 0.0, 1.0),
    ("veri_qkv", 256, 444, 768, 2304, "qkv", 1e-5, 0.0, 1.0),
    ("veri_c_fc", 256, 444, 768, 3072, "gelu", 1e-5, 0.0, 1.0),
    ("eva_out_projection", 256, 327, 1024, 1024, "residual", 1e-6, 0.0, 1.0),
    ("text_qkv", 751, 77, 512, 1536, "bias", 1e-5, 0.0, 1.0),
    ("one_row", 1, 1, 768, 2304, "qkv", 1e-5, 0.0, 1.0),
    ("one_query", 1, 213, 768, 2304, "qkv", 1e-5, 0.0, 1.0),
    ("one_query_flipped", 2, 213, 768, 3072, "gelu", 1e-5, 0.0, 1.0),
    ("ragged_m", 3, 211, 768, 2304, "qkv", 1e-5, 0.0, 1.0),
    ("large_mean", 64, 213, 768, 2304, "qkv", 1e-5, 30.0, 0.5),
]


def _operands(t, b, s, k, n, mode, mean, std, dev):
    x = t(b, s, k, mean=mean, std=std)
    g, gb = t(k, std=0.1, mean=1.0, dtype=torch.float32), t(k, std=0.1, dtype=torch.float32)
    w, bias = t(k, n, std=k ** -0.5), t(n, std=0.02)
    plane = pmask = None
    if mode in ("qkv", "residual"):
        plane = t(s, k if mode == "qkv" else n, mean=mean, std=std)
        pmask = torch.zeros(s, device=dev)
        pmask[s - 2:] = 1.0
    return x, g, gb, w, bias, plane, pmask


@pytest.mark.parametrize("name,b,s,k,n,mode,eps,mean,std", CASES, ids=[c[0] for c in CASES])
def test_ln_prologue_against_its_plain_version(cuda, name, b, s, k, n, mode, eps, mean, std):
    t = _draw(3, cuda)
    x, g, gb, w, bias, plane, pmask = _operands(t, b, s, k, n, mode, mean, std, cuda)
    wrapper = FA.gemm_bias_residual if mode == "residual" else FA.ln_gemm
    launches, ln_rows = wrapper.launches, FA.ln_rows.launches
    with torch.no_grad():
        if mode == "residual":
            res = t(b, s, n)
            got = FA.gemm_bias_residual(x, w, bias, res, plane, pmask, ln_scale=g, ln_bias=gb,
                                        eps=eps)
            want = FA.gemm_bias_residual_reference(x, w, bias, res, plane, pmask, ln_scale=g,
                                                   ln_bias=gb, eps=eps)
        else:
            gelu = mode == "gelu"
            got = FA.ln_gemm(x, g, gb, w, bias, gelu, plane, pmask, eps=eps)
            want = FA.ln_gemm_reference(x, g, gb, w, bias, gelu, plane, pmask, eps=eps)
    torch.cuda.synchronize()
    assert got.shape == want.shape and torch.isfinite(got).all()
    _one_rounding(got, want)
    assert wrapper.launches == launches + 1 and FA.ln_rows.launches == ln_rows


@pytest.mark.parametrize("b,s,n,gelu", [(128, 211, 2304, False), (2, 213, 3072, True)],
                         ids=["row_panels", "one_query_flipped"])
def test_ln_prologue_equals_ln_rows_then_the_plain_mode(cuda, b, s, n, gelu):
    # the normalised rows are ln_rows's, spliced rows included, and the
    # product is the one without LayerNorm
    t = _draw(5, cuda)
    x, g, gb, w, bias, plane, pmask = _operands(t, b, s, 768, n, "qkv", 0.0, 1.0, cuda)
    with torch.no_grad():
        fused = FA.ln_gemm(x, g, gb, w, bias, gelu, plane, pmask)
        h = FA.ln_rows(x, g, gb, 768, 1e-5, plane, pmask)
        apart = FA.ln_gemm(h, None, None, w, bias, gelu)
    assert torch.equal(fused, apart)


def test_ln_prologue_repeats_bit_for_bit(cuda):
    # 20 calls on one input: a product that read its scratch before ln_rows
    # had written it shows as a difference
    t = _draw(9, cuda)
    x, g, gb, w, bias, plane, pmask = _operands(t, 128, 213, 768, 2304, "qkv", 0.0, 1.0, cuda)
    with torch.no_grad():
        first = FA.ln_gemm(x, g, gb, w, bias, False, plane, pmask)
        assert all(torch.equal(first, FA.ln_gemm(x, g, gb, w, bias, False, plane, pmask))
                   for _ in range(20))
