"""The EVA02 block's kernel modes on the card, at EVA02-CLIP-L/14's published
widths (D 1024, 16 heads of 64, SwiGLU hidden 2730 stored as 2752) and the
vehicle geometry's sequence (S 327 = CLS + 18 x 18 patches + 2 prompt
tokens), B 64:

  * each new mode of the block kernels against its plain version (the
    wrapper's `_reference`, which repeats the kernel's rounding points):
    `ln_rows` as LN_1 with the deep-prompt splice, the qkv product with
    RoPE, the gate | up product with SwiGLU, the attention output's sub-LN
    with the residual, the sub-LN over the padded hidden width, the whole
    eight-launch block, and the CLS tail with EVA's epsilon and head bias;
  * the existing modes (LayerNorm epsilon 1e-5, no head bias) bit-equal to
    the parent commit's outputs on the same inputs, held as SHA-256 digests
    of the outputs that the parent's build gave on an H100 (inputs drawn on
    the CPU from fixed seeds, so every run sees the same bits);
  * a bf16 EVA02 `eval_embed` pass: 23 blocks on the kernels (the 24th is
    the CLS-only block), none on the plain path.

Tolerances, each with its reason:
  * a single product (`_one_rounding`): the kernel and the plain version
    round the same fp32 value, computed in another order (~1e-6 relative),
    to bf16, so they may land one bf16 step apart: |got - want| <= 2^-7
    |want| (one step of an 8-bit significand), plus 2^-9 of the output's
    largest entry where cancellation leaves values near zero;
  * the whole block: the eight launches chain eight such roundings through
    LayerNorms, which rescale the differences: the relative L2 gap of the
    output within 4e-3 (the measured gap, in PERF.md, is far below);
  * the eval_embed pass against the plain bf16 tower: the plain tower
    rounds elsewhere (its products return bf16 before the bias, its
    attention core is xla_mha_core's), 24 blocks deep: each embedding row
    within 3e-2 relative L2, the bf16 tolerance the JAX parity tests use.

Every test needs a CUDA device and skips without one. The file imports no
JAX: `python -m pytest --noconftest -p no:cacheprovider tests/test_torch_eva02_card.py`.
"""

import hashlib

import pytest
import torch

from tpu_reid_torch.ops import fused_attention as FA
from tpu_reid_torch.ops import fused_tail as FT

B, S, D, HEADS, F = 64, 327, 1024, 16, 2730
F_PAD = -(-F // 64) * 64  # fused_eva.padded_hidden
EPS = 1e-6


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


def _design():
    from tpu_reid_torch.configs import PromptDesign

    return PromptDesign(trainer="IVLP", vision_depth=24, vision_ctx=2, language_depth=24,
                        language_ctx=2)


def _rope(dev):
    from tpu_reid_torch.configs import eva02_l14_reid
    from tpu_reid_torch.models.vit import rope_table

    return rope_table(eva02_l14_reid(design=_design()).vision, dev)


def test_ln_1_with_the_splice_then_qkv_with_rope(cuda):
    t = _draw(1, cuda)
    x, g, b = t(B, S, D), t(D, std=0.1, mean=1.0, dtype=torch.float32), t(D, std=0.1,
                                                                          dtype=torch.float32)
    w, bias = t(D, 3 * D, std=D ** -0.5), t(3 * D, std=0.02)
    plane, pmask = t(S, D), torch.zeros(S, 1, device=cuda)
    pmask[S - 2:] = 1.0
    rope = _rope(cuda)
    kw = dict(rope=rope, rope_cols=2 * D)
    with torch.no_grad():
        h = FA.ln_rows(x, g, b, D, EPS, plane, pmask)
        _one_rounding(h, FA.ln_rows_reference(x, g, b, D, EPS, plane, pmask))
        got = FA.ln_gemm(h, None, None, w, bias, **kw)
        want = FA.ln_gemm_reference(h, None, None, w, bias, **kw)
        unrotated = FA.ln_gemm(h, None, None, w, bias)
    _one_rounding(got, want)
    # CLS and the prompt rows, and v, leave the rotation as they came
    keep = torch.zeros(S, dtype=torch.bool, device=cuda)
    keep[0] = keep[S - 2:] = True
    assert torch.equal(got[:, keep], unrotated[:, keep])
    assert torch.equal(got[..., 2 * D:], unrotated[..., 2 * D:])


def test_gate_up_with_swiglu(cuda):
    t = _draw(2, cuda)
    x, g, b = t(B, S, D), t(D, std=0.1, mean=1.0, dtype=torch.float32), t(D, std=0.1,
                                                                          dtype=torch.float32)
    from tpu_reid_torch.weights.convert import pack_swiglu

    w = pack_swiglu(t(D, F, std=D ** -0.5), t(D, F, std=D ** -0.5), F_PAD)
    bias = pack_swiglu(t(F, std=0.02), t(F, std=0.02), F_PAD)
    with torch.no_grad():
        h = FA.ln_rows(x, g, b, D, EPS)
        got = FA.ln_gemm(h, None, None, w, bias, swiglu=True)
        want = FA.ln_gemm_reference(h, None, None, w, bias, swiglu=True)
    assert got.shape == (B, S, F_PAD)
    _one_rounding(got, want)
    assert not got[..., F:].any()  # zero weights and biases past F: zero columns


def test_out_projection_with_sub_ln_and_residual(cuda):
    t = _draw(3, cuda)
    a, res = t(B, S, D), t(B, S, D)
    g, b = t(D, std=0.1, mean=1.0, dtype=torch.float32), t(D, std=0.1, dtype=torch.float32)
    w, bias = t(D, D, std=D ** -0.5), t(D, std=0.02)
    plane, pmask = t(S, D), torch.zeros(S, 1, device=cuda)
    pmask[S - 2:] = 1.0
    kw = dict(ln_scale=g, ln_bias=b, eps=EPS)
    with torch.no_grad():
        got = FA.gemm_bias_residual(a, w, bias, res, plane, pmask, **kw)
        want = FA.gemm_bias_residual_reference(a, w, bias, res, plane, pmask, **kw)
    _one_rounding(got, want)


def test_sub_ln_over_the_padded_hidden_width(cuda):
    t = _draw(4, cuda)
    u = torch.nn.functional.pad(t(B, S, F, std=0.5, mean=0.1), (0, F_PAD - F))
    pad = torch.zeros(F_PAD - F, device=cuda)
    g = torch.cat([t(F, std=0.1, mean=1.0, dtype=torch.float32), pad])
    b = torch.cat([t(F, std=0.1, dtype=torch.float32), pad])
    with torch.no_grad():
        got = FA.ln_rows(u, g, b, F, EPS)
        want = FA.ln_rows_reference(u, g, b, F, EPS)
        # the statistics of the real columns alone: the padding's zeros
        # taken in would shift the mean and shrink the variance
        wrong = FA.ln_rows_reference(u, g, b, F_PAD, EPS)
    _one_rounding(got, want)
    assert not got[..., F:].any()
    assert float((wrong.float() - want.float()).abs().max()) > 1e-2


def _eva_weights(t):
    from tpu_reid_torch.weights.convert import pack_swiglu

    pad = lambda v: torch.nn.functional.pad(v, (0, F_PAD - F))  # noqa: E731
    f32 = torch.float32
    b_qkv = t(3 * D, std=0.02)
    b_qkv[D:2 * D] = 0
    return [t(D, std=0.1, mean=1.0, dtype=f32), t(D, std=0.1, dtype=f32),
            t(D, 3 * D, std=D ** -0.5), b_qkv,
            t(D, std=0.1, mean=1.0, dtype=f32), t(D, std=0.1, dtype=f32),
            t(D, D, std=D ** -0.5), t(D, std=0.02),
            t(D, std=0.1, mean=1.0, dtype=f32), t(D, std=0.1, dtype=f32),
            pack_swiglu(t(D, F, std=D ** -0.5), t(D, F, std=D ** -0.5), F_PAD),
            pack_swiglu(t(F, std=0.02), t(F, std=0.02), F_PAD),
            pad(t(F, std=0.1, mean=1.0, dtype=f32)), pad(t(F, std=0.1, dtype=f32)),
            torch.nn.functional.pad(t(F, D, std=F ** -0.5), (0, 0, 0, F_PAD - F)),
            t(D, std=0.02)]


def test_whole_block(cuda):
    from tpu_reid_torch.ops import fused_eva as FE

    t = _draw(5, cuda)
    x = t(B, S, D)
    plane, pmask = t(S, D), torch.zeros(S, 1, device=cuda)
    pmask[S - 2:] = 1.0
    w = _eva_weights(t)
    rope = _rope(cuda)
    assert FE.eva_block_route(x, w, HEADS, F) == "kernel"
    with torch.no_grad():
        n0 = FE.fused_eva_block.launches
        got = FE.fused_eva_block(x, w, HEADS, rope, F, EPS, plane, pmask, fast=True)
        assert FE.fused_eva_block.launches == n0 + 1
        want = FE.eva_block_reference(x, w, HEADS, rope, F, EPS, plane, pmask, fast=True)
    gap = float((got.float() - want.float()).norm() / want.float().norm())
    assert gap < 4e-3, gap


def test_tail_with_eps_and_head_bias(cuda):
    t = _draw(6, cuda)
    for dtype in (torch.bfloat16, torch.float32):
        x = t(B, D, dtype=dtype)
        g, b = t(D, std=0.1, mean=1.0, dtype=torch.float32), t(D, std=0.1, dtype=torch.float32)
        proj, hb = t(D, 768, std=D ** -0.5, dtype=dtype), t(768, std=0.1, dtype=dtype)
        with torch.no_grad():
            y, p = FT.ln_proj_tail_kernel(x, g, b, proj, hb, EPS)
            yr, pr = FT.ln_proj_tail_reference(x, g, b, proj, hb, EPS)
        if dtype == torch.bfloat16:
            _one_rounding(y, yr)
            _one_rounding(p, pr)
        else:
            assert float((p - pr).abs().max()) < 1e-4 * float(pr.abs().max())
            assert float((y - yr).abs().max()) < 1e-5 * float(yr.abs().max())


def _digest(*tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def existing_mode_outputs(dev):
    """The outputs of every existing mode of the block GEMM and the CLS tail
    (epsilon 1e-5, no head bias) on fixed inputs, as {name: digest}."""
    out = {}
    t = _draw(7, dev)
    with torch.no_grad():
        for k, s in ((768, 213), (1024, 444)):
            x = t(32, s, k)
            g, b = t(k, std=0.1, mean=1.0, dtype=torch.float32), t(k, std=0.1,
                                                                   dtype=torch.float32)
            w, bias = t(k, 3 * k, std=k ** -0.5), t(3 * k, std=0.02)
            plane, pmask = t(s, k), torch.zeros(s, 1, device=dev)
            pmask[s - 2:] = 1.0
            out[f"ln_gemm.bf16.k{k}"] = _digest(FA.ln_gemm(x, g, b, w, bias, False, plane, pmask))
            out[f"ln_gemm.gelu.bf16.k{k}"] = _digest(FA.ln_gemm(x, g, b, w, bias, True))
            out[f"ln_gemm.noln.bf16.k{k}"] = _digest(FA.ln_gemm(x, None, None, w, bias))
            a, wo = t(32, s, k), t(k, k, std=k ** -0.5)
            out[f"gemm_bias_residual.bf16.k{k}"] = _digest(
                FA.gemm_bias_residual(a, wo, bias[:k], x, plane, pmask))
            out[f"gemm_bias.bf16.k{k}"] = _digest(FA.gemm_bias_residual(a, wo, bias[:k]))
            x32, w32 = x.float(), w.float()
            out[f"ln_gemm.fp32.k{k}"] = _digest(FA.ln_gemm(x32, g, b, w32, bias.float(), False,
                                                           plane.float(), pmask))
            for dtype in (torch.bfloat16, torch.float32):
                rows = x[:, 0].to(dtype)
                proj = w[:, :512].to(dtype)
                out[f"tail.{dtype}.k{k}"] = _digest(*FT.ln_proj_tail_kernel(rows, g, b, proj))
                out[f"tail_fma.{dtype}.k{k}"] = _digest(*FT.ln_proj_tail_fma(rows, g, b, proj))
    return out


# existing_mode_outputs on the parent commit's kernels (NVIDIA H100 80GB
# HBM3, torch 2.11 + CUDA 12.8)
PARENT_DIGESTS = {
    "gemm_bias.bf16.k1024": "45142fb878bf51fa",
    "gemm_bias.bf16.k768": "8d4c5d938207aa84",
    "gemm_bias_residual.bf16.k1024": "96114a94d85bab50",
    "gemm_bias_residual.bf16.k768": "fdd83d5e8a56092b",
    "ln_gemm.bf16.k1024": "4b07688f2523e68d",
    "ln_gemm.bf16.k768": "9139be0e700b9e55",
    "ln_gemm.fp32.k1024": "628541649320b502",
    "ln_gemm.fp32.k768": "d8213f265f1cdd72",
    "ln_gemm.gelu.bf16.k1024": "e0d2ae13f6dd97c3",
    "ln_gemm.gelu.bf16.k768": "68fef2266d9fb4ae",
    "ln_gemm.noln.bf16.k1024": "c0fee3de5c1cb4f7",
    "ln_gemm.noln.bf16.k768": "0568de5945ad4649",
    "tail.torch.bfloat16.k1024": "7f470e1f3bdf3038",
    "tail.torch.bfloat16.k768": "be06049f521e8e57",
    "tail.torch.float32.k1024": "21596ad792cffa35",
    "tail.torch.float32.k768": "156bbafe39800eea",
    "tail_fma.torch.bfloat16.k1024": "a55e3d898af4b403",
    "tail_fma.torch.bfloat16.k768": "d88f782e9b62a896",
    "tail_fma.torch.float32.k1024": "88f53dfc49b3640c",
    "tail_fma.torch.float32.k768": "fc62375e7984b58b",
}


def test_existing_modes_bit_equal_to_the_parent(cuda):
    got = existing_mode_outputs(cuda)
    assert PARENT_DIGESTS, "no parent digests recorded"
    assert got == PARENT_DIGESTS


def test_eval_embed_runs_every_full_block_on_the_kernels(cuda):
    from tpu_reid_torch.configs import eva02_l14_reid
    from tpu_reid_torch.models import layers as L
    from tpu_reid_torch.models import prompts as P
    from tpu_reid_torch.models import reid_clip as M
    from tpu_reid_torch.ops import fused_eva as FE
    from tpu_reid_torch.weights.convert import eva02_visual_params

    clip = eva02_l14_reid((256, 256), _design())
    v = clip.vision
    mcfg = M.ReidModelConfig(mode="ivlp", clip=clip,
                             prompt=P.PromptLearnerConfig(576, n_prefix=5, n_cls_ctx=4))
    t = _draw(8, cuda)
    n, d, f = v.layers, v.width, v.hidden
    f32 = torch.float32

    def ln(*lead):
        return {"scale": t(*lead, std=0.05, mean=1.0, dtype=f32), "bias": t(*lead, std=0.05,
                                                                           dtype=f32)}

    nat = {"conv": {"w": t(14, 14, 3, d, std=(3 * 196) ** -0.5), "b": t(d, std=0.02)},
           "class_embedding": t(d, std=d ** -0.5),
           "positional_embedding": t(1 + v.h_grid * v.w_grid, d, std=0.01),
           "blocks": {"ln_1": ln(n, d), "ln_2": ln(n, d),
                      "attn": {"qkv": {"w": t(n, d, 3 * d, std=d ** -0.5)},
                               "q_bias": t(n, d, std=0.01), "v_bias": t(n, d, std=0.01),
                               "inner_ln": ln(n, d),
                               "proj": {"w": t(n, d, d, std=d ** -0.5 / 2),
                                        "b": t(n, d, std=0.01)}},
                      "mlp": {"w1": {"w": t(n, d, f, std=d ** -0.5), "b": t(n, f, std=0.01)},
                              "w2": {"w": t(n, d, f, std=d ** -0.5), "b": t(n, f, std=0.01)},
                              "ffn_ln": ln(n, f),
                              "w3": {"w": t(n, f, d, std=f ** -0.5 / 4),
                                     "b": t(n, d, std=0.01)}}},
           "ln_post": ln(d), "head": {"w": t(d, 768, std=d ** -0.5), "b": t(768, std=0.01)},
           "vpt_shallow": t(2, d, std=0.02), "vpt_deep": t(n, 2, d, std=0.02)}
    params = {"clip": {"visual": eva02_visual_params(nat)}}
    images = t(8, 256, 256, 3)
    with torch.no_grad():
        k0, p0 = FE.fused_eva_block.launches, FE.fused_eva_block.plain
        got = M.eval_embed(params, mcfg, images)
        assert (FE.fused_eva_block.launches - k0, FE.fused_eva_block.plain - p0) == (23, 0)
        with L.kernel_impl("plain"):
            want = M.eval_embed(params, mcfg, images)
    assert got.shape == (8, 1024 + 768)
    gap = (got.float() - want.float()).norm(dim=1) / want.float().norm(dim=1)
    assert float(gap.max()) < 3e-2, gap
