"""EVA02-CLIP-E/14's kernel modes on the card, at its published widths (D
1792, 16 heads of 112, an exact-GELU MLP of 15360) and the Market geometry's
sequence (S 165 = CLS + 18 x 9 patches + 2 prompt tokens), B 64:

  * each new mode of the block kernels against its plain version (the
    wrapper's `_reference`, which repeats the kernel's rounding points):
    `mha_core` on heads of 112 (the qkv buffer's strided views, exact and
    fast softmax; other lengths, one and two buffers, a staged mask; past
    256 tokens the key-tile kernel, with a mask read tile by tile), the
    fc1 product with the exact GELU, the fc2 product (K = 15360), the
    post-norm residual pass `ln_residual` with the splice on store, and the
    whole seven-launch block (at S 165 and, on key tiles, 259); the CLS
    tail at D 1792 on its wgmma kernel; fp32, which has no kernel route,
    raising on the card;
  * the new instances' outputs as SHA-256 digests of this build's (NEW_DIGESTS),
    and the dh-64 attention kernels', `ln_rows`' and the tail's (D 768 and
    1024) outputs bit-equal to the parent commit's (PARENT_DIGESTS: inputs drawn on the CPU from fixed
    seeds, so every run sees the same bits; regenerate both if torch's CPU
    generator changes);
  * a bf16 EVA02-E `eval_embed` pass at full depth: 63 blocks on the kernels
    (the 64th is the CLS-only block), none on the plain path, each a
    112-wide attention launch, the tail on its kernel once.

Tolerances, each with its reason:
  * a single product or pass (`_one_rounding`): the kernel and the plain
    version round the same fp32 value, computed in another order, to bf16,
    so they may land one bf16 step apart: |got - want| <= 2^-7 |want|, plus
    2^-9 of the output's largest entry where cancellation leaves values near
    zero;
  * the whole block: seven launches chain such roundings through two
    LayerNorms: the relative L2 gap of the output within 4e-3;
  * the eval_embed pass against the plain bf16 tower (its products return
    bf16 before the bias, its attention core is xla_mha_core's), 64 blocks
    deep: each embedding row within 3e-2 relative L2, the bf16 tolerance of
    the JAX parity tests.

Every test needs a CUDA device and skips without one. The file imports no
JAX: `python -m pytest --noconftest -p no:cacheprovider tests/test_torch_eva_e_card.py`.
"""

import hashlib

import pytest
import torch

from tpu_reid_torch.ops import attention as A
from tpu_reid_torch.ops import fused_attention as FA

B, S, D, HEADS, DH, F = 64, 165, 1792, 16, 112, 15360
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


def _splice(t, s, dev):
    plane, pmask = t(s, D), torch.zeros(s, 1, device=dev)
    pmask[s - 2:] = 1.0
    return plane, pmask


@pytest.mark.parametrize("fast", [False, True])
def test_qkv_then_attention_on_heads_of_112(cuda, fast):
    t = _draw(1, cuda)
    x, w, b = t(B, S, D), t(D, 3 * D, std=D ** -0.5), t(3 * D, std=0.02)
    with torch.no_grad():
        qkv = FA.ln_gemm(x, None, None, w, b)
        _one_rounding(qkv, FA.ln_gemm_reference(x, None, None, w, b))
        n0 = A.mha_core_wide.launches
        got = FA._attention_kernel(qkv, HEADS, None, fast)
        assert A.mha_core_wide.launches == n0 + 1
        want = FA.attention_reference(qkv, HEADS, None, fast)
    _one_rounding(got, want)


@pytest.mark.parametrize("b,s,h,masked", [
    (3, 1, 4, False), (3, 64, 4, False),   # one piece of keys
    (2, 77, 3, True),                      # two buffers and a staged causal mask
    (3, 128, 4, False),                    # the longest with two buffers
    (3, 129, 4, False), (2, 256, 4, True),  # one buffer; the longest whole row
    (2, 257, 4, False),                    # key tiles: EVA-CLIP's 224 x 224, a 1-key last tile
    (2, 444, 3, True), (1, 640, 2, False),  # a mask read tile by tile; more tiles than stages
])
def test_attention_112_at_other_lengths(cuda, b, s, h, masked):
    t = _draw(2, cuda)
    q, k, v = (t(b, s, h, DH) for _ in range(3))
    mask = torch.full((s, s), float("-inf"), device=cuda).triu(1) if masked else None
    with torch.no_grad():
        for fast in (False, True):
            _one_rounding(A.mha_core(q, k, v, mask, fast=fast),
                          A.mha_core_reference(q, k, v, mask, fast=fast))


def test_attention_112_refuses_what_it_has_no_kernel_for(cuda):
    t = _draw(3, cuda)
    for s in (64, 257):  # fp32: the 3xTF32 kernels take heads of 64
        q = t(2, s, 2, DH, dtype=torch.float32)
        with pytest.raises(ValueError):
            A.mha_core(q, q, q)
    q = t(2, 64, 2, 96)  # a width of no kernel
    with pytest.raises(ValueError):
        A.mha_core(q, q, q)


def test_fc1_with_the_exact_gelu(cuda):
    t = _draw(4, cuda)
    x, w, b = t(B, S, D), t(D, F, std=D ** -0.5), t(F, std=0.02)
    with torch.no_grad():
        got = FA.ln_gemm(x, None, None, w, b, gelu_erf=True)
        want = FA.ln_gemm_reference(x, None, None, w, b, gelu_erf=True)
        quick = FA.ln_gemm_reference(x, None, None, w, b, gelu=True)
    _one_rounding(got, want)
    # QuickGELU's curve in place of the erf form: outside one rounding
    with pytest.raises(AssertionError):
        _one_rounding(quick, want)


def test_fc2_over_k_15360(cuda):
    t = _draw(5, cuda)
    h, w, b = t(B, S, F, std=0.5), t(F, D, std=F ** -0.5), t(D, std=0.02)
    with torch.no_grad():
        got = FA.ln_gemm(h, None, None, w, b)
        want = FA.ln_gemm_reference(h, None, None, w, b)
    _one_rounding(got, want)


def test_post_norm_residual_pass(cuda):
    t = _draw(6, cuda)
    y, res = t(B, S, D, std=3.0, mean=0.5), t(B, S, D, std=1.5)
    g, b = t(D, std=0.01, mean=0.1, dtype=torch.float32), t(D, std=0.02, dtype=torch.float32)
    plane, pmask = _splice(t, S, cuda)
    with torch.no_grad():
        n0 = FA.ln_residual.launches
        got = FA.ln_residual(y, res, g, b, EPS)
        spliced = FA.ln_residual(y, res, g, b, EPS, plane, pmask)
        assert FA.ln_residual.launches == n0 + 2
    _one_rounding(got, FA.ln_residual_reference(y, res, g, b, EPS))
    assert torch.equal(spliced[:, S - 2:], plane[S - 2:].expand(B, 2, D))
    assert torch.equal(spliced[:, :S - 2], got[:, :S - 2])


@pytest.mark.parametrize("b", [1, 64, 512])
def test_tail_at_1792(cuda, b):
    from tpu_reid_torch.ops import fused_tail as FT

    t = _draw(11, cuda)
    x, proj, hb = t(b, D, std=2.0, mean=0.3), t(D, 1024, std=D ** -0.5), t(1024, std=0.02,
                                                                         dtype=torch.float32)
    g, gb = t(D, std=0.1, mean=1.0, dtype=torch.float32), t(D, std=0.1, dtype=torch.float32)
    assert FT.tail_kernel_route(b, D, 1024, True, {}) == "wgmma"
    with torch.no_grad():
        n0 = FT.ln_proj_tail_kernel.launches
        y, p = FT.ln_proj_tail_kernel(x, g, gb, proj, hb, EPS)
        assert FT.ln_proj_tail_kernel.launches == n0 + 1
        yr, pr = FT.ln_proj_tail_reference(x, g, gb, proj, hb, EPS)
    _one_rounding(y, yr)
    _one_rounding(p, pr)


def _block_weights(t):
    f32 = torch.float32
    b_qkv = t(3 * D, std=0.02)
    b_qkv[D:2 * D] = 0
    return [t(D, 3 * D, std=D ** -0.5), b_qkv, t(D, D, std=D ** -0.5), t(D, std=0.02),
            t(D, std=0.01, mean=0.1, dtype=f32), t(D, std=0.02, dtype=f32),
            t(D, F, std=D ** -0.5), t(F, std=0.02), t(F, D, std=F ** -0.5), t(D, std=0.02),
            t(D, std=0.01, mean=0.1, dtype=f32), t(D, std=0.02, dtype=f32)]


@pytest.mark.parametrize("b,s", [(B, S), (16, 259)])  # whole rows; key tiles (224 x 224)
def test_whole_block(cuda, b, s):
    from tpu_reid_torch.ops import fused_eva_e as FEE

    t = _draw(7, cuda)
    x = t(b, s, D)
    plane, pmask = _splice(t, s, cuda)
    w = _block_weights(t)
    assert FEE.eva_e_block_route(x, w, HEADS) == "kernel"
    with torch.no_grad():
        n0 = FEE.fused_eva_e_block.launches
        got = FEE.fused_eva_e_block(x, w, HEADS, EPS, plane, pmask, fast=True)
        assert FEE.fused_eva_e_block.launches == n0 + 1
        want = FEE.eva_e_block_reference(x, w, HEADS, EPS, plane, pmask, fast=True)
    gap = float((got.float() - want.float()).norm() / want.float().norm())
    assert gap < 4e-3, gap


def test_block_without_a_kernel_route_raises_on_the_card(cuda):
    """fp32 has no kernel of the post-norm block's modes: on the card the
    route raises rather than run the plain block quietly; kernel_impl("plain")
    runs it."""
    from tpu_reid_torch.models import layers as L
    from tpu_reid_torch.ops import fused_eva_e as FEE
    from tpu_reid_torch.ops._build import kernel_impl

    t = _draw(12, cuda)
    x = t(2, 17, D, dtype=torch.float32)
    w = [z.float() for z in _block_weights(t)]
    assert FEE.eva_e_block_route(x, w, HEADS) == "plain"
    p0 = FEE.fused_eva_e_block.plain
    with torch.no_grad(), pytest.raises(ValueError):
        FEE.eva_e_block_autograd(x, w, HEADS, EPS)
    assert FEE.fused_eva_e_block.plain == p0
    with torch.no_grad(), kernel_impl("plain"):
        assert L.eva_e_block(FEE.eva_e_block_params(w), x, HEADS).shape == x.shape


def _digest(*tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def new_mode_outputs(dev):
    """The new instances' outputs on fixed inputs, as {name: digest}."""
    out = {}
    t = _draw(8, dev)
    with torch.no_grad():
        x, w, b = t(8, S, D), t(D, F, std=D ** -0.5), t(F, std=0.02)
        out["ln_gemm.gelu_erf.bf16"] = _digest(FA.ln_gemm(x, None, None, w, b, gelu_erf=True))
        y, res = t(8, S, D, std=3.0), t(8, S, D)
        g, gb = t(D, std=0.1, mean=1.0, dtype=torch.float32), t(D, std=0.1, dtype=torch.float32)
        plane, pmask = _splice(t, S, dev)
        out["ln_residual.bf16"] = _digest(FA.ln_residual(y, res, g, gb, EPS, plane, pmask))
        for s in (77, 165, 256):
            q, k, v = (t(4, s, HEADS, DH) for _ in range(3))
            for fast in (False, True):
                out[f"mha_core.dh112.s{s}.fast{int(fast)}"] = _digest(
                    A.mha_core(q, k, v, fast=fast))
        out["ln_proj_tail.d1792"] = _digest(*_tail_outputs(t, 256, D, 1024))
        for s in (259, 444):  # the key-tile kernel
            q, k, v = (t(2, s, HEADS, DH) for _ in range(3))
            for fast in (False, True):
                out[f"mha_core.dh112.s{s}.fast{int(fast)}"] = _digest(
                    A.mha_core(q, k, v, fast=fast))
    return out


def _tail_outputs(t, b, d, e):
    from tpu_reid_torch.ops import fused_tail as FT

    x, proj, hb = t(b, d), t(d, e, std=d ** -0.5), t(e, std=0.02, dtype=torch.float32)
    g, gb = t(d, std=0.1, mean=1.0, dtype=torch.float32), t(d, std=0.1, dtype=torch.float32)
    return FT.ln_proj_tail_kernel(x, g, gb, proj, hb, EPS)


def existing_outputs(dev):
    """The outputs of the attention kernels at heads of 64 (whole rows
    exact, fast and masked; key tiles), of `ln_rows` (with the splice; over a
    padded width) and of the bf16 tail (ViT-B/16's and EVA02-L's widths, with
    the head's bias) on fixed inputs, as {name: digest}. Calls only what
    the parent commit has."""
    out = {}
    t = _draw(9, dev)
    with torch.no_grad():
        for s, h in ((213, 12), (77, 8), (444, 12)):
            q, k, v = (t(8, s, h, 64) for _ in range(3))
            mask = torch.full((s, s), float("-inf"), device=dev).triu(1) if s == 77 else None
            for fast in (False, True):
                out[f"mha_core.dh64.s{s}.fast{int(fast)}"] = _digest(
                    A.mha_core(q, k, v, mask, fast=fast))
        for k, n_real in ((1024, 1024), (2752, 2730)):
            x = t(8, 327, k)
            g, gb = t(k, std=0.1, mean=1.0, dtype=torch.float32), t(k, std=0.1,
                                                                    dtype=torch.float32)
            plane, pmask = t(327, k), torch.zeros(327, 1, device=dev)
            pmask[325:] = 1.0
            out[f"ln_rows.k{k}"] = _digest(FA.ln_rows(x, g, gb, n_real, EPS, plane, pmask))
        for b, d, e in ((512, 768, 512), (256, 1024, 768)):
            out[f"ln_proj_tail.d{d}"] = _digest(*_tail_outputs(t, b, d, e))
    return out


# new_mode_outputs on this commit's kernels (NVIDIA H100 80GB HBM3, torch 2.11 +
# CUDA 12.8)
NEW_DIGESTS = {
    "ln_gemm.gelu_erf.bf16": "9840fb857b6c526e",
    "ln_residual.bf16": "eee9c7108438bcc2",
    "mha_core.dh112.s77.fast0": "218b2fbdf7a9b8f5",
    "mha_core.dh112.s77.fast1": "ee85459b68ac79a5",
    "mha_core.dh112.s165.fast0": "1950034b70bf3e13",
    "mha_core.dh112.s165.fast1": "60ce7d8ddf3dc37c",
    "mha_core.dh112.s256.fast0": "b6f03c213bf651e9",
    "mha_core.dh112.s256.fast1": "d8a152d2245e594a",
    "ln_proj_tail.d1792": "60c34c642e768b4e",
    "mha_core.dh112.s259.fast0": "57353a951c3eb422",
    "mha_core.dh112.s259.fast1": "1617617a6671d8ea",
    "mha_core.dh112.s444.fast0": "7c8b8569d9d354f1",
    "mha_core.dh112.s444.fast1": "b78d816a7d17c928",
}

# existing_outputs on the parent commit's kernels (NVIDIA H100 80GB HBM3, torch
# 2.11 + CUDA 12.8)
PARENT_DIGESTS = {
    "mha_core.dh64.s213.fast0": "6cb7e91d92ac57c6",
    "mha_core.dh64.s213.fast1": "ea8a44a44a042895",
    "mha_core.dh64.s77.fast0": "0733d5527d267e2b",
    "mha_core.dh64.s77.fast1": "6c5dd2f7b6ffa180",
    "mha_core.dh64.s444.fast0": "3b1f1f7cec5f249d",
    "mha_core.dh64.s444.fast1": "6454c25367435329",
    "ln_rows.k1024": "96de7583d3c393a2",
    "ln_rows.k2752": "32d20d17d947e8b2",
    "ln_proj_tail.d768": "5b5bfa18654f21b4",
    "ln_proj_tail.d1024": "aa1304d6e9e281af",
}


def test_new_modes_keep_their_digests(cuda):
    assert NEW_DIGESTS, "no digests recorded"
    assert new_mode_outputs(cuda) == NEW_DIGESTS


def test_existing_outputs_bit_equal_to_the_parent(cuda):
    assert PARENT_DIGESTS, "no parent digests recorded"
    assert existing_outputs(cuda) == PARENT_DIGESTS


def test_eval_embed_runs_every_full_block_on_the_kernels(cuda):
    from tpu_reid_torch.configs import PromptDesign, eva02_e14_reid
    from tpu_reid_torch.models import prompts as P
    from tpu_reid_torch.models import reid_clip as M
    from tpu_reid_torch.ops import fused_eva_e as FEE
    from tpu_reid_torch.ops import fused_tail as FT
    from tpu_reid_torch.ops._build import kernel_impl
    from tpu_reid_torch.weights.convert import eva_e_params

    design = PromptDesign(trainer="IVLP", vision_depth=64, vision_ctx=2, language_depth=64,
                          language_ctx=2)
    clip = eva02_e14_reid((256, 128), design)
    v = clip.vision
    mcfg = M.ReidModelConfig(mode="ivlp", clip=clip,
                             prompt=P.PromptLearnerConfig(751, n_prefix=5, n_cls_ctx=4))
    gen = torch.Generator(device=cuda).manual_seed(10)
    n, d, f = v.layers, v.width, v.hidden

    def t(*shape, std=1.0, mean=0.0, dtype=torch.bfloat16):
        return (mean + std * torch.randn(*shape, generator=gen, device=cuda)).to(dtype)

    def ln(*lead, mean=1.0):
        return {"scale": t(*lead, std=0.01, mean=mean, dtype=torch.float32),
                "bias": t(*lead, std=0.02, dtype=torch.float32)}

    nat = {"conv": {"w": t(14, 14, 3, d, std=(3 * 196) ** -0.5), "b": t(d, std=0.02)},
           "class_embedding": t(d, std=d ** -0.5),
           "positional_embedding": t(1 + v.h_grid * v.w_grid, d, std=0.02),
           "blocks": {"norm1": ln(n, d, mean=0.1), "norm2": ln(n, d, mean=0.1),
                      "attn": {"qkv": {"w": t(n, d, 3 * d, std=d ** -0.5)},
                               "q_bias": t(n, d, std=0.02), "v_bias": t(n, d, std=0.02),
                               "proj": {"w": t(n, d, d, std=d ** -0.5), "b": t(n, d, std=0.02)}},
                      "mlp": {"fc1": {"w": t(n, d, f, std=d ** -0.5), "b": t(n, f, std=0.02)},
                              "fc2": {"w": t(n, f, d, std=f ** -0.5), "b": t(n, d, std=0.02)}}},
           "norm": ln(d), "head": {"w": t(d, 1024, std=d ** -0.5), "b": t(1024, std=0.02)},
           "vpt_shallow": t(2, d, std=0.02), "vpt_deep": t(n, 2, d, std=0.02)}
    params = {"clip": {"visual": eva_e_params(nat)}}
    del nat
    images = t(4, 256, 128, 3)
    with torch.no_grad():
        k0, p0 = FEE.fused_eva_e_block.launches, FEE.fused_eva_e_block.plain
        w0, t0 = A.mha_core_wide.launches, FT.ln_proj_tail_kernel.launches
        got = M.eval_embed(params, mcfg, images)
        assert (FEE.fused_eva_e_block.launches - k0, FEE.fused_eva_e_block.plain - p0) == (63, 0)
        assert (A.mha_core_wide.launches - w0, FT.ln_proj_tail_kernel.launches - t0) == (63, 1)
        with kernel_impl("plain"):
            want = M.eval_embed(params, mcfg, images)
    assert got.shape == (4, 1792 + 1024)
    gap = (got.float() - want.float()).norm(dim=1) / want.float().norm(dim=1)
    assert float(gap.max()) < 3e-2, gap
